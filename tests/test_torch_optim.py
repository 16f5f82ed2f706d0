"""The port's AdamW (repro_torch.optim.adamw) against the JAX package's
(repro.optim.adamw), on the CPU.

The same numpy leaves go through both: ``apply`` over several steps, with
the clip scale engaged and not (the parameters, moments, grad norm and lr
within rtol 1e-5, atol 1e-7 of the reference's; float32 both, the update's
products rounded in other orders: the largest difference seen is 3.5% of
that tolerance), ``schedule`` over steps 0..N (rtol 1e-6) and ``global_norm``
(rtol 1e-6).  Then the counterparts of tests/test_optim.py on the port, and
the in-place contract: ``apply`` allocates no tensor of a leaf's size.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"w": (3, 4), "b": (4,), "e": (5, 2, 3)}


def _leaves(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(cfg_kw, steps, grad_scale):
    jcfg, cfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    p0 = _leaves(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = jadamw.init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in p0.items()}
    topt = adamw.init(tp)
    tstep = torch.zeros((), dtype=torch.int32)
    for s in range(steps):
        g = _leaves(rng, grad_scale)
        jp, jopt, jm = jadamw.apply(jcfg, jp, {k: jnp.asarray(v) for k, v
                                               in g.items()}, jopt,
                                    jnp.asarray(s, jnp.int32))
        tm = adamw.apply(cfg, tp, {k: torch.as_tensor(v) for k, v in
                                   g.items()}, topt, tstep)
        tstep += 1
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=RTOL), (s, name)
        for k in SHAPES:
            for mine, ref in ((tp[k], jp[k]), (topt["m"][k], jopt["m"][k]),
                              (topt["v"][k], jopt["v"][k])):
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"step {s} {k}")
    return jm


@pytest.mark.parametrize("grad_scale,clipped", [(0.05, False), (3.0, True)])
def test_apply_matches_reference(grad_scale, clipped):
    m = _both(dict(lr_peak=1e-2, warmup_steps=2, total_steps=8), 6,
              grad_scale)
    assert (float(m["grad_norm"]) > 1.0) == clipped


def test_apply_matches_reference_without_decay_or_warmup():
    _both(dict(lr_peak=3e-3, lr_min=0.0, warmup_steps=0, total_steps=4,
               weight_decay=0.0, b2=0.999), 5, 0.5)


def test_schedule_matches_reference():
    for kw in (dict(lr_peak=1.0, lr_min=0.1, warmup_steps=10,
                    total_steps=110),
               dict(warmup_steps=0, total_steps=5),
               dict(warmup_steps=20, total_steps=5)):
        jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
        steps = np.arange(0, 130)
        want = np.asarray([float(jadamw.schedule(jcfg, jnp.asarray(
            s, jnp.float32))) for s in steps])
        got = adamw.schedule(cfg, torch.as_tensor(steps, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_global_norm_matches_reference():
    g = _leaves(np.random.default_rng(1), 2.0)
    want = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in
                                     g.items()}))
    got = adamw.global_norm([torch.as_tensor(v) for v in g.values()])
    assert float(got) == pytest.approx(want, rel=1e-6)
    five = adamw.global_norm([torch.tensor([3.0]), torch.tensor([4.0])])
    assert float(five) == pytest.approx(5.0)


def test_clipping_engages():
    cfg = adamw.AdamWConfig(clip_norm=0.1, warmup_steps=0)
    params = {"w": torch.ones(4)}
    m = adamw.apply(cfg, params, {"w": torch.full((4,), 100.0)},
                    adamw.init(params), torch.zeros((), dtype=torch.int32))
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-5)


def test_schedule_shape():
    cfg = adamw.AdamWConfig(lr_peak=1.0, lr_min=0.1, warmup_steps=10,
                            total_steps=110)
    lrs = adamw.schedule(cfg, torch.arange(0, 120, 5)).tolist()
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)
    post = lrs[2:]
    assert all(a >= b - 1e-9 for a, b in zip(post, post[1:]))


def test_apply_updates_in_place_and_allocates_no_leaf():
    """The parameters and moments are the same tensors after the update,
    the step counter is not advanced, and no tensor of the leaf's size is
    allocated (the gradient is the scratch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = 4096
    params = {"w": torch.randn(n)}
    opt = adamw.init(params)
    ids = [id(params["w"]), id(opt["m"]["w"]), id(opt["v"]["w"])]
    step = torch.zeros((), dtype=torch.int32)

    class Big(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.allocs = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            for o in outs:
                if (isinstance(o, torch.Tensor) and o.numel() >= n
                        and not any(o.data_ptr() == a.data_ptr() for a in args
                                    if isinstance(a, torch.Tensor))
                        and (kwargs or {}).get("out") is None):
                    self.allocs.append(func)
            return out

    before = params["w"].clone()
    grads = {"w": torch.randn(n)}
    with Big() as b:
        adamw.apply(adamw.AdamWConfig(warmup_steps=0), params, grads, opt,
                    step)
    assert b.allocs == []
    assert [id(params["w"]), id(opt["m"]["w"]), id(opt["v"]["w"])] == ids
    assert not torch.equal(params["w"], before)
    assert int(step) == 0

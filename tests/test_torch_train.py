"""The port's training forward and backward (repro_torch.models under
autograd, train.train_step's loss) against the JAX package's
``jax.value_and_grad``, on the CPU at the reduced same-family configs.

Weights are the reference's ``Model.init(PRNGKey(0))``, carried across by
``models.convert.params_from_reference``; token ids and stub embeddings
come from numpy seeds.  float32 throughout: ``Model.apply`` +
``cross_entropy`` + aux, the loss within rtol 1e-6 and every gradient leaf
within 2e-5 of that leaf's largest reference gradient (the two packages
sum the same products in other orders; the largest difference seen is
5.9e-6 of the leaf's scale, jamba's ``A_log``).

mamba2-780m and jamba-1.5-large-398b are held at ``dt_bias`` = -4.  At the
default init (``dt_bias`` = 0) the reference's gradients are nan: its SSD
takes ``where(tri, exp(seg), 0)`` with ``seg`` above the diagonal past
exp's float32 range, and the ``where`` sends 0 * inf = nan back through
the exponential.  The port masks before the exponential; that divergence
is pinned here (the reference nan, the port finite and its forward
bitwise the unmasked form's).

Then on the port alone: ``remat`` "nothing" / "dots" / "full" and the
attention's per-chunk checkpoint give bitwise the same loss and
gradients; the padded vocabulary columns pass no gradient; the serve
steps record no graph and copy no weight.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint.checkpointer import _flatten as jflatten
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import Model, cast_floats
from repro_torch.train import serve_step
from repro_torch.train import train_step as ts

B, S = 2, 32
LOSS_RTOL = 1e-6
GRAD_TOL = 2e-5          # of the leaf's largest reference gradient
SSM_ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    jcfg = jreduced(jconfigs.get(arch))
    jp = jax.jit(lambda k: JModel(jcfg).init(k)[0])(jax.random.PRNGKey(0))
    return jcfg, {k: np.asarray(v) for k, v in jflatten(jp).items()}


@functools.lru_cache(maxsize=None)
def _reference_grad(arch):
    """The reference's jitted float32 value_and_grad of apply +
    cross_entropy + aux, taking the flat param dict."""
    jcfg, flat = _reference_init(arch)
    treedef = jax.tree_util.tree_structure(
        jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0))[0]))
    keys = list(flat)

    def loss(leaves, batch, labels):
        p = jax.tree_util.tree_unflatten(treedef, leaves)
        logits, aux = JModel(jcfg).apply(p, batch)
        return jts.cross_entropy(logits, labels) + aux

    vg = jax.jit(jax.value_and_grad(loss))

    def run(flat_in, batch, labels):
        v, g = vg([jnp.asarray(flat_in[k]) for k in keys], batch, labels)
        return float(v), {k: np.asarray(x) for k, x in zip(keys, g)}

    return run


def _batch(cfg, seed):
    """(reference batch, port batch, labels)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    if cfg.modality == "text":
        jb = {"tokens": jnp.asarray(toks[:, :-1])}
        tb = {"tokens": torch.as_tensor(toks[:, :-1]).long()}
    else:
        e = (rng.normal(size=(B, S, cfg.d_model)) * 0.02).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": torch.as_tensor(e)}
    return jb, tb, toks[:, 1:]


def _port_grad(cfg, flat, tb, labels):
    params = params_from_reference(flat, cfg)
    logits, aux = Model(cfg).apply(transformer.unbound(params), tb)
    tot = ts.cross_entropy(logits, torch.as_tensor(labels)) + aux
    tot.backward()
    # an unused leaf (the audio / vlm archs' table) gets none: jax.grad's 0
    return float(tot.detach()), {
        n.replace(".", "/"): (p.grad if p.grad is not None
                              else torch.zeros_like(p)).detach().numpy()
        for n, p in params.named_parameters()}


def _with_dt_bias(flat, value):
    return {k: (np.full_like(v, value) if k.endswith("dt_bias") else v)
            for k, v in flat.items()}


def _held(arch, flat, seed):
    cfg = reduced(configs.get(arch))
    jb, tb, labels = _batch(cfg, seed)
    jv, jg = _reference_grad(arch)(flat, jb, jnp.asarray(labels))
    tv, tg = _port_grad(cfg, flat, tb, labels)
    assert tv == pytest.approx(jv, rel=LOSS_RTOL)
    assert tg.keys() == jg.keys()
    for k in jg:
        assert np.isfinite(jg[k]).all(), k
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=0,
                                   atol=GRAD_TOL * scale + 1e-30,
                                   err_msg=f"{arch}: {k}")


@pytest.mark.parametrize("arch", [a for a in configs.ARCHS
                                  if a not in SSM_ARCHS])
def test_loss_and_grads_match_reference(arch):
    _held(arch, _reference_init(arch)[1], 1)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_loss_and_grads_match_reference_at_dt_bias(arch):
    """dt_bias = -4 keeps every exp(seg) of the reference in range."""
    _held(arch, _with_dt_bias(_reference_init(arch)[1], -4.0), 1)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_grads_finite_where_the_reference_is_nan(arch):
    """Known divergence (ROADMAP.md queue 3): at the default init the
    reference's gradients hold nan, the port's are finite, and the loss
    agrees."""
    cfg = reduced(configs.get(arch))
    flat = _reference_init(arch)[1]
    jb, tb, labels = _batch(cfg, 1)
    jv, jg = _reference_grad(arch)(flat, jb, jnp.asarray(labels))
    assert any(not np.isfinite(g).all() for g in jg.values())
    tv, tg = _port_grad(cfg, flat, tb, labels)
    assert all(np.isfinite(g).all() for g in tg.values())
    assert tv == pytest.approx(jv, rel=LOSS_RTOL)
    state = ts.state_from_reference(
        {**{f"params/{k}": v for k, v in flat.items()},
         **{f"opt/{m}/{k}": np.zeros_like(v) for m in "mv"
            for k, v in flat.items()}, "step": np.zeros((), np.int32)},
        cfg)
    tb["labels"] = torch.as_tensor(labels).long()
    state, m = ts.make_train_step(cfg)(state, tb)
    assert np.isfinite(float(m["grad_norm"]))
    assert all(bool(torch.isfinite(p).all())
               for p in state["params"].parameters())


def test_masked_exponential():
    """The two forms of the SSD's decay matrix on segment sums past exp's
    float32 range above the diagonal: the same values bitwise, and only
    the masked one has a finite gradient."""
    rng = np.random.default_rng(2)
    Q = 12
    a = torch.as_tensor(-rng.uniform(8, 16, Q), dtype=torch.float32)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    forms = {
        "where after exp": lambda seg: torch.where(tri, torch.exp(seg), 0.0),
        "masked": lambda seg: torch.exp(torch.where(tri, seg,
                                                    float("-inf"))),
    }
    out, grad = {}, {}
    for name, form in forms.items():
        x = a.clone().requires_grad_(True)
        acs = torch.cumsum(x, 0)
        seg = acs[:, None] - acs[None, :]
        assert float(seg.detach().max()) > 88.8   # exp overflows above tri
        out[name] = form(seg)
        out[name].sum().backward()
        grad[name] = x.grad
    assert torch.equal(out["masked"], out["where after exp"])
    assert bool(torch.isnan(grad["where after exp"]).any())
    assert bool(torch.isfinite(grad["masked"]).all())


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(jts.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = ts.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    got16 = ts.cross_entropy(torch.as_tensor(logits).bfloat16(),
                             torch.as_tensor(labels))
    want16 = float(jts.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                     jnp.asarray(labels)))
    assert float(got16) == pytest.approx(want16, rel=1e-6)


def _loss_and_grads(cfg, params, batch, q_chunk=512):
    for p in params.parameters():
        p.grad = None
    tot, _ = ts.make_loss_fn(cfg, q_chunk=q_chunk)(params, batch)
    tot.backward()
    return float(tot.detach()), {n: p.grad.clone() for n, p in
                                 params.named_parameters()}


@pytest.mark.parametrize("arch", ["gemma2-2b", "jamba-1.5-large-398b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("q_chunk", [512, 8])
def test_remat_policies_give_the_same_loss_and_grads(arch, q_chunk):
    """Rematerialization recomputes the same ops: bitwise the same
    bfloat16 loss and float32 gradients under every policy, with one query
    chunk and with four (each chunk checkpointed inside the repeat's
    checkpoint)."""
    base = reduced(configs.get(arch))
    params = Model(base).init(0, "cpu")
    _, tb, labels = _batch(base, 4)
    tb["labels"] = torch.as_tensor(labels).long()
    runs = {r: _loss_and_grads(dataclasses.replace(base, remat=r), params,
                               tb, q_chunk)
            for r in ("nothing", "dots", "full")}
    loss0, g0 = runs["nothing"]
    for r, (loss, g) in runs.items():
        assert loss == loss0, r
        for n in g0:
            assert torch.equal(g[n], g0[n]), (r, n)


def test_remat_rejects_an_unknown_policy():
    cfg = dataclasses.replace(reduced(configs.get("llama3.2-3b")),
                              remat="some")
    params = Model(cfg).init(0, "cpu")
    with pytest.raises(ValueError, match="remat must be"):
        Model(cfg).apply(params, {"tokens": torch.zeros((1, 4),
                                                      dtype=torch.long)})


def test_dots_policy_saves_the_weight_products():
    """Under "dots" the backward recomputes the batched products (the
    attention scores) and not the weight products."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = self.bmm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default and args[0].shape[0] > 1:
                self.bmm += 1
            elif func in (torch.ops.aten.mm.default,
                          torch.ops.aten.bmm.default):
                self.mm += 1
            return func(*args, **(kwargs or {}))

    base = reduced(configs.get("llama3.2-3b"))
    params = Model(base).init(0, "cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "labels": torch.zeros((2, 8), dtype=torch.long)}
    counts = {}
    for r in ("nothing", "dots", "full"):
        loss_fn = ts.make_loss_fn(dataclasses.replace(base, remat=r))
        tot, _ = loss_fn(params, batch)
        with Count() as c:
            tot.backward()
        counts[r] = (c.mm, c.bmm)
    # forward products run again in the backward pass: "dots" reruns the
    # batched ones only, "full" both kinds
    assert counts["dots"][0] == counts["nothing"][0]
    assert counts["dots"][1] > counts["nothing"][1]
    assert counts["full"][0] > counts["nothing"][0]


def test_padded_vocab_columns_pass_no_gradient():
    """The forward fills the padding columns of the logits in place; under
    autograd they pass no gradient back, as the reference's ``where``,
    so the padding rows of the tied table get none."""
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b")),
                              vocab_size=250)
    assert cfg.padded_vocab == 256
    params = Model(cfg).init(0, "cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, 250, (2, 8)))
    logits, _ = Model(cfg).apply(transformer.unbound(params), {"tokens": toks})
    logits.sum().backward()
    # the tied table's padding rows are read only as the head's columns
    assert bool((params.embed.embedding.grad[250:] == 0).all())
    assert bool((params.embed.embedding.grad[:250] != 0).any())


def test_serve_steps_record_no_graph_and_copy_no_weight():
    """Trainable weights do not make serving record a graph: the logits of
    prefill and decode take no gradient, no parameter gets a ``.grad``,
    the serving cast's parameters take none, and a step given bfloat16
    parameters casts none of them again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = reduced(configs.get("llama3.2-3b"))
    m = Model(cfg)
    params = m.init(0, "cpu")
    assert all(p.requires_grad for p in params.parameters())
    bf = cast_floats(params, torch.bfloat16)
    assert not any(p.requires_grad for p in bf.parameters())
    weights = {p.data_ptr() for p in bf.parameters()}

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default:      # a cast
                src = [a for a in args if isinstance(a, torch.Tensor)]
                if any(a.data_ptr() in weights for a in src[-1:]):
                    self.seen.append(func)
            return func(*args, **(kwargs or {}))

    pre = serve_step.make_prefill_step(cfg)
    dec = serve_step.make_decode_step(cfg)
    caches = m.init_caches(2, 12, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 8)))
    with Copies() as c:
        logits, caches = pre(bf, {"tokens": toks}, caches)
        assert not logits.requires_grad
        for i in range(2):
            logits, caches = dec(bf, toks[:, :1], caches, 8 + i)
            assert not logits.requires_grad
    assert c.seen == []
    logits, _ = pre(params, {"tokens": toks}, m.init_caches(2, 12,
                                                            device="cpu"))
    assert not logits.requires_grad
    assert all(p.grad is None for p in params.parameters())

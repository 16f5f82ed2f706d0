"""The port's train step, driver and training checkpoints
(repro_torch.train.train_step, launch.train) against the JAX package's
(repro.train.train_step, launch.train, checkpoint), on the CPU.

One bfloat16 ``make_train_step`` step from the reference's initial state
(carried across by ``state_from_reference``) against the reference's
jitted step on the same SyntheticTokens batch: the loss within rtol 1e-3
(bfloat16 rounds each op's output to 8 bits; the largest difference seen
is 5.1e-5 relative), the grad norm within rtol 1e-2 (seen: 1.0e-3), and
every parameter within 4 lr (lr = 1e-3).  One AdamW step moves a weight
by about lr whatever its gradient's size, so where the two packages'
bfloat16 gradients differ in sign the weights part by up to 2 lr (the
largest difference seen is 2.0e-3, as in tests/test_train.py:53-58).
mamba2 is held at ``dt_bias`` = -4, where the reference's gradients are
finite (tests/test_torch_train.py).

A reference train state saved by ``repro.checkpoint`` at step 4 restores
into the port (``load_state``) bitwise and both continue two steps with
the tolerances above (the largest parameter difference seen is 1.0e-4:
with five steps of moments behind it an update is no longer about lr
times a sign).  A port-saved float32 train state restores in the
reference (``restore_latest`` with a ``jax.eval_shape`` template)
bitwise.

One case runs four microbatches of one row in each package (llama): the
same tolerances; the grad norm is where the gradient sums and their
division show (seen: 3.3e-4 relative).

Then the counterparts of tests/test_train.py on the port alone: the loss
decreases, four microbatches against one (loss rtol 1e-5, parameters
within 4 lr; seen: the loss bitwise, the parameters 2.0e-3 apart, 2 lr
where a sign flips; the grad norm within rtol 1e-3, seen 1.4e-4; and the
float32 gradients of a float32 loss leaf by leaf within 1e-5 of the
leaf's largest, seen 5.3e-7: a step that kept one microbatch's gradient
or left out the division is off by 0.6-3 of it), restart from a
checkpoint bitwise, the launcher's smoke with a restart; and ``--mesh``:
every value the reference's launcher accepts names the reference's mesh,
and ``--mesh 2x2`` trains (tests/test_torch_train_sharded.py holds the
sharded training to the reference).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

LR = 1e-3
LOSS_RTOL = 1e-3
STEP_ATOL = 4 * LR
GRAD_NORM_RTOL = 1e-3
GRAD_TOL = 1e-5

TINY = ModelConfig(
    "tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab_size=128, head_dim=8, remat="nothing", vocab_pad_multiple=8,
)


def _opt_kw(**kw):
    return dict(dict(lr_peak=LR, warmup_steps=0, total_steps=10), **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch, dt_bias=None, microbatches=1):
    """The reduced config, the reference's jitted train step over
    ``microbatches`` and its initial state (``init_state(PRNGKey(0))``;
    ``dt_bias`` replaced in the params when given)."""
    jcfg = jreduced(jconfigs.get(arch))
    state, _ = jts.init_state(jcfg, jax.random.PRNGKey(0))
    if dt_bias is not None:
        blocks = [dict(b, mixer=dict(b["mixer"], dt_bias=jnp.full_like(
            b["mixer"]["dt_bias"], dt_bias))) if "dt_bias" in b["mixer"]
            else b for b in state["params"]["blocks"]]
        state = dict(state, params=dict(state["params"], blocks=blocks))
    step = jax.jit(jts.make_train_step(jcfg, jadamw.AdamWConfig(**_opt_kw()),
                                       microbatches=microbatches))
    return jcfg, step, state


def _flat(tree):
    return {k: np.asarray(v) for k, v in jck._flatten(tree).items()}


def _batches(cfg, step, batch=4, seq=32):
    ref = JSyntheticTokens(cfg.vocab_size, seq, batch, seed=0)
    mine = SyntheticTokens(cfg.vocab_size, seq, batch, seed=0, device="cpu")
    return ref.batch_at(step), mine.batch_at(step)


def _params_close(state, jparams, atol):
    ref = _flat(jparams)
    for n, p in state["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref[n.replace(".", "/")], rtol=0,
                                   atol=atol, err_msg=n)


@pytest.mark.parametrize("arch,dt_bias,microbatches", [
    pytest.param("llama3.2-3b", None, 1, id="llama3.2-3b-None"),
    pytest.param("gemma2-2b", None, 1, id="gemma2-2b-None"),
    pytest.param("granite-moe-1b-a400m", None, 1,
                 id="granite-moe-1b-a400m-None"),
    pytest.param("mamba2-780m", -4.0, 1, id="mamba2-780m--4.0"),
    pytest.param("llama3.2-3b", None, 4, id="llama3.2-3b-None-micro4")])
def test_bf16_step_matches_reference(arch, dt_bias, microbatches):
    jcfg, jstep, jstate = _reference(arch, dt_bias, microbatches)
    cfg = reduced(configs.get(arch))
    state = ts.state_from_reference(_flat(jstate), cfg)
    jb, tb = _batches(cfg, 0)
    jstate, jm = jstep(jstate, jb)
    state, m = ts.make_train_step(cfg, adamw.AdamWConfig(**_opt_kw()),
                                  microbatches=microbatches)(state, tb)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-2)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 1
    _params_close(state, jstate["params"], STEP_ATOL)


def test_train_state_carries_across_both_ways():
    _, _, jstate = _reference("llama3.2-3b")
    cfg = reduced(configs.get("llama3.2-3b"))
    flat = _flat(jstate)
    state = ts.state_from_reference(flat, cfg)
    back = ts.state_to_reference(state)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert back["step"].dtype == np.int32
    with pytest.raises(ValueError, match="missing.*opt/v/embed/embedding"):
        ts.state_from_reference(
            {k: v for k, v in flat.items() if k != "opt/v/embed/embedding"},
            cfg)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains steps 0-4 and saves at step 4; the port
    restores that checkpoint into a state of its own init and both run
    steps 5 and 6."""
    _, jstep, jstate = _reference("llama3.2-3b")
    cfg = reduced(configs.get("llama3.2-3b"))
    for s in range(5):
        jstate, _ = jstep(jstate, _batches(cfg, s)[0])
    path = jck.save(str(tmp_path), 4, jstate)
    state = ts.init_state(cfg, 7, "cpu")
    ts.load_state(state, path)
    assert int(state["step"]) == 5
    _params_close(state, jstate["params"], 0.0)
    step = ts.make_train_step(cfg, adamw.AdamWConfig(**_opt_kw()))
    for s in (5, 6):
        jb, tb = _batches(cfg, s)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
    _params_close(state, jstate["params"], STEP_ATOL)
    for mom in ("m", "v"):
        ref = _flat(jstate["opt"][mom])
        for k, t in state["opt"][mom].items():
            assert np.isfinite(t.numpy()).all()
            assert t.shape == ref[k.replace(".", "/")].shape


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg = jreduced(jconfigs.get("llama3.2-3b"))
    cfg = reduced(configs.get("llama3.2-3b"))
    state = ts.init_state(cfg, 3, "cpu")
    state, _ = ts.make_train_step(cfg)(state, _batches(cfg, 0)[1])
    checkpointer.save(str(tmp_path), 0, state)
    template = jax.eval_shape(
        lambda: jts.init_state(jcfg, jax.random.PRNGKey(0))[0])
    restored, at = jck.restore_latest(str(tmp_path), template)
    assert at == 0
    mine = ts.state_to_reference(state)
    got = _flat(restored)
    assert got.keys() == mine.keys()
    for k in mine:
        assert got[k].dtype == mine[k].dtype, k
        np.testing.assert_array_equal(got[k], mine[k], err_msg=k)
    assert int(got["step"]) == 1


def test_load_state_checks_the_leaves(tmp_path):
    cfg = reduced(configs.get("llama3.2-3b"))
    state = ts.init_state(cfg, 0, "cpu")
    small = ts.init_state(dataclasses.replace(cfg, d_ff=64), 0, "cpu")
    path = checkpointer.save(str(tmp_path), 0, small)
    with pytest.raises(ValueError, match="the state.s torch.float32"):
        ts.load_state(state, path)
    path = checkpointer.save(str(tmp_path), 1, state["params"])
    with pytest.raises(KeyError, match="opt/m"):
        ts.load_state(state, path)


def _data(batch=4, seq=32, vocab=128, seed=0):
    return SyntheticTokens(vocab, seq, batch, seed=seed, device="cpu")


def test_loss_decreases():
    step = ts.make_train_step(TINY, adamw.AdamWConfig(
        lr_peak=3e-3, warmup_steps=5, total_steps=40))
    state = ts.init_state(TINY, 0, "cpu")
    data = _data()
    losses = []
    for i in range(40):
        state, m = step(state, data.batch_at(i % 4))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5


def _float32_loss_fn(cfg):
    """``make_loss_fn``'s loss on the float32 parameters themselves."""
    model = Model(cfg)

    def loss_fn(params, batch):
        logits, aux = model.apply(transformer.unbound(params),
                                  {"tokens": batch["tokens"]})
        loss = ts.cross_entropy(logits, batch["labels"])
        return loss + aux, (loss, aux)

    return loss_fn


def test_grad_accumulation_matches_big_batch():
    opt = adamw.AdamWConfig(**_opt_kw())
    batch = _data(batch=8).batch_at(0)
    s1, m1 = ts.make_train_step(TINY, opt, microbatches=1)(
        ts.init_state(TINY, 1, "cpu"), batch)
    s4, m4 = ts.make_train_step(TINY, opt, microbatches=4)(
        ts.init_state(TINY, 1, "cpu"), batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
    assert float(m4["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=GRAD_NORM_RTOL)
    for a, b in zip(s1["params"].parameters(), s4["params"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=STEP_ATOL)
    # the gradients themselves, leaf by leaf, on a float32 loss
    params = ts.init_state(TINY, 1, "cpu")["params"]
    grads = {}
    for mb in (1, 4):
        ts.backward(_float32_loss_fn(TINY), params, batch, mb)
        grads[mb] = {n: p.grad.clone() for n, p in params.named_parameters()}
    for n, g in grads[1].items():
        err = float((grads[4][n] - g).abs().max())
        assert err <= GRAD_TOL * float(g.abs().max()), n
    with pytest.raises(ValueError, match="microbatches"):
        ts.make_train_step(TINY, opt, microbatches=3)(
            ts.init_state(TINY, 1, "cpu"), batch)


def test_checkpoint_restart_exact(tmp_path):
    """Stop at step 5, restore, continue to 10: identical to
    uninterrupted."""
    step = ts.make_train_step(TINY, adamw.AdamWConfig(
        lr_peak=1e-3, warmup_steps=2, total_steps=10))
    data = _data()
    ref = ts.init_state(TINY, 2, "cpu")
    for i in range(10):
        ref, _ = step(ref, data.batch_at(i))
    run = ts.init_state(TINY, 2, "cpu")
    for i in range(5):
        run, _ = step(run, data.batch_at(i))
    checkpointer.save(str(tmp_path), 4, run)
    restored = ts.init_state(TINY, 99, "cpu")
    ts.load_state(restored, str(tmp_path / "step_00000004"))
    for i in range(5, 10):
        restored, _ = step(restored, data.batch_at(i))
    for a, b in zip(ref["params"].parameters(),
                    restored["params"].parameters()):
        assert torch.equal(a, b)
    assert int(restored["step"]) == 10


def test_train_cli_smoke(tmp_path, capsys):
    """The launcher end to end, checkpoint written, then a restart that
    continues from it."""
    ckpt = str(tmp_path / "ck")
    common = ["--arch", "llama3.2-3b", "--smoke", "--batch", "4", "--seq",
              "32", "--ckpt-dir", ckpt, "--ckpt-every", "3", "--log-every",
              "5", "--device", "cpu"]
    first = train_cli.main(["--steps", "6"] + common)
    assert [r["step"] for r in first] == list(range(6))
    assert checkpointer.available_steps(ckpt) == [3, 5]
    second = train_cli.main(["--steps", "8"] + common)
    assert [r["step"] for r in second] == [6, 7]
    assert "restored step 5" in capsys.readouterr().out
    assert checkpointer.available_steps(ckpt) == [5, 6, 7]
    assert all(np.isfinite(r["loss"]) for r in first + second)


def test_train_cli_embeds_stub(tmp_path):
    """An audio arch trains on the frontend stub's embeddings."""
    records = train_cli.main(["--arch", "musicgen-medium", "--smoke",
                              "--steps", "2", "--batch", "2", "--seq", "8",
                              "--device", "cpu"])
    assert len(records) == 2 and all(np.isfinite(r["loss"])
                                     for r in records)


def test_train_cli_trains_on_a_mesh(capfd):
    """Every ``--mesh`` the reference's launcher builds names the same
    mesh here (no value is refused); ``--mesh 2x2`` trains on a local
    world of 4 ranks."""
    from repro.launch import train as jtrain_cli

    for spec in ("1", "4", "8", "2x2", "4x2", "2x2x2", "1x1"):
        mine = train_cli.build_mesh(spec)
        ref = jtrain_cli.build_mesh(spec)
        assert dict(zip(mine.axes, mine.shape)) == dict(ref.shape), spec
    assert train_cli.build_mesh("production") == ((16, 16),
                                                  ("data", "model"))
    assert train_cli.build_mesh("production-multipod") == (
        (2, 16, 16), ("pod", "data", "model"))
    records = train_cli.main(["--arch", "llama3.2-3b", "--smoke", "--mesh",
                              "2x2", "--steps", "2", "--batch", "4",
                              "--seq", "16", "--device", "cpu"])
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert "mesh={'data': 2, 'model': 2}" in capfd.readouterr().out

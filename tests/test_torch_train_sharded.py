"""The port's training sharded over a mesh (repro_torch.train.train_step
with ``mesh=``, data.pipeline with ``mesh=``, the sharded checkpoints,
launch.train ``--mesh``) against the JAX package's (its ``NamedSharding``
placement, its ``jax.jit`` step on a mesh) and against the port's own
single-device step, on the CPU in gloo worlds of spawned ranks
(``testing.world``; the rank jobs are ``testing.training``).

- Blocks: a reduced state made by the reference, carried across by
  ``state_from_reference`` and sharded by the port: in each rank every
  block is bitwise the reference's ``addressable_shards`` block of the
  device at the same row-major mesh position (fsdp on (4, 2), zero3 on
  (2, 2, 2); llama, gemma2, granite-moe, mamba2).  A dimension that does
  not divide its mesh dimensions raises in both packages.
- Rows: each rank's SyntheticTokens rows bitwise the reference's
  addressable shard.
- The step on (2, 2) against the reference's jitted step on its (2, 2)
  mesh with the tiny config of tests/test_train.py: the loss within rtol
  1e-3, the grad norm within rtol 1e-2, every parameter within 4 lr (the
  tolerances of tests/test_torch_train_step.py, for the same reasons:
  bfloat16 ops round apart, and one AdamW step moves a weight by about lr
  whatever its gradient).
- Against the port's single-device step in 2 microbatches (each data
  rank's rows are one microbatch's): with a float32 loss the gathered
  gradients within 1e-5 of each leaf's largest; with the bfloat16 loss
  the loss within rtol 1e-6 and the gradients within 2^-8 of a leaf's
  largest (seen: bitwise, the same ops on the same rows), the grad norm
  within rtol 1e-5.  A norm that counted a replicated block once a rank
  would be off by up to sqrt(2) here.
- Compute replicated along 'model': on a (1, 4) mesh every rank runs the
  whole batch and nothing sums over 'model', so the loss and gradients
  are bitwise the single-device step's in one microbatch.
- A sharded save writes the files of a single-device save of the same
  state, byte for byte; the driver trains on ``--mesh 2x2`` and a
  restart continues from its checkpoint.
"""
import dataclasses
import filecmp
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch import mesh as jmeshlib
from repro.optim import adamw as jadamw
from repro.runtime import elastic as jelastic
from repro.sharding import partition as jpartition
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.checkpoint import checkpointer
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.testing.world import World, WorldError
from repro_torch.train import train_step as ts

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 host devices")

JOBS = "repro_torch.testing.training"
LR = 1e-3
LOSS_RTOL = 1e-3
STEP_ATOL = 4 * LR
GRAD_TOL = 1e-5
BF16_GRAD_TOL = 2.0 ** -8
MESHES = {"4x2": MeshSpec((4, 2), ("data", "model")),
          "2x2x2": MeshSpec((2, 2, 2), ("pod", "data", "model")),
          "2x2": MeshSpec((2, 2), ("data", "model")),
          "1x4": MeshSpec((1, 4), ("data", "model"))}
# the tiny config of tests/test_train.py:22
TINY_KW = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
               vocab_size=128, head_dim=8, remat="nothing",
               sharding_profile="dp", vocab_pad_multiple=8)


@pytest.fixture(scope="module")
def world8():
    with World(8) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4) as w:
        yield w


def _opt(**kw):
    return dict(dict(lr_peak=LR, warmup_steps=0, total_steps=10), **kw)


def _jmesh(spec):
    return jmeshlib.make_test_mesh(spec.shape, spec.axes)


def _flat(tree):
    return {k: np.asarray(v) for k, v in jck._flatten(tree).items()}


def _ref_state(jcfg, seed=0):
    """The reference's initial train state and its spec tree, made as its
    launcher makes them (``jax.jit`` of ``init_state``; the profile does
    not change them)."""
    return _ref_init(dataclasses.replace(jcfg, sharding_profile="dp"), seed)


@functools.lru_cache(maxsize=None)
def _ref_init(jcfg, seed):
    cap = {}

    def build(k):
        state, specs = jts.init_state(jcfg, k)
        cap["specs"] = specs
        return state

    state = jax.jit(build)(jax.random.PRNGKey(seed))
    return state, cap["specs"]


def _blocks_by_position(tree, mesh):
    """{row-major mesh position: {key: the block of that device}} of a
    tree of sharded jax arrays."""
    devices = list(mesh.devices.flat)
    out = {r: {} for r in range(len(devices))}
    for key, leaf in jck._flatten(tree).items():
        for shard in leaf.addressable_shards:
            out[devices.index(shard.device)][key] = np.asarray(shard.data)
    return out


def _cfgs(arch, profile):
    return (dataclasses.replace(reduced(configs.get(arch)),
                                sharding_profile=profile),
            dataclasses.replace(jreduced(jconfigs.get(arch)),
                                sharding_profile=profile))


# ---- blocks -------------------------------------------------------------
@pytest.mark.parametrize("mesh,profile", [("4x2", "fsdp"),
                                          ("2x2x2", "zero3")])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma2-2b",
                                  "granite-moe-1b-a400m", "mamba2-780m"])
def test_blocks_per_device_match_reference(world8, arch, mesh, profile):
    cfg, jcfg = _cfgs(arch, profile)
    jstate, specs = _ref_state(jcfg)
    jm = _jmesh(MESHES[mesh])
    sh = jelastic.state_shardings(jcfg, jm, jax.eval_shape(lambda: jstate),
                                  specs)
    ref = _blocks_by_position(jax.device_put(jstate, sh), jm)
    outs = world8.run(f"{JOBS}:shard_blocks", cfg, MESHES[mesh],
                      _flat(jstate))
    split = 0
    for r, blocks in enumerate(outs):
        assert blocks.keys() == ref[r].keys()
        for k, b in blocks.items():
            assert b.dtype == ref[r][k].dtype, k
            np.testing.assert_array_equal(b, ref[r][k], err_msg=f"{r} {k}")
        split += sum(b.size for b in blocks.values())
    # ZeRO: the moments and masters are split, not replicated
    total = sum(v.size for v in _flat(jstate).values())
    assert split < 8 * total / 2


def test_a_dimension_that_does_not_divide_raises(world8):
    """d_model = 36 over 'data' = 8: JAX's device_put raises, and so does
    the port's sharding of the state (in every rank)."""
    kw = dict(TINY_KW, d_model=36, head_dim=9, sharding_profile="fsdp")
    jcfg, cfg = JModelConfig("odd", **kw), ModelConfig("odd", **kw)
    jstate, specs = _ref_state(jcfg)
    jm = _jmesh(MeshSpec((8,), ("data",)))
    sh = jelastic.state_shardings(jcfg, jm, jax.eval_shape(lambda: jstate),
                                  specs)
    with pytest.raises(ValueError, match="divisible by 8"):
        jax.device_put(jstate, sh)
    with pytest.raises(WorldError, match="divisible by 8"):
        world8.run(f"{JOBS}:shard_blocks", cfg,
                   MeshSpec((8,), ("data",)), _flat(jstate))


# ---- rows ---------------------------------------------------------------
@pytest.mark.parametrize("mesh,batch", [("4x2", 8), ("2x2x2", 8),
                                        ("2x2x2", 2), ("4x2", 6)])
def test_synthetic_rows_match_reference_shards(world8, mesh, batch):
    cfg = reduced(configs.get("llama3.2-3b"))
    jm = _jmesh(MESHES[mesh])
    ref = JSyntheticTokens(cfg.vocab_size, 16, batch, seed=3, mesh=jm,
                           batch_spec=jpartition.batch_pspec(jm, batch)
                           ).batch_at(5)
    want = _blocks_by_position(ref, jm)
    outs = world8.run(f"{JOBS}:batch_rows", cfg, MESHES[mesh], batch=batch,
                      seq=16, step=5, seed=3)
    for r, rows in enumerate(outs):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(rows[k], want[r][k])


# ---- the step against the reference's ---------------------------------------
@pytest.mark.parametrize("profile", ["dp", "fsdp"])
def test_sharded_step_matches_reference_sharded_step(world4, profile):
    kw = dict(TINY_KW, sharding_profile=profile)
    jcfg, cfg = JModelConfig("tiny", **kw), ModelConfig("tiny", **kw)
    jstate, specs = _ref_state(jcfg, 3)
    flat = _flat(jstate)
    jm = _jmesh(MESHES["2x2"])
    sh = jelastic.state_shardings(jcfg, jm, jax.eval_shape(lambda: jstate),
                                  specs)
    batch = JSyntheticTokens(cfg.vocab_size, 32, 8, seed=0).batch_at(0)
    with jm:
        bsh = NamedSharding(jm, JP(*jpartition.batch_pspec(jm, 8), None))
        sb = {k: jax.device_put(v, bsh) for k, v in batch.items()}
        step = jax.jit(jts.make_train_step(jcfg,
                                           jadamw.AdamWConfig(**_opt())))
        jnew, jm_ = step(jax.device_put(jstate, sh), sb)
    outs = world4.run(f"{JOBS}:train", cfg, MESHES["2x2"], flat=flat,
                      steps=1, batch=8, seq=32, opt=_opt())
    for o in outs:
        assert o["metrics"] == outs[0]["metrics"]   # global, every rank
    m = outs[0]["metrics"][0]
    assert m["loss"] == pytest.approx(float(jm_["loss"]), rel=LOSS_RTOL)
    assert m["grad_norm"] == pytest.approx(float(jm_["grad_norm"]),
                                           rel=1e-2)
    ref = _flat(jnew)
    got = outs[0]["state"]
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                       atol=STEP_ATOL, err_msg=k)
    assert int(got["step"]) == 1


# ---- against the port's single-device step ---------------------------------
def _single_grads(cfg, flat, batch, microbatches, float32):
    state = ts.state_from_reference(flat, cfg)
    if float32:
        model = Model(cfg)

        def loss_fn(params, b):
            logits, aux = model.apply(transformer.unbound(params),
                                      {"tokens": b["tokens"]})
            loss = ts.cross_entropy(logits, b["labels"])
            return loss + aux, (loss, aux)
    else:
        loss_fn = ts.make_loss_fn(cfg)
    loss, _ = ts.backward(loss_fn, state["params"], batch, microbatches)
    return float(loss), {n.replace(".", "/"): p.grad.numpy() for n, p in
                         state["params"].named_parameters()}


def _grads_close(got, want, tol):
    worst = 0.0
    for k, g in want.items():
        err = float(np.abs(got[k] - g).max())
        scale = float(np.abs(g).max())
        assert err <= tol * scale, (k, err, scale)
        worst = max(worst, err / scale if scale else err)
    return worst


@pytest.mark.parametrize("arch,profile", [("llama3.2-3b", "fsdp"),
                                          ("gemma2-2b", "dp"),
                                          ("granite-moe-1b-a400m", "fsdp")])
def test_sharded_gradients_match_two_microbatches(world4, arch, profile):
    cfg, jcfg = _cfgs(arch, profile)
    flat = _flat(_ref_state(jcfg)[0])
    batch = SyntheticTokens(cfg.vocab_size, 32, 8, seed=0,
                            device="cpu").batch_at(0)
    # float32 loss
    _, want = _single_grads(cfg, flat, batch, 2, True)
    outs = world4.run(f"{JOBS}:gradients", cfg, MESHES["2x2"], flat=flat,
                      batch=8, seq=32, float32=True)
    for o in outs:
        _grads_close(o["grads"], want, GRAD_TOL)
    # the bfloat16 training loss
    loss, want = _single_grads(cfg, flat, batch, 2, False)
    outs = world4.run(f"{JOBS}:gradients", cfg, MESHES["2x2"], flat=flat,
                      batch=8, seq=32)
    for o in outs:
        assert o["loss"] == pytest.approx(loss, rel=1e-6)
        _grads_close(o["grads"], want, BF16_GRAD_TOL)


def test_sharded_step_matches_two_microbatches(world4):
    """One step: the loss, the grad norm (each block counted once), and
    the weights against the single-device step in 2 microbatches."""
    cfg, jcfg = _cfgs("llama3.2-3b", "fsdp")
    flat = _flat(_ref_state(jcfg)[0])
    batch = SyntheticTokens(cfg.vocab_size, 32, 8, seed=0,
                            device="cpu").batch_at(0)
    state, m = ts.make_train_step(cfg, adamw.AdamWConfig(**_opt()),
                                  microbatches=2)(
        ts.state_from_reference(flat, cfg), batch)
    outs = world4.run(f"{JOBS}:train", cfg, MESHES["2x2"], flat=flat,
                      steps=1, batch=8, seq=32, opt=_opt())
    got = outs[0]["metrics"][0]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-6)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                             rel=1e-5)
    want = ts.state_to_reference(state)
    for k in want:
        np.testing.assert_allclose(outs[0]["state"][k], want[k], rtol=0,
                                   atol=STEP_ATOL, err_msg=k)


def test_compute_is_replicated_along_model(world4):
    """(1, 4) over (data, model): every rank runs the whole batch, nothing
    sums over 'model': the loss and the gradients are bitwise the
    single-device step's in one microbatch."""
    cfg, jcfg = _cfgs("llama3.2-3b", "dp")
    flat = _flat(_ref_state(jcfg)[0])
    batch = SyntheticTokens(cfg.vocab_size, 32, 8, seed=0,
                            device="cpu").batch_at(0)
    loss, want = _single_grads(cfg, flat, batch, 1, False)
    outs = world4.run(f"{JOBS}:gradients", cfg, MESHES["1x4"], flat=flat,
                      batch=8, seq=32)
    for o in outs:
        assert o["loss"] == loss
        for k, g in want.items():
            np.testing.assert_array_equal(o["grads"][k], g, err_msg=k)


def test_loss_decreases_sharded(world4):
    kw = dict(TINY_KW, sharding_profile="fsdp")
    cfg = ModelConfig("tiny", **kw)
    outs = world4.run(f"{JOBS}:train", cfg, MESHES["2x2"], steps=6,
                      batch=8, seq=32, repeat=True, gather=False,
                      opt=_opt(lr_peak=3e-3))
    losses = [m["loss"] for m in outs[0]["metrics"]]
    assert all(np.isfinite(losses))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


# ---- checkpoints and the driver ---------------------------------------------
def test_sharded_save_writes_the_single_device_files(world4, tmp_path):
    cfg, jcfg = _cfgs("gemma2-2b", "fsdp")
    flat = _flat(_ref_state(jcfg)[0])
    outs = world4.run(f"{JOBS}:train", cfg, MESHES["2x2"], flat=flat,
                      steps=1, batch=8, seq=16, opt=_opt(),
                      ckpt_dir=str(tmp_path / "sharded"))
    state = ts.state_from_reference(outs[0]["state"], cfg)
    checkpointer.save(str(tmp_path / "single"), 0, state)
    a, b = tmp_path / "sharded" / "step_00000000", \
        tmp_path / "single" / "step_00000000"
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


def test_train_cli_mesh_with_restart(tmp_path, capfd):
    ckpt = str(tmp_path / "ck")
    common = ["--arch", "llama3.2-3b", "--smoke", "--mesh", "2x2",
              "--batch", "4", "--seq", "32", "--ckpt-dir", ckpt,
              "--ckpt-every", "3", "--log-every", "5", "--device", "cpu"]
    first = train_cli.main(["--steps", "6"] + common)
    assert [r["step"] for r in first] == list(range(6))
    assert checkpointer.available_steps(ckpt) == [3, 5]
    second = train_cli.main(["--steps", "8"] + common)
    assert [r["step"] for r in second] == [6, 7]
    out = capfd.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out
    assert "restored step 5" in out
    assert checkpointer.available_steps(ckpt) == [5, 6, 7]
    assert all(np.isfinite(r["loss"]) for r in first + second)
    # the same run on one device: the same losses within the bfloat16
    # reduction's rounding (each rank's rows are a microbatch)
    single = train_cli.main(["--arch", "llama3.2-3b", "--smoke", "--batch",
                             "4", "--seq", "32", "--steps", "6",
                             "--microbatches", "2", "--device", "cpu"])
    for a, b in zip(first, single):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)

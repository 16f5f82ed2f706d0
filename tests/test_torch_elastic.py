"""The port's elastic restart (repro_torch.runtime.elastic, the sharded
checkpoints) against the JAX package's (repro.runtime.elastic,
repro.checkpoint), on the CPU in gloo worlds of spawned ranks
(``testing.world``; the rank jobs are ``testing.training``).

- ``choose_mesh``: the reference's mesh shape for n = 1..8 devices and
  model targets 1, 2, 4 and 16.
- Resume after a shrink (tests/test_elastic.py): train 3 steps on a world
  of 8 on ``choose_mesh(8, target_model=2)`` = (4, 2), save, and resume
  on a world of 4 on (2, 2): every restored block bitwise the saved
  state's block at the rank's mesh position (the reference's
  ``addressable_shards`` of the saved leaves placed on its own (2, 2)
  mesh), then a finite step.
- Across the packages: the port's sharded checkpoint restores bitwise in
  the reference's ``elastic.resume`` on its (2, 2) mesh, and a
  checkpoint the reference saved from its sharded state restores bitwise
  in the port's ranks on (2, 2) and (2, 2, 2).
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import reduced as jreduced
from repro.launch import mesh as jmeshlib
from repro.runtime import elastic as jelastic
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.launch.mesh import MeshSpec
from repro_torch.runtime import elastic
from repro_torch.testing.world import World

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 host devices")

JOBS = "repro_torch.testing.training"
OPT = dict(lr_peak=1e-3, warmup_steps=0, total_steps=10)
ARCH, PROFILE = "llama3.2-3b", "fsdp"


@pytest.fixture(scope="module")
def world8():
    with World(8) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4) as w:
        yield w


def _cfgs():
    return (dataclasses.replace(reduced(configs.get(ARCH)),
                                sharding_profile=PROFILE),
            dataclasses.replace(jreduced(jconfigs.get(ARCH)),
                                sharding_profile=PROFILE))


def _flat(tree):
    return {k: np.asarray(v) for k, v in jck._flatten(tree).items()}


@functools.lru_cache(maxsize=None)
def _abstract(jcfg):
    cap = {}

    def build(k):
        state, specs = jts.init_state(jcfg, k)
        cap["specs"] = specs
        return state

    return build, jax.eval_shape(build, jax.random.PRNGKey(0)), cap["specs"]


def _on_mesh(jcfg, flat_state, jm):
    """The reference's addressable blocks of a global state placed on its
    mesh ``jm`` by its own shardings: {mesh position: {key: block}}."""
    _, abstract, specs = _abstract(jcfg)
    sh = jck._flatten(jelastic.state_shardings(jcfg, jm, abstract, specs))
    devices = list(jm.devices.flat)
    out = {r: {} for r in range(len(devices))}
    for key, arr in flat_state.items():
        for shard in jax.device_put(arr, sh[key]).addressable_shards:
            out[devices.index(shard.device)][key] = np.asarray(shard.data)
    return out


def _assert_blocks(outs, want):
    for r, o in enumerate(outs):
        assert o["blocks"].keys() == want[r].keys()
        for k, b in o["blocks"].items():
            np.testing.assert_array_equal(b, want[r][k], err_msg=f"{r} {k}")


@pytest.mark.parametrize("target", [1, 2, 4, 16])
@pytest.mark.parametrize("n", range(1, 9))
def test_choose_mesh_matches_reference(n, target):
    mine = elastic.choose_mesh(n, target_model=target)
    ref = jelastic.choose_mesh(n, target_model=target)
    assert isinstance(mine, MeshSpec)
    assert dict(zip(mine.axes, mine.shape)) == dict(ref.shape)
    assert mine.axes == tuple(ref.axis_names)


def test_choose_mesh_shapes():
    """tests/test_elastic.py's cases."""
    assert elastic.choose_mesh(8, target_model=4) == ((2, 4),
                                                      ("data", "model"))
    assert elastic.choose_mesh(6, target_model=4).shape == (1, 4)
    assert elastic.choose_mesh(3, target_model=16).shape == (1, 2)
    assert elastic.choose_mesh(1).shape == (1, 1)


@pytest.fixture(scope="module")
def trained8(world8, tmp_path_factory):
    """3 steps on (4, 2) from the reference's initial state, saved at
    step 2 by the port's sharded save."""
    cfg, jcfg = _cfgs()
    build, _, _ = _abstract(jcfg)
    flat = _flat(jax.jit(build)(jax.random.PRNGKey(0)))
    ckpt = str(tmp_path_factory.mktemp("elastic8"))
    mesh8 = elastic.choose_mesh(8, target_model=2)
    assert mesh8.shape == (4, 2)
    outs = world8.run(f"{JOBS}:train", cfg, mesh8, flat=flat, steps=3,
                      batch=8, seq=32, opt=OPT, ckpt_dir=ckpt)
    return ckpt, outs[0]["state"], outs[0]["metrics"]


def test_resume_after_shrink(world4, trained8):
    """Lose half the ranks: resume on (2, 2), every block bitwise, and one
    more step, finite; the step's metrics the same on every rank."""
    ckpt, saved, metrics = trained8
    cfg, jcfg = _cfgs()
    assert all(np.isfinite(m["loss"]) for m in metrics)
    mesh4 = elastic.choose_mesh(4, target_model=2)
    outs = world4.run(f"{JOBS}:train", cfg, mesh4, ckpt_dir=ckpt,
                      resume=True, first=3, steps=1, batch=8, seq=32,
                      opt=OPT, gather=False)
    assert [o["restored"] for o in outs] == [2] * 4
    _assert_blocks(outs, _on_mesh(jcfg, saved, jmeshlib.make_test_mesh(
        mesh4.shape, mesh4.axes)))
    m = outs[0]["metrics"][0]
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert all(o["metrics"] == outs[0]["metrics"] for o in outs)


def test_port_checkpoint_resumes_in_the_reference(trained8):
    ckpt, saved, _ = trained8
    _, jcfg = _cfgs()
    _, abstract, specs = _abstract(jcfg)
    jm = jmeshlib.make_test_mesh((2, 2), ("data", "model"))
    with jm:
        restored, at, mesh = jelastic.resume(jcfg, ckpt, abstract, specs,
                                             mesh=jm)
    assert at == 2 and mesh is jm
    got = _flat(restored)
    assert got.keys() == saved.keys()
    for k in saved:
        assert got[k].dtype == saved[k].dtype, k
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    leaf = restored["params"]["embed"]["embedding"]
    assert leaf.sharding.mesh.shape == jm.shape


@pytest.mark.parametrize("mesh", [MeshSpec((2, 2), ("data", "model")),
                                  MeshSpec((2, 2, 2),
                                           ("pod", "data", "model"))],
                         ids=["2x2", "2x2x2"])
def test_reference_checkpoint_resumes_in_the_port(world4, world8, tmp_path,
                                                  mesh):
    """The reference trains 2 steps on its (4, 2) mesh and saves; each
    port rank restores its blocks bitwise, then steps on."""
    cfg, jcfg = _cfgs()
    build, abstract, specs = _abstract(jcfg)
    jm8 = jmeshlib.make_test_mesh((4, 2), ("data", "model"))
    with jm8:
        sh = jelastic.state_shardings(jcfg, jm8, abstract, specs)
        state = jax.jit(build, out_shardings=sh)(jax.random.PRNGKey(1))
        step = jax.jit(jts.make_train_step(jcfg))
        from repro.data.pipeline import SyntheticTokens
        data = SyntheticTokens(jcfg.vocab_size, 32, 8, seed=0)
        for i in range(2):
            state, _ = step(state, data.batch_at(i))
        jck.save(str(tmp_path), 1, state)
    world = world8 if len(mesh.shape) == 3 else world4
    outs = world.run(f"{JOBS}:train", cfg, mesh, ckpt_dir=str(tmp_path),
                     resume=True, first=2, steps=1, batch=8, seq=32,
                     opt=OPT, gather=False)
    assert [o["restored"] for o in outs] == [1] * len(outs)
    _assert_blocks(outs, _on_mesh(jcfg, _flat(state),
                                  jmeshlib.make_test_mesh(mesh.shape,
                                                          mesh.axes)))
    assert np.isfinite(outs[0]["metrics"][0]["loss"])

"""The port's checkpointer (repro_torch.checkpoint.checkpointer) against the
JAX package's (repro.checkpoint.checkpointer): one on-disk layout, so each
package restores the other's checkpoints.

The counterparts of tests/test_checkpoint.py on the port (round trip,
incomplete ``.tmp`` and manifest-less steps ignored, an empty directory,
``prune``, overwriting a step, ``AsyncCheckpointer``, the manifest), then
the two packages against each other: a reference checkpoint of a reduced
model's params restored by the port (bitwise, bfloat16 leaves included) and
loaded into the port's model; the port's checkpoint restored by the
reference; the files of a bfloat16 leaf byte for byte the reference's.

The reference's ``restore`` cannot read a bfloat16 leaf, its own included:
NumPy loads the ``'<V2'`` words as a void array, which is no JAX type
(``TypeError``).  So the port's bfloat16 files are held byte for byte to
the reference's instead, and the reference restores the other leaves.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import reduced as jreduced
from repro.models.model import Model as JModel
from repro_torch import configs
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.configs.base import reduced
from repro_torch.models.model import Model, cast_floats


def _tree():
    return {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones(4, dtype=torch.int32),
                   "c": [torch.zeros(()), torch.ones(())]},
    }


def _leaves(t):
    return list(ck._flatten(t).values())


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    path = ck.save(str(tmp_path), 3, t)
    assert path.endswith("step_00000003")
    r = ck.restore(path, t, device="cpu")
    for a, b in zip(_leaves(t), _leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(r["nested"]["c"], list)


def test_restore_latest_ignores_incomplete(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    ck.save(str(tmp_path), 2, t)
    # a crash mid-save leaves a .tmp dir, a partial rename a dir without
    # manifest: both are ignored
    os.makedirs(tmp_path / "step_00000005.tmp")
    os.makedirs(tmp_path / "step_00000004")
    _, step = ck.restore_latest(str(tmp_path), t, device="cpu")
    assert step == 2
    assert ck.available_steps(str(tmp_path)) == [1, 2]


def test_restore_empty_dir(tmp_path):
    r, step = ck.restore_latest(str(tmp_path), _tree(), device="cpu")
    assert r is None and step == -1
    assert ck.available_steps(str(tmp_path / "absent")) == []


def test_prune_keeps_latest(tmp_path):
    t = _tree()
    for s in range(6):
        ck.save(str(tmp_path), s, t)
    ck.prune(str(tmp_path), keep=2)
    assert ck.available_steps(str(tmp_path)) == [4, 5]


def test_save_overwrites_same_step(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    t2 = {"a": t["a"] + 1, "nested": t["nested"]}
    ck.save(str(tmp_path), 1, t2)
    r = ck.restore(os.path.join(str(tmp_path), "step_00000001"), t,
                   device="cpu")
    assert torch.equal(r["a"], t2["a"])


def test_async_checkpointer(tmp_path):
    t = _tree()
    ac = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(4):
        ac.save(s, {"a": t["a"] + s, "nested": t["nested"]})
    ac.wait()
    assert ck.available_steps(str(tmp_path)) == [2, 3]
    r = ck.restore(os.path.join(str(tmp_path), "step_00000003"), t,
                   device="cpu")
    assert torch.equal(r["a"], t["a"] + 3)


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """A leaf changed in place after ``save`` returns is saved as it was."""
    t = {"w": torch.zeros(3)}
    ac = ck.AsyncCheckpointer(str(tmp_path))
    ac.save(0, t)
    t["w"].add_(5.0)
    ac.wait()
    r = ck.restore(os.path.join(str(tmp_path), "step_00000000"), t,
                   device="cpu")
    assert torch.equal(r["w"], torch.zeros(3))


def test_manifest_contents(tmp_path):
    path = ck.save(str(tmp_path), 0, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 0
    assert man["leaves"]["a"] == {"file": "a.npy", "shape": [2, 3],
                                  "dtype": "float32"}
    assert man["leaves"]["nested/c/1"]["file"] == "nested__c__1.npy"
    assert ck.read_manifest(path) == man


def test_restore_checks_shapes(tmp_path):
    path = ck.save(str(tmp_path), 0, {"a": torch.ones(3)})
    man = ck.read_manifest(path)
    man["leaves"]["a"]["shape"] = [4]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(path, {"a": None}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``device=`` the leaves go to the card: with no GPU,
    ``restore``, ``restore_latest`` and ``read_leaf`` raise rather than
    carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = {"a": torch.ones(3)}
    path = ck.save(str(tmp_path), 0, t)
    for call in (lambda: ck.restore(path, t),
                 lambda: ck.restore_latest(str(tmp_path), t),
                 lambda: ck.read_leaf(path, "a")):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert torch.equal(ck.read_leaf(path, "a", device="cpu"), t["a"])


def _reference_params(arch="gemma2-2b"):
    jcfg = jreduced(jconfigs.get(arch))
    jp = jax.jit(lambda k: JModel(jcfg).init(k)[0])(jax.random.PRNGKey(0))
    return jcfg, jp


def test_port_restores_the_references_checkpoint(tmp_path):
    """The reference saves a reduced model's params (float32) and a
    bfloat16 copy; the port restores both into its model's state_dict,
    bitwise, and the model runs."""
    jcfg, jp = _reference_params()
    jck.save(str(tmp_path / "f32"), 7, jp)
    jck.save(str(tmp_path / "bf16"), 7, jax.tree.map(
        lambda x: x.astype(jnp.bfloat16), jp))
    cfg = reduced(configs.get("gemma2-2b"))
    model = Model(cfg)
    template = model.init(0, "cpu")
    for sub, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        sd, step = ck.restore_latest(str(tmp_path / sub),
                                     template.state_dict(), device="cpu")
        assert step == 7
        flat = jck._flatten(jp)
        for k, v in sd.items():
            ref = np.asarray(flat[k.replace(".", "/")])
            assert v.dtype == dtype and tuple(v.shape) == ref.shape, k
            want = (ref if dtype == torch.float32
                    else ref.astype(ml_dtypes.bfloat16).view(np.int16))
            got = v.numpy() if dtype == torch.float32 else \
                v.view(torch.int16).numpy()
            np.testing.assert_array_equal(got, want, err_msg=k)
        template.load_state_dict({k: v.float() for k, v in sd.items()})
        logits, _ = model.apply(template, {"tokens": torch.zeros(
            (1, 4), dtype=torch.long)})
        assert bool(torch.isfinite(logits).all())


def test_reference_restores_the_ports_checkpoint(tmp_path):
    """The port saves its model (a state_dict's dotted names become the
    reference's keys); the reference restores it into its own param tree,
    bitwise."""
    cfg = reduced(configs.get("jamba-1.5-large-398b"))
    params = Model(cfg).init(1, "cpu")
    ck.save(str(tmp_path), 2, params)
    jcfg = jreduced(jconfigs.get("jamba-1.5-large-398b"))
    template = jax.eval_shape(
        lambda: JModel(jcfg).init(jax.random.PRNGKey(0))[0])
    restored, step = jck.restore_latest(str(tmp_path), template)
    assert step == 2
    sd = params.state_dict()
    for k, v in jck._flatten(restored).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      sd[k.replace("/", ".")].numpy())


def test_bf16_leaves_are_the_references_files(tmp_path):
    """bfloat16 leaves: the port's file and manifest entry are byte for
    byte the reference's, the port reads either back, and the reference's
    ``restore`` reads the other leaves of the port's checkpoint."""
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(x).astype(jnp.bfloat16), "s": jnp.asarray(x)}
    ttree = {"w": torch.as_tensor(x).to(torch.bfloat16),
             "s": torch.as_tensor(x)}
    jpath = jck.save(str(tmp_path / "j"), 1, jtree)
    tpath = ck.save(str(tmp_path / "t"), 1, ttree)
    for f in ("w.npy", "s.npy", "manifest.json"):
        with open(os.path.join(jpath, f), "rb") as a, \
                open(os.path.join(tpath, f), "rb") as b:
            assert a.read() == b.read(), f
    for path in (jpath, tpath):
        r = ck.restore(path, ttree, device="cpu")
        assert r["w"].dtype == torch.bfloat16
        assert torch.equal(r["w"].view(torch.int16),
                           ttree["w"].view(torch.int16))
        assert torch.equal(r["s"], ttree["s"])
    s_only = jck.restore(tpath, {"s": jax.ShapeDtypeStruct((3, 5),
                                                           jnp.float32)})
    np.testing.assert_array_equal(np.asarray(s_only["s"]), x)
    with pytest.raises(TypeError):
        jck.restore(jpath, {"w": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16)})


def test_bf16_model_roundtrip(tmp_path):
    """A model cast to bfloat16 saves and restores bitwise."""
    cfg = reduced(configs.get("llama3.2-3b"))
    params = cast_floats(Model(cfg).init(2, "cpu"), torch.bfloat16)
    ck.save(str(tmp_path), 0, params)
    sd, _ = ck.restore_latest(str(tmp_path), params.state_dict(),
                              device="cpu")
    for k, v in params.state_dict().items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k

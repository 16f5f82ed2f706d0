"""The port's layouts (repro_torch.sharding.partition,
models.transformer.logical_specs, train.serve_step.cache_shardings)
against the JAX package's (repro.sharding.partition, the spec trees of
repro.models, repro.train.serve_step), on the CPU without a world: the
port's functions read only a mesh's dimension names and sizes
(``MeshSpec``), the reference's run on meshes of the 8 host devices.

Every ``PartitionSpec`` is compared entry for entry with the reference's
(``tuple(P)``).  The counterparts of tests/test_sharding.py come first,
then the spec trees of all ten archs, the placement of every parameter
under dp, fsdp and zero3 on (4, 2) and (2, 2, 2), the cache layouts, and
the deliberate gap: the reference's GSPMD constraint hooks have no
counterpart (the port computes replicated along ``model``).
"""
import ast
import dataclasses
import functools
import itertools
from pathlib import Path

import pytest

import jax
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import reduced as jreduced
from repro.launch import mesh as jmeshlib
from repro.sharding import partition as jpartition
from repro.train import serve_step as jserve_step
from repro.train import train_step as jts
from repro_torch import configs
from repro_torch.configs.base import reduced
from repro_torch.core.distributed import P
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.sharding import partition
from repro_torch.train import serve_step
from repro_torch.train import train_step as ts

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 host devices")

MESH2D = MeshSpec((4, 2), ("data", "model"))
MESH3D = MeshSpec((2, 2, 2), ("pod", "data", "model"))
MESHES = {"4x2": MESH2D, "2x2x2": MESH3D,
          "2x2": MeshSpec((2, 2), ("data", "model")),
          "8": MeshSpec((8,), ("data",))}
PROFILES = ("dp", "fsdp", "zero3")
# the reference's GSPMD constraint hooks, left out of the port
GSPMD_HOOKS = {"ambient_mesh", "model_axis_size", "shard_dim", "seq_shard",
               "batch_shard"}


def _jmesh(spec: MeshSpec) -> Mesh:
    return jmeshlib.make_test_mesh(spec.shape, spec.axes)


def _same(mine, ref) -> bool:
    return isinstance(mine, P) and tuple(mine) == tuple(ref)


# ---- the counterparts of tests/test_sharding.py -------------------------
def test_tensor_axes_map_to_model():
    m = MESH2D
    assert partition.spec_to_pspec(("embed", "ff"), "fsdp", m) == \
        P("data", "model")
    assert partition.spec_to_pspec(("experts", "embed", None), "fsdp", m) \
        == P("model", "data", None)
    assert partition.spec_to_pspec(("vocab", "embed"), "dp", m) == \
        P("model", None)


def test_head_axes_divisibility():
    m = MESH2D
    assert partition.spec_to_pspec(("embed", "q_heads", None), "fsdp", m,
                                   shape=(32, 4, 8)) == \
        P("data", "model", None)
    assert partition.spec_to_pspec(("embed", "q_heads", None), "fsdp", m,
                                   shape=(32, 3, 8)) == P("data", None, None)
    assert partition.spec_to_pspec(("embed", "kv_heads", None), "fsdp", m,
                                   shape=(32, 1, 8)) == P("data", None, None)


def test_zero3_uses_all_data_axes():
    m = MESH3D
    assert partition.spec_to_pspec(("embed", "ff"), "zero3", m) == \
        P(("pod", "data"), "model")
    assert partition.spec_to_pspec(("embed", "ff"), "fsdp", m) == \
        P("data", "model")
    assert partition.spec_to_pspec(("embed", "ff"), "dp", m) == \
        P(None, "model")


def test_batch_pspec():
    assert partition.batch_pspec(MESH3D, 8) == P(("pod", "data"))
    assert partition.batch_pspec(MESH3D, 3) == P(None)
    assert partition.batch_pspec(MESH3D, 2) == P(("pod",))


def test_param_shardings_tree():
    """The reference's test on one attention block of reduced llama: the
    port's ``Attention`` names its parameters' logical axes alike."""
    cfg = reduced(configs.get("llama3.2-3b"))
    attn = L.Attention(cfg, 1, None, "meta")
    specs = {n: L.Attention.SPECS[n] for n, _ in attn.named_parameters()}
    shapes = {n: tuple(p.shape[1:]) for n, p in attn.named_parameters()}
    sh = partition.param_shardings(specs, "fsdp", MESH2D, shapes)
    assert sh["wq"] == P("data", "model", None)
    assert sh["wk"] == P("data", "model", None)
    assert sh["wo"] == P("model", None, "data")
    with pytest.raises(ValueError, match="other leaves"):
        partition.param_shardings(specs, "fsdp", MESH2D, {"wq": (1, 1, 1)})


def test_unknown_logical_axis_raises():
    with pytest.raises(ValueError, match="unknown logical axis"):
        partition.spec_to_pspec(("hidden",), "fsdp", MESH2D)


def test_cache_shardings_per_position():
    cfg = reduced(configs.get("gemma2-2b"))
    sh = serve_step.cache_shardings(cfg, MESH2D, batch=4, max_len=64)
    assert len(sh) == len(cfg.pattern)
    for layer_sh in sh:
        assert "k" in layer_sh and "v" in layer_sh


# ---- every rule against the reference's ------------------------------------
_AXES = (None, "layers", "embed", "embed_nosplit", "q_heads", "kv_heads",
         "heads", "ff", "experts", "vocab", "mamba_inner", "mamba_heads")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
def test_spec_to_pspec_matches_reference(mesh, profile):
    spec, jm = MESHES[mesh], _jmesh(MESHES[mesh])
    for a, b in itertools.product(_AXES, repeat=2):
        for shape in (None, (8, 3), (6, 4)):
            mine = partition.spec_to_pspec((a, b), profile, spec, shape)
            ref = jpartition.spec_to_pspec((a, b), profile, jm, shape)
            assert _same(mine, ref), (a, b, shape, mine, ref)
    assert partition.data_axes(spec) == jpartition.data_axes(jm)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_pspec_match_reference(mesh):
    spec, jm = MESHES[mesh], _jmesh(MESHES[mesh])
    for b in range(1, 17):
        assert _same(partition.batch_pspec(spec, b),
                     jpartition.batch_pspec(jm, b)), b
        for seq, kv in ((64, 2), (63, 3), (64, 1), (7, 4)):
            assert _same(partition.cache_pspec(spec, b, seq, kv),
                         jpartition.cache_pspec(jm, b, seq, kv))


@functools.lru_cache(maxsize=None)
def _ref_specs(jcfg) -> tuple:
    """The reference's logical spec tree of ``jcfg``'s params, flattened
    with its checkpointer's keys (through ``jax.eval_shape``)."""
    cap = {}

    def build(k):
        state, specs = jts.init_state(jcfg, k)
        cap["specs"] = specs
        return state

    abstract = jax.eval_shape(build, jax.random.PRNGKey(0))

    def is_spec(t):
        return isinstance(t, tuple) and all(
            a is None or isinstance(a, str) for a in t)

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            cap["specs"]["params"], is_leaf=is_spec)[0]:
        flat["/".join(jck._path_str(p) for p in path)] = leaf
    shapes = {k: tuple(v.shape) for k, v in
              jck._flatten(abstract["params"]).items()}
    return flat, shapes, cap["specs"]["params"], abstract["params"]


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_logical_specs_match_reference(arch):
    """``logical_specs(cfg)`` is the reference's spec tree, at full width
    and reduced."""
    for cfg, jcfg in ((configs.get(arch), jconfigs.get(arch)),
                      (reduced(configs.get(arch)),
                       jreduced(jconfigs.get(arch)))):
        ref, _, _, _ = _ref_specs(jcfg)
        mine = {k.replace(".", "/"): v
                for k, v in transformer.logical_specs(cfg).items()}
        assert mine == ref


@pytest.mark.parametrize("mesh", ["4x2", "2x2x2"])
@pytest.mark.parametrize("profile", PROFILES)
def test_param_layout_matches_reference_placement(mesh, profile):
    """Every parameter of every arch at full width: the port's layout
    (``train_step.param_layout``) is the ``.spec`` of the reference's
    ``param_shardings`` on the same mesh."""
    spec, jm = MESHES[mesh], _jmesh(MESHES[mesh])
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        jcfg = jconfigs.get(arch)
        _, _, jspecs, jshapes = _ref_specs(jcfg)
        ref = {k: v.spec for k, v in jck._flatten(jpartition.param_shardings(
            jspecs, profile, jm, jshapes)).items()}
        mine = ts.param_layout(dataclasses.replace(
            cfg, sharding_profile=profile), spec)
        assert {k.replace(".", "/") for k in mine} == set(ref)
        for k, v in mine.items():
            assert _same(v, ref[k.replace(".", "/")]), (arch, k, v)


@pytest.mark.parametrize("arch", ["gemma2-2b", "jamba-1.5-large-398b",
                                  "mamba2-780m"])
@pytest.mark.parametrize("mesh", ["4x2", "2x2x2", "8"])
def test_cache_shardings_match_reference(arch, mesh):
    spec, jm = MESHES[mesh], _jmesh(MESHES[mesh])
    cfg, jcfg = reduced(configs.get(arch)), jreduced(jconfigs.get(arch))
    for batch, max_len in ((4, 64), (3, 63), (8, 16)):
        if "model" not in spec.axes:   # both name "model": both raise
            with pytest.raises(ValueError, match="model"):
                jserve_step.cache_shardings(jcfg, jm, batch, max_len)
            with pytest.raises(ValueError, match="model"):
                serve_step.cache_shardings(cfg, spec, batch, max_len)
            continue
        mine = serve_step.cache_shardings(cfg, spec, batch, max_len)
        ref = jserve_step.cache_shardings(jcfg, jm, batch, max_len)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert _same(a[k], b[k].spec), (k, a[k], b[k].spec)


# ---- the deliberate gap ----------------------------------------------------
def _public_names(path) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_partition_public_names_and_the_gspmd_gap():
    """Every public name of the reference's partition module exists in the
    port's, except the five GSPMD constraint hooks, which do not: they
    steer the compiler's placement, and the port's compute along 'model'
    is replicated."""
    ref = _public_names(Path(jpartition.__file__))
    assert GSPMD_HOOKS <= ref
    missing = sorted(n for n in ref - GSPMD_HOOKS
                     if not hasattr(partition, n))
    assert not missing, missing
    assert not any(hasattr(partition, n) for n in GSPMD_HOOKS)
    assert partition.TENSOR_AXES == jpartition.TENSOR_AXES
    assert partition.HEAD_AXES == jpartition.HEAD_AXES


def test_sharding_profile_matches_reference():
    for arch in configs.ARCHS:
        assert configs.get(arch).sharding_profile == \
            jconfigs.get(arch).sharding_profile
        assert reduced(configs.get(arch)).sharding_profile == \
            jreduced(jconfigs.get(arch)).sharding_profile == "dp"

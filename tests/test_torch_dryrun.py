"""The port's dry run (repro_torch.launch.specs, cost_analysis, dryrun,
dryrun_pald's dense cells, tuning.hillclimb ``cell``) against the JAX
package's (repro.launch.specs, hlo_analysis, dryrun, dryrun_pald), on the
CPU: the reference's meshes are the 8 host devices of tests/conftest.py,
the port's ``MeshSpec``s and gloo worlds of spawned ranks
(``testing.world``; the rank jobs are ``testing.collectives``).

- Stand-ins: for every arch x (train, prefill, decode), reduced, on
  (2, 2, 2), each leaf's global shape, dtype and rank block equal the
  reference's ``ShapeDtypeStruct`` and its ``NamedSharding.shard_shape``
  (state, serving copy, caches, batch); each cell counts on meta to a
  finite flop count and positive bytes, status "ok".
- A full config (internvl2-1b at 256 x 8) counted on meta with nothing
  made off the meta device, as tests/test_dryrun_small.py lowers it.
- The arithmetic: ``model_flops`` is the reference's for every arch x
  shape; a reduced dense cell's counted matmul flops equal a closed form;
  the byte tracker's peak on a small program.
- The dry run's train program is the sharded step: its meta count's
  flops are every rank's in a world of 4.
- The recorder against the analytic counts, per rank and kind: a (2, 2)
  sharded train step, the dense PaLD bodies (allgather, ring, 2d, 2d
  with the pod stream), the sum of an (8, 32) float32 array (the
  reference's tests/test_hlo_analysis.py count: one all-reduce of 32·4
  operand bytes a rank).
- The dense PaLD cells' strip check of U and C against the plain
  versions, which a wrong kernel fails.
- The configs' ``train_microbatches``; a train cell whose layout does
  not divide the mesh skipped; the command lines with
  ``--device meta`` / ``cpu`` on reduced cells, their JSON keyed as the
  reference's.
"""
import contextlib
import dataclasses
import functools
import json
import math

import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.checkpoint import checkpointer as jck
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import reduced as jreduced
from repro.launch import hlo_analysis as jhlo
from repro.launch import mesh as jmeshlib
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, reduced
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, dryrun_pald, specs
from repro_torch.core.distributed import P
from repro_torch.launch.mesh import MeshSpec, production_spec
from repro_torch.testing.world import World
from repro_torch.train import train_step as ts
from repro_torch.tuning import hillclimb

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 host devices")

MESH3D = MeshSpec((2, 2, 2), ("pod", "data", "model"))
MESH2D = MeshSpec((2, 2), ("data", "model"))
KINDS = ("train", "prefill", "decode")
SMALL = {k: ShapeConfig(k[0], 64, 8, k) for k in KINDS}
JOBS = "repro_torch.testing.collectives"
# the keys a cell of the reference's dryrun.py / dryrun_pald.py shares
# with the port's (what benchmarks/roofline.py reads)
SHARED_LM_KEYS = {"status", "arch", "shape", "mesh", "chips", "microbatches",
                  "roofline", "memory_analysis", "useful_flop_ratio",
                  "model_flops_global", "model_flops_per_chip"}
SHARED_PALD_KEYS = {"status", "workload", "strategy", "dtype", "mesh",
                    "chips", "roofline", "memory_analysis",
                    "pald_ops_per_chip", "collectives"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "bottleneck",
                 "bound_s"}


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jmeshlib.make_test_mesh(MESH3D.shape, MESH3D.axes)


@functools.lru_cache(maxsize=None)
def _ref_model_specs(arch):
    jcfg = jreduced(jconfigs.get(arch))
    state, _ = jspecs.state_specs(jcfg, _jmesh())
    params, _ = jspecs.param_specs(jcfg, _jmesh())
    return jck._flatten(state), jck._flatten(params)


def _flat(tree, prefix="") -> dict:
    """{reference checkpointer key: leaf} of a port tree (dotted
    parameter names become "/" paths)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{str(k).replace('.', '/')}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _hold_leaves(leaves: dict, layout: dict, ref: dict, what: str):
    assert set(leaves) == set(ref), (what, sorted(set(leaves) ^ set(ref)))
    for k, t in leaves.items():
        sds = ref[k]
        assert tuple(t.shape) == tuple(sds.shape), (what, k)
        assert str(t.dtype).removeprefix("torch.") == str(sds.dtype), (what, k)
        assert t.device.type == "meta", (what, k)
        assert specs.block_shape(t.shape, MESH3D, layout[k]) == tuple(
            sds.sharding.shard_shape(sds.shape)), (what, k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_stand_ins_match_reference(arch, kind):
    cfg = reduced(configs.get(arch))
    jcfg = jreduced(jconfigs.get(arch))
    shape = SMALL[kind]
    jshape = JShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                          kind)
    jmesh = _jmesh()
    jstate, jparams = _ref_model_specs(arch)
    if kind == "train":
        state, layout = specs.state_specs(cfg, MESH3D)
        _hold_leaves(_flat(state), _flat(layout), jstate, "state")
    else:
        params, layout = specs.param_specs(cfg, MESH3D)
        _hold_leaves(_flat(params), _flat(layout), jparams, "params")
        caches, clay = specs.cache_specs(cfg, MESH3D, shape.global_batch,
                                         shape.seq_len)
        jcaches, _ = jspecs.cache_specs(jcfg, jmesh, shape.global_batch,
                                        shape.seq_len)
        _hold_leaves(_flat(caches), _flat(clay), jck._flatten(jcaches),
                     "caches")
    batch, blay = specs.batch_specs(cfg, shape, MESH3D)
    _hold_leaves(batch, blay, jspecs.batch_specs(jcfg, jshape, jmesh),
                 "batch")
    # 2 rows a rank: a train cell in one microbatch
    cell = dryrun.run_cell(arch, shape, False, mesh=MESH3D, q_chunk=32,
                           cfg=dataclasses.replace(cfg, train_microbatches=1),
                           device="meta", verbose=False)
    assert cell["status"] == "ok"
    assert math.isfinite(cell["flops_per_rank"]) and cell["flops_per_rank"] > 0
    assert cell["bytes_per_rank"] > 0
    assert cell["memory_analysis"]["temp_size_in_bytes"] > 0
    assert cell["off_meta"] == {}
    assert cell["rows_per_rank"] == 2


def test_full_config_counted_on_meta():
    """Full internvl2-1b's train program at 256 x 8 on (2, 2, 2): a
    finite count, nothing made off meta (the reference lowers it)."""
    cfg = configs.get("internvl2-1b")
    fn, args = specs.cell_step(cfg, ShapeConfig("t", 256, 8, "train"),
                               MESH3D, device="meta", q_chunk=128)
    assert all(t.device.type == "meta" for t in _flat(args).values()
               if isinstance(t, torch.Tensor))
    c = ca.count(fn, *args)
    assert math.isfinite(c.flops) and c.flops > 0
    assert c.off_meta == {}
    # the per-rank program: 2 of the 8 rows through the whole model, so
    # at least 6 N tokens a rank, compute replicated along 'model'
    _, active = cfg.param_count()
    assert c.flops >= 6 * active * 2 * 256


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_model_flops_matches_reference(arch, shape):
    assert ca.model_flops(configs.get(arch), SHAPES[shape]) == \
        jhlo.model_flops(jconfigs.get(arch), JSHAPES[shape])


@pytest.mark.parametrize("kind", KINDS)
def test_counted_matmul_flops_closed_form(kind):
    """Reduced llama3.2-3b (2 layers, d 64, 4 heads of 16, 2 kv heads, ff
    128, vocab 256, remat "nothing") on (2, 2): 4 rows a rank of 64
    tokens, one query chunk.  Forward: 2 T d (2 H + 2 KV) hd for the
    projections, 2 x 2 B H S Skv hd for QK and PV, 3 x 2 T d ff for the
    MLP, 2 T' d V for the head (T' the rows the head sees); the
    backward twice the forward."""
    cfg = reduced(configs.get("llama3.2-3b"))
    d, H, KV, hd, ff, V = 64, 4, 2, 16, 128, 256
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.padded_vocab, cfg.n_layers, cfg.remat) == \
        (d, H, KV, hd, ff, V, 2, "nothing")
    B, S, L = 4, 64, 2
    q = 1 if kind == "decode" else S           # query tokens a row
    T = B * q

    def layer(skv):
        return (2 * T * d * (2 * H + 2 * KV) * hd + 2 * 2 * B * H * q * skv * hd
                + 3 * 2 * T * d * ff)

    fwd = L * layer(S) + 2 * (B if kind != "train" else T) * d * V
    want = 3 * fwd if kind == "train" else fwd
    fn, args = specs.cell_step(cfg, SMALL[kind], MESH2D, device="meta",
                               q_chunk=64)
    assert ca.count(fn, *args).flops == want


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_traffic_rule_matches_reference(kind):
    for op, out in ((128, 1024), (1024, 128), (64, 64), (0, 8)):
        assert ca._traffic(kind, op, out) == jhlo._traffic(kind, op, out)
    stats = ca.CollectiveStats()
    stats.add(kind, 1024, 4096, ranks=range(8))
    stats.add(kind, 1024, 4096, ranks=range(16))
    t = jhlo._traffic(kind, 1024, 4096)
    assert stats.by_kind == {kind: (2, 2048, 2 * t)}
    # within one 8-card host NVLink; across two hosts the host network
    assert stats.seconds == pytest.approx(t / ca.LINK_BYTES_PER_S
                                          + t / ca.HOST_NET_BYTES_PER_S)


def test_roofline_terms_and_link_groups():
    t = ca.roofline_terms(flops=ca.PEAK_FLOPS, bytes_accessed=ca.HBM_BYTES_PER_S,
                          coll_s=1.0)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    t2 = ca.roofline_terms(flops=1e15, bytes_accessed=1e9, coll_s=0.0)
    assert t2["bottleneck"] == "compute"
    assert t2["bound_s"] == pytest.approx(1e15 / ca.PEAK_FLOPS)
    single = production_spec(False)
    assert ca.group_ranks(single, ("model",)) == list(range(16))
    assert ca.group_ranks(single, ("data",)) == list(range(0, 256, 16))
    assert ca.link_bytes_per_s(ca.group_ranks(MESH2D, ("data", "model"))) \
        == ca.LINK_BYTES_PER_S
    assert ca.link_bytes_per_s(ca.group_ranks(single, ("model",))) == \
        ca.HOST_NET_BYTES_PER_S
    assert dryrun_pald.PEAK_OPS is ca.PEAK_OPS
    assert dryrun_pald.LINK_BYTES_PER_S is ca.LINK_BYTES_PER_S


def test_count_tracks_live_bytes():
    """Two float32 temporaries alive at once, then one; arguments are not
    temporaries; views move no bytes."""
    x = torch.empty(1000, device="meta")

    def prog(x):
        a = x * 2.0
        b = a + 1.0
        del a
        return b.view(10, 100) * 3.0

    c = ca.count(prog, x)
    assert c.temp_bytes == 2 * 4000
    assert c.bytes_accessed == 3 * 2 * 4000
    assert c.flops == 0 and c.off_meta == {}


# ---- the recorder against the analytic counts -----------------------------
@pytest.fixture(scope="module")
def world4():
    with World(4) as w:
        yield w


def _same_stats(outs, want: ca.CollectiveStats):
    w = want.as_dict()
    for rank, got in enumerate(outs):
        assert got["by_kind"] == w["by_kind"], rank
        assert got["seconds"] == pytest.approx(w["seconds"], rel=1e-12), rank


def test_recorder_matches_train_collectives(world4):
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b")),
                              sharding_profile="fsdp")
    outs = world4.run(f"{JOBS}:train_step", cfg, MESH2D, batch=8, seq=16,
                      microbatches=2)
    want = ca.train_collectives(cfg, MESH2D, 8, microbatches=2)
    # a leaf and microbatch, the (loss, aux) pair, the grad norm
    leaves = len(ts.param_layout(cfg, MESH2D))
    assert want.by_kind["all-to-all"][0] == 2 * leaves + 2
    assert want.by_kind["all-reduce"][0] == 1
    _same_stats(outs, want)


def test_cell_step_counts_the_sharded_step(world4):
    """The dry run's per-rank train program is the sharded step itself
    (``train_step.make_train_step(mesh=...)`` with local stand-ins for its
    collectives): counted on meta it gives the flops that every rank of a
    world counts running the step, and the collectives it leaves out are
    the recorder's."""
    cfg = dataclasses.replace(reduced(configs.get("gemma2-2b")),
                              sharding_profile="fsdp")
    outs = world4.run(f"{JOBS}:train_step", cfg, MESH2D, batch=8, seq=16,
                      microbatches=2, counted=True)
    fn, args = specs.cell_step(cfg, ShapeConfig("t", 16, 8, "train"),
                               MESH2D, device="meta", q_chunk=512,
                               microbatches=2)
    with ca.record_collectives() as stats:
        c = ca.count(fn, *args)
    assert stats.total_count == 0 and c.off_meta == {}
    assert c.flops > 0
    for rank, got in enumerate(outs):
        assert got["flops"] == c.flops, rank
    _same_stats(outs, ca.train_collectives(cfg, MESH2D, 8, microbatches=2))


@pytest.mark.parametrize("strategy,mesh", [
    ("allgather", MESH2D), ("ring", MESH2D), ("2d", MESH2D),
    ("2d+stream", MeshSpec((2, 2), ("pod", "model")))])
def test_recorder_matches_pald_body_collectives(world4, strategy, mesh):
    n = 64
    outs = world4.run(f"{JOBS}:pald_body", mesh, n=n, strategy=strategy)
    _same_stats(outs, dryrun_pald.body_collectives(strategy, n, mesh))


def test_recorder_counts_a_psum(world4):
    """The sum of an (8, 32) float32 array sharded by rows: one
    all-reduce of the (32,) partial sums, 32·4 operand bytes a rank."""
    outs = world4.run(f"{JOBS}:psum", MeshSpec((4,), ("data",)), rows=8,
                      cols=32)
    want = torch.arange(8 * 32, dtype=torch.float32).reshape(8, 32).sum(0)
    for got in outs:
        assert got["by_kind"] == {"all-reduce": {
            "count": 1, "bytes": 32 * 4, "traffic": 2 * 32 * 4}}
        assert torch.equal(torch.as_tensor(got["sums"]), want)


# ---- configs, command lines --------------------------------------------
def test_train_microbatches_match_reference():
    for arch in configs.ARCHS:
        assert configs.get(arch).train_microbatches == \
            jconfigs.get(arch).train_microbatches, arch


def _cell_json(path):
    with open(path) as f:
        return json.load(f)


def test_dryrun_cli_meta_and_cpu(tmp_path):
    out = tmp_path / "meta"
    for shape, mesh in (("train_4k", "multi"), ("decode_32k", "single"),
                        ("long_500k", "both")):
        assert dryrun.main(["--reduced", "--arch", "llama3.2-3b", "--shape",
                            shape, "--mesh", mesh, "--device", "meta",
                            "--out", str(out)]) == 0
    cells = {p.name: _cell_json(p) for p in out.glob("*.json")}
    assert len(cells) == 4
    for name, cell in cells.items():
        assert cell["status"] in ("ok", "skipped"), name
    skipped = cells["llama3.2-3b__long_500k__single.json"]
    assert skipped["status"] == "skipped" and "sub-quadratic" in \
        skipped["reason"]
    ok = cells["llama3.2-3b__train_4k__multi.json"]
    assert SHARED_LM_KEYS <= set(ok)
    assert set(ok["roofline"]) == ROOFLINE_KEYS
    assert set(ok["memory_analysis"]) == {"argument_size_in_bytes",
                                          "temp_size_in_bytes"}
    assert ok["mesh"] == "2x16x16" and ok["chips"] == 512
    assert ok["microbatches"] == configs.get("llama3.2-3b").train_microbatches
    assert not any(k.startswith("hlo_") for k in ok)
    dec = cells["llama3.2-3b__decode_32k__single.json"]
    assert dec["collectives"] == "none: serving compute replicated"
    assert dec["one_time_collectives"]["by_kind"]["all-gather"]["count"] > 0
    cpu = tmp_path / "cpu"
    assert dryrun.main(["--reduced", "--arch", "granite-moe-1b-a400m",
                        "--shape", "decode_32k", "--mesh", "single",
                        "--device", "cpu", "--reps", "1", "--out",
                        str(cpu)]) == 0
    cell = _cell_json(cpu / "granite-moe-1b-a400m__decode_32k__single.json")
    assert cell["status"] == "ok"
    m = cell["measured"]
    assert m["fits"] and m["depth"] == "full" and m["step_ms"] > 0


def test_dryrun_skips_a_layout_that_does_not_divide():
    """A reduced MoE's 4 experts on the single pod's 16-wide ``model``:
    the sharded step refuses the layout (as ``jax.device_put`` does), so
    the train cell is skipped with the leaf named; its decode cell runs."""
    cfg = reduced(configs.get("granite-moe-1b-a400m"))
    mesh = production_spec(False)
    cell = dryrun.run_cell("granite-moe-1b-a400m", "train_4k", False,
                           cfg=cfg, device="meta", verbose=False)
    assert cell["status"] == "skipped"
    assert "w_gate" in cell["reason"] and "divisible by 16" in cell["reason"]
    with pytest.raises(ValueError, match="divisible by 16"):
        specs.cell_step(cfg, SHAPES["train_4k"], mesh, device="meta")
    assert dryrun.layout_refusal(cfg, MESH3D) is None
    assert dryrun.run_cell("granite-moe-1b-a400m", "decode_32k", False,
                           cfg=cfg, device="meta",
                           verbose=False)["status"] == "ok"


@pytest.mark.parametrize("strategy", ("allgather", "ring", "2d"))
def test_dryrun_pald_strip_check(monkeypatch, strategy):
    """A dense cell's strip check: the first rows of U and C held to the
    plain versions on the same operands, after the timed calls (each
    pass timed under the guard); a wrong kernel fails it."""
    from repro_torch.kernels import pald_cohesion, pald_focus

    entered = []

    @contextlib.contextmanager
    def guard():
        entered.append(1)
        yield

    def strip(**kw):
        cell = dryrun_pald.run_cell(512, False, strategy, device="cpu",
                                    check_rows=4, verbose=False, **kw)
        st = cell["measured"]["strip"]
        assert st["rows"] == min(4, cell["kernel_calls"]["focus"][0])
        return st

    st = strip(guard=guard)
    assert len(entered) == 2
    assert st["focus_bitwise"] and st["cohesion_within"]

    def wrong(wrapper, change):
        def fn(*a, **k):
            return change(wrapper(*a, **k))
        fn.launches = 0
        return fn

    monkeypatch.setattr(pald_focus, "focus_general_cuda", wrong(
        pald_focus.focus_general_cuda, lambda U: U.roll(1, dims=1)))
    monkeypatch.setattr(pald_cohesion, "cohesion_general_cuda", wrong(
        pald_cohesion.cohesion_general_cuda, lambda C: C * (1 + 1e-3)))
    st = strip()
    assert not st["focus_bitwise"] and st["focus_max_abs_err"] > 0
    assert not st["cohesion_within"]


def test_dryrun_pald_cli_dense(tmp_path):
    out = tmp_path / "pald"
    assert dryrun_pald.main(["--n", "512", "--mesh", "both", "--device",
                             "cpu", "--out", str(out)]) == 0
    cells = {p.name: _cell_json(p) for p in out.glob("*.json")}
    assert sorted(cells) == sorted(
        [f"pald512__{s}__single.json" for s in ("allgather", "ring", "2d")]
        + [f"pald512__{s}__multi.json" for s in dryrun_pald.STRATEGIES])
    for name, cell in cells.items():
        assert cell["status"] == "ok", name
        assert SHARED_PALD_KEYS <= set(cell), name
        assert set(cell["roofline"]) == ROOFLINE_KEYS
        m = cell["measured"]
        # CPU tensors take the plain versions: no kernel launched
        assert m["launches"] == {"focus": 0, "cohesion": 0}, name
        assert m["kernel_ms"] > 0 and m["peak_bytes"] is None
    assert dryrun_pald.main(["--n", "102400", "--mesh", "both", "--device",
                             "meta", "--dtype", "bfloat16", "--out",
                             str(tmp_path / "meta")]) == 0
    ring = _cell_json(tmp_path / "meta" / "pald102400__ring__single__bf16.json")
    assert ring["coll_by_kind"]["by_kind"]["collective-permute"]["count"] \
        == 2 * 255
    assert ring["pald_ops_per_chip"] == dryrun_pald.pald_ops(102400) / 256


def test_hillclimb_cell_against_a_saved_baseline(tmp_path, capsys):
    base = str(tmp_path)
    argv = ["--arch", "gemma2-2b", "--shape", "decode_32k", "--reduced",
            "--device", "meta", "--baseline-dir", base]
    hillclimb.main(["cell"] + argv + ["--save", "base"])
    src = tmp_path / "gemma2-2b__decode_32k__single__base.json"
    src.rename(tmp_path / "gemma2-2b__decode_32k__single.json")
    hillclimb.main(argv + ["--set", "remat=dots"])   # no subcommand: cell
    text = capsys.readouterr().out
    assert "=== delta vs baseline" in text and "compute_s" in text
    assert hillclimb.parse_override("remat=dots") == ("remat", "dots")
    assert hillclimb.parse_override("train_microbatches=2") == \
        ("train_microbatches", 2)
    assert hillclimb.parse_override("norm_f32=False") == ("norm_f32", False)

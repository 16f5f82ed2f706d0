"""The port's tuning cache (repro_torch.tuning.autotune, ``hillclimb``)
against the JAX package's (repro.tuning.autotune).

Held to:
- the reference's robustness tests (tests/test_tuning_robustness.py) on
  the port's tuner: quarantine and its one warning, the locked merging
  save (two processes), record validation at lookup, a plan that survives
  a poisoned record, guarded candidates, the time budget;
- the reference's cache tests (tests/test_tri_and_tuning.py:109-160,
  tests/test_fused_kernels.py:105-135) and key tests
  (tests/test_knn.py:325, tests/test_weights.py:265);
- conformance: one grid of cache contents written under both packages'
  backend and impl strings; the port's ``resolve_blocks_ex``,
  ``resolve_fused_tiles`` and ``method_for_ex`` must answer as the
  reference's, with only those two strings renamed, and ``_pass_key``
  must equal the reference's over every pass, d, k, functional and p;
- the plans: with the same records in both caches, ``block`` /
  ``block_z`` / ``select_block="auto"`` and ``select_tile=`` resolve to
  the reference's tiles and provenance, and C agrees within rtol 1e-5,
  atol 1e-6 (tests/test_conformance.py).

Every test reads and writes temporary caches only.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro_torch
from repro.core import pald as jpald
from repro.core.weights import kernelized as jkernelized
from repro.core.weights import resolve_weight as jresolve_weight
from repro.core.weights import soft_threshold as jsoft_threshold
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.testing import faults as jfaults
from repro.tuning import autotune as jtune
from repro_torch.core import pald
from repro_torch.core.features import cdist_reference
from repro_torch.core.weights import kernelized, resolve_weight, soft_threshold
from repro_torch.kernels import ops, ref
from repro_torch.testing import faults
from repro_torch.tuning import autotune, hillclimb

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh(tmp_path, monkeypatch):
    """Private caches for both packages and a clean fault harness."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _path(tmp_path, name="blocktune.json"):
    return str(tmp_path / name)


def _D(n, seed=0, d=3):
    X = np.random.default_rng(seed).normal(size=(n, d))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


# ---------------------------------------------------------------------------
# the cache's place and backend
# ---------------------------------------------------------------------------
def test_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_pald_torch",
        "blocktune.json")
    assert autotune.cache_path() != jtune.cache_path()
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/elsewhere.json")
    assert autotune.cache_path() == "/elsewhere.json"
    assert autotune.cache_path("given.json") == "given.json"


def test_backend_is_the_device(monkeypatch):
    assert autotune.backend_of("cpu") == "cpu"
    assert autotune._default_impl("cpu") == "torch"
    assert autotune._default_impl("NVIDIA H100 80GB HBM3") == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        autotune.backend_of("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        autotune.backend_of()  # the default device is the card


# ---------------------------------------------------------------------------
# corrupt JSON: warn once, quarantine, start fresh
# (tests/test_tuning_robustness.py)
# ---------------------------------------------------------------------------
def test_truncated_cache_is_quarantined_not_swallowed(tmp_path):
    p = _path(tmp_path)
    Path(p).write_text('{"cpu|torch|256|pald": {"block": 64, "bl')
    with pytest.warns(UserWarning, match="corrupt"):
        assert autotune.load_cache(p) == {}
    moved = list(tmp_path.glob("blocktune.json.corrupt-*"))
    assert len(moved) == 1
    assert moved[0].read_text().startswith('{"cpu|torch|256|pald"')
    assert not os.path.exists(p)  # fresh start
    autotune.save_entry("cpu", "torch", 64, "pald",
                        {"block": 32, "block_z": 32}, p)
    assert "cpu|torch|64|pald" in autotune.load_cache(p)


def test_corrupt_cache_warns_exactly_once(tmp_path):
    p = _path(tmp_path)
    Path(p).write_text("not json at all")
    with pytest.warns(UserWarning, match="corrupt"):
        autotune.load_cache(p)
    Path(p).write_text("still not json")
    autotune._MEM.pop(os.path.abspath(p), None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second warning would fail
        assert autotune.load_cache(p) == {}


def test_non_object_json_is_corrupt_too(tmp_path):
    p = _path(tmp_path)
    Path(p).write_text("[1, 2, 3]")
    with pytest.warns(UserWarning, match="corrupt"):
        assert autotune.load_cache(p) == {}


# ---------------------------------------------------------------------------
# save_entry: locked merge-on-save
# ---------------------------------------------------------------------------
def test_two_processes_merge_instead_of_losing_entries(tmp_path):
    p = _path(tmp_path)
    src = str(Path(next(iter(repro_torch.__path__))).resolve().parent)
    script = textwrap.dedent("""
        import sys
        from repro_torch.tuning import autotune
        tag, path = sys.argv[1], sys.argv[2]
        for i in range(1, 16):
            autotune.save_entry("cpu", tag, i, "pald",
                                {"block": 8, "block_z": 8}, path)
    """)
    env = {**os.environ, "PYTHONPATH": src}
    procs = [subprocess.Popen([sys.executable, "-c", script, tag, p], env=env)
             for tag in ("writer-a", "writer-b")]
    for proc in procs:
        assert proc.wait(timeout=120) == 0
    data = json.loads(Path(p).read_text())
    assert len(data) == 30  # every entry of both writers survived


def test_save_entry_merges_a_peers_entry_written_meanwhile(tmp_path):
    p = _path(tmp_path)
    autotune.save_entry("cpu", "torch", 64, "pald",
                        {"block": 32, "block_z": 32}, p)
    data = json.loads(Path(p).read_text())
    data["cpu|torch|128|pald"] = {"block": 64, "block_z": 64}
    Path(p).write_text(json.dumps(data))  # a peer, behind the memo's back
    autotune.save_entry("cpu", "torch", 256, "pald",
                        {"block": 128, "block_z": 128}, p)
    merged = json.loads(Path(p).read_text())
    assert set(merged) == {"cpu|torch|64|pald", "cpu|torch|128|pald",
                           "cpu|torch|256|pald"}


def test_save_under_held_lock_times_out_with_warning_but_writes(tmp_path):
    p = _path(tmp_path)
    with faults.locked_tuning_cache(p):
        with pytest.warns(UserWarning, match="could not lock"):
            autotune.save_entry("cpu", "torch", 64, "pald",
                                {"block": 32, "block_z": 32}, p,
                                lock_timeout=0.2)
    assert "cpu|torch|64|pald" in json.loads(Path(p).read_text())


# ---------------------------------------------------------------------------
# record validation at lookup: quarantined provenance, never a raise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [
    {"block": -8, "block_z": 64},       # non-positive
    {"block": 0, "block_z": 64},        # zero
    {"block": "64", "block_z": 64},     # wrong type
    {"block": True, "block_z": 64},     # bool is not a tile
    {"block": 64, "block_z": 2.5},      # non-integral float
    {"no_block_at_all": 1},             # no tile at all
])
def test_invalid_tile_records_fall_back_with_quarantine_provenance(
        tmp_path, bad):
    p = _path(tmp_path)
    key = "cpu|torch|128|pald"
    faults.write_cache(p, {key: bad})
    b, bz, src = autotune.resolve_blocks_ex(128, "pald", impl="torch",
                                            backend="cpu", path=p)
    assert (b, bz) == autotune._default_blocks(128, "pald")
    assert src == f"quarantined:{key}"


def test_valid_float_tiles_still_accepted(tmp_path):
    p = _path(tmp_path)  # JSON round-trips may give 64.0
    faults.write_cache(p, {"cpu|torch|128|pald": {"block": 64.0,
                                                  "block_z": 128.0}})
    b, bz, src = autotune.resolve_blocks_ex(128, "pald", impl="torch",
                                            backend="cpu", path=p)
    assert (b, bz) == (64, 128)
    assert src.startswith("cache:")


def test_invalid_method_record_falls_back_to_heuristic(tmp_path):
    p = _path(tmp_path)
    for bogus in ({"method": "knn"}, {"method": "warp-drive"},
                  {"method": 3}, "not-even-a-dict"):
        faults.write_cache(p, {"cpu|-|128|method": bogus})
        m, src = autotune.method_for_ex(128, backend="cpu", path=p)
        assert m == "dense"  # the n <= 256 heuristic
        assert src == "quarantined:cpu|-|128|method"


def test_plan_survives_an_invalid_cached_record(tmp_path, monkeypatch):
    p = _path(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", p)
    faults.write_cache(p, {
        "cpu|torch|64|pald": {"block": "poison"},
        "cpu|cuda|64|pald": {"block": "poison"},
        "cpu|-|64|method": {"method": "poison"},
    })
    plan = pald.plan(n=64, method="auto", block="auto", device="cpu")
    assert plan.method == "dense"  # the heuristic, not the poisoned record
    pk = pald.plan(n=64, method="kernel", block="auto", device="cpu")
    assert pk.explain()["block_source"].startswith("quarantined:")
    assert pk.block == 64  # the default, min(128, n)


# ---------------------------------------------------------------------------
# tune(): per-candidate failure and time budgets
# ---------------------------------------------------------------------------
def test_failed_candidate_records_a_row_and_grid_continues():
    with faults.failing("ops.focus_general", times=1):
        rec = autotune.tune(16, "pald", impl="torch", device="cpu",
                            blocks=(8, 16), blocks_z=(16,), iters=1,
                            save=False)
    failed = [r for r in rec["grid"] if r.get("failed")]
    ok = [r for r in rec["grid"] if "seconds" in r]
    assert len(failed) == 1 and "injected fault" in failed[0]["error"]
    assert ok and rec["block"] in {r["block"] for r in ok}


def test_all_candidates_failing_raises_instead_of_caching(tmp_path):
    p = _path(tmp_path)
    with faults.failing("ops."):
        with pytest.raises(RuntimeError, match="every candidate failed"):
            autotune.tune(16, "pald", impl="torch", device="cpu",
                          blocks=(8, 16), blocks_z=(16,), iters=1, path=p)
    assert autotune.load_cache(p) == {}  # nothing worth caching


def test_time_budget_skips_the_remaining_candidates():
    rec = autotune.tune(16, "pald", impl="torch", device="cpu",
                        blocks=(8, 16, 32), blocks_z=(16,), iters=1,
                        save=False, time_budget=0.0)
    assert [r for r in rec["grid"] if "seconds" in r][0] == rec["grid"][0]
    assert all(r.get("skipped") == "over-budget" for r in rec["grid"][1:])
    assert rec["block"] == rec["grid"][0]["block"]


def test_tune_methods_survives_one_failing_method(tmp_path):
    p = _path(tmp_path)
    # only the kernel method reaches an ops fault point; the dense plain
    # path has none
    with faults.failing("ops."):
        out = autotune.tune_methods(ns=(16,), methods=("dense", "kernel"),
                                    iters=1, path=p, device="cpu")
    rec = out[0]
    assert rec["method"] == "dense"
    assert "kernel" in rec["failed"]
    assert autotune.load_cache(p)["cpu|-|16|method"]["method"] == "dense"


def test_tune_methods_time_budget_skips_whole_sizes(tmp_path):
    p = _path(tmp_path)
    out = autotune.tune_methods(ns=(12, 16, 20), methods=("dense",),
                                iters=1, path=p, device="cpu",
                                time_budget=0.0)
    assert out[0]["n"] == 12 and out[0]["method"] == "dense"
    assert out[1:] == [{"n": 16, "skipped": "over-budget"},
                       {"n": 20, "skipped": "over-budget"}]
    assert set(autotune.load_cache(p)) == {"cpu|-|12|method"}


def test_tune_refuses_a_mesh_cell(tmp_path):
    """``tune(p > 1)``: the mesh cell ``pald_topk:k<k>:d<d>:p<p>``, timed
    on the sharded select->cohere in a world of p ranks, keyed and
    resolved as the reference's (its cell runs on 4 forced host devices);
    the reference's errors off the selection pass and outside such a
    world."""
    from repro_torch.testing.world import World

    kw = dict(blocks=(16,), blocks_z=(64,), iters=1, k=5, d=3)
    jp, pp = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    jrec = jtune.tune(64, "pald_topk", impl="jnp", p=4, path=jp, **kw)
    for tune, extra in ((jtune.tune, {}), (autotune.tune, {"device": "cpu"})):
        with pytest.raises(ValueError, match="only keys the selection pass"):
            tune(64, "pald", p=4, **extra)
    with pytest.raises(RuntimeError, match="needs a torch.distributed world "
                                           "of 4 ranks"):
        autotune.tune(64, "pald_topk", device="cpu", p=4, path=pp, **kw)
    with World(4) as w:
        recs = w.run(autotune.tune, 64, "pald_topk", impl="torch",
                     device="cpu", p=4, path=pp, **kw)
    assert (recs[0]["block"], recs[0]["block_z"]) == (jrec["block"],
                                                      jrec["block_z"])
    (jkey,) = jtune.load_cache(jp)
    assert set(autotune.load_cache(pp)) == {
        "cpu|torch|64|" + jkey.split("|", 3)[3]} == {
        "cpu|torch|64|pald_topk:k5:d3:p4"}
    for resolve, extra in ((jtune.resolve_blocks_ex, {"impl": "jnp",
                                                      "path": jp}),
                           (autotune.resolve_blocks_ex,
                            {"impl": "torch", "path": pp,
                             "device": "cpu"})):
        b, bz, src = resolve(64, "pald_topk", d=3, k=5, p=4, **extra)
        assert (b, bz) == (16, 64) and src.endswith("pald_topk:k5:d3:p4")
        # a miss on the mesh cell falls back to the single-device cell
        assert resolve(64, "pald_topk", d=3, k=5, p=2,
                       **extra)[2] == "default"


def test_cuda_impl_collapses_the_axes_the_kernels_ignore(tmp_path):
    """On impl="cuda" the kernels' tiles are fixed: pald sweeps only the
    engine's pad (rows carry padded_n), every other pass one candidate."""
    p = _path(tmp_path)
    rec = autotune.tune(20, "pald", impl="cuda", device="cpu",
                        blocks=(8, 16), blocks_z=(4, 8), iters=1, path=p)
    assert [(r["block"], r["block_z"], r["padded_n"]) for r in rec["grid"]] \
        == [(8, 20, 24), (16, 20, 32)]
    assert "fixed_tiles" not in rec
    assert "cpu|cuda|20|pald" in autotune.load_cache(p)
    for pass_ in ("focus", "cohesion_tri", "pald_fused", "pald_knn",
                  "pald_topk"):
        rec = autotune.tune(20, pass_, impl="cuda", device="cpu",
                            blocks=(8, 16), blocks_z=(4, 8), iters=1,
                            save=False, k=3)
        assert rec["fixed_tiles"] is True and len(rec["grid"]) == 1
        db, dbz = autotune._default_blocks(20, pass_)
        assert rec["block"] == db
        assert rec["block_z"] == (0 if pass_ == "pald_knn" else dbz)


# ---------------------------------------------------------------------------
# the reference's cache tests (tests/test_tri_and_tuning.py:109-160)
# ---------------------------------------------------------------------------
def test_cache_roundtrip(tmp_path):
    cache = str(tmp_path / "tune.json")
    autotune.save_entry("cpu", "torch", 1024, "cohesion_tri",
                        {"block": 64, "block_z": 256, "seconds": 0.5},
                        path=cache)
    assert autotune.resolve_blocks(1024, "cohesion_tri", impl="torch",
                                   backend="cpu", path=cache) == (64, 256)
    assert autotune.resolve_blocks(2048, "cohesion_tri", impl="torch",
                                   backend="cpu", path=cache) == (64, 256)
    assert autotune.resolve_blocks(1024, "focus", impl="torch",
                                   backend="cpu", path=cache) == (128, 512)
    # another card's record never steers this one
    assert autotune.resolve_blocks(
        1024, "cohesion_tri", impl="torch",
        backend="NVIDIA H100 80GB HBM3", path=cache) == (128, 512)


def test_tune_writes_cache_and_resolves(tmp_path):
    cache = str(tmp_path / "tune.json")
    rec = autotune.tune(32, "cohesion_tri", impl="torch", device="cpu",
                        blocks=(8, 16), blocks_z=(16,), path=cache, iters=1)
    assert {"block", "block_z", "seconds", "grid"} <= set(rec)
    got = autotune.resolve_blocks(32, "cohesion_tri", impl="torch",
                                  device="cpu", path=cache)
    assert got == (rec["block"], rec["block_z"])


def test_method_crossover_cache(tmp_path):
    cache = str(tmp_path / "tune.json")
    assert autotune.method_for(64, backend="cpu", path=cache) == "dense"
    assert autotune.method_for(1024, backend="cpu", path=cache) == "triplet"
    autotune.save_entry("cpu", "-", 1024, "method",
                        {"method": "pairwise", "timings": {}}, path=cache)
    assert autotune.method_for(1024, backend="cpu", path=cache) == "pairwise"
    assert autotune.method_for(900, backend="cpu", path=cache) == "pairwise"
    # nearest-n is unbounded in log space, as in the reference
    assert autotune.method_for(8192, backend="cpu", path=cache) == "pairwise"


def test_block_auto_paths(tmp_path, monkeypatch):
    """block='auto' flows end to end through ops and the public API."""
    D = torch.from_numpy(_D(48))
    U = ops.focus(D, block="auto", block_z="auto", impl="torch")
    np.testing.assert_array_equal(U.numpy(), ref.focus_ref(D).numpy())
    C = pald.cohesion(D, method="kernel", schedule="tri", block="auto",
                      device="cpu")
    Cd = pald.cohesion(D, method="dense", device="cpu")
    np.testing.assert_allclose(C.numpy(), Cd.numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the fused pass's keys (tests/test_fused_kernels.py:105-135)
# ---------------------------------------------------------------------------
def test_pald_fused_block_auto_and_tuning_key():
    X = torch.from_numpy(np.random.default_rng(1).normal(
        size=(48, 4)).astype(np.float32))
    C = ops.pald_fused(X, metric="euclidean", block="auto", impl="torch")
    D = cdist_reference(X, metric="euclidean")
    W = ref.weights_ref(ref.focus_ref(D))
    np.testing.assert_allclose(C.numpy(), ref.cohesion_ref(D, W).numpy(),
                               rtol=RTOL, atol=ATOL)
    autotune.save_entry("cpu", "torch", 48, "pald_fused:d4",
                        {"block": 24, "block_z": 48, "seconds": 0.1})
    assert autotune.resolve_blocks(48, "pald_fused", impl="torch",
                                   backend="cpu", d=4) == (24, 48)
    assert autotune.lookup("cpu", "torch", 48, "pald_fused:d32") is None
    # the tuned tiles give the same C (they chunk the plain versions)
    C2 = ops.pald_fused(X, metric="euclidean", block="auto", impl="torch")
    np.testing.assert_allclose(C2.numpy(), C.numpy(), rtol=RTOL, atol=ATOL)


def test_tune_pald_fused_roundtrip(tmp_path):
    cache = str(tmp_path / "tune.json")
    rec = autotune.tune(32, "pald_fused", impl="torch", device="cpu",
                        blocks=(8, 16), blocks_z=(16,), path=cache, iters=1,
                        d=4)
    assert {"block", "block_z", "seconds", "grid"} <= set(rec)
    got = autotune.resolve_blocks(32, "pald_fused", impl="torch",
                                  device="cpu", path=cache, d=4)
    assert got == (rec["block"], rec["block_z"])


def test_tune_pald_topk_and_knn_roundtrip(tmp_path):
    cache = str(tmp_path / "tune.json")
    rec = autotune.tune(40, "pald_topk", impl="torch", device="cpu",
                        blocks=(16,), blocks_z=(4, 40), path=cache, iters=1,
                        d=3, k=5)
    assert [r["block_z"] for r in rec["grid"]] == [4, 40]
    assert autotune.resolve_blocks(40, "pald_topk", impl="torch",
                                   device="cpu", path=cache, d=3, k=5) == (
        rec["block"], rec["block_z"])
    rec = autotune.tune(40, "pald_knn", impl="torch", device="cpu",
                        blocks=(8, 16), path=cache, iters=1, k=5)
    assert {r["block_z"] for r in rec["grid"]} == {0}
    assert "cpu|torch|40|pald_knn:k5" in autotune.load_cache(cache)


# ---------------------------------------------------------------------------
# keys (tests/test_knn.py:325, tests/test_weights.py:265)
# ---------------------------------------------------------------------------
def test_knn_tuning_pass_key():
    assert autotune._pass_key("pald_knn", None, k=32) == "pald_knn:k32"
    assert (autotune._pass_key("pald_knn", None, "split", k=8)
            == "pald_knn:k8:t-split")


def test_tuning_keys_gain_weight_component():
    pk = autotune._pass_key
    assert pk("pald_focus", None) == "pald_focus"
    assert pk("pald_focus", None, ties="drop") == "pald_focus"
    assert pk("pald_focus", None, ties="split") == "pald_focus:t-split"
    assert (pk("pald_focus", None, ties=resolve_weight("split"))
            == "pald_focus:t-split")
    assert (pk("pald_focus", None, ties=resolve_weight("soft"))
            == "pald_focus:w-soft")
    assert (pk("pald_focus", None, ties=soft_threshold(0.05))
            == "pald_focus:w-soft@0.05")


_TIES = [None, "drop", "split", "ignore", "soft", "kernelized",
         ("soft", 0.05), ("kernelized", 2.0)]


def _functional(spec, port: bool):
    if not isinstance(spec, tuple):
        return spec
    name, arg = spec
    if name == "soft":
        return (soft_threshold if port else jsoft_threshold)(arg)
    return (kernelized if port else jkernelized)(arg)


@pytest.mark.parametrize("pass_", autotune.PASSES + ("method",))
def test_pass_key_equals_the_references(pass_):
    assert autotune.PASSES == jtune.PASSES
    for d in (None, 4):
        for k in (None, 16):
            for p in (None, 1, 4):
                for t in _TIES:
                    got = autotune._pass_key(pass_, d, _functional(t, True),
                                             k=k, p=p)
                    want = jtune._pass_key(pass_, d, _functional(t, False),
                                           k=k, p=p)
                    assert got == want, (pass_, d, k, p, t)


def test_default_blocks_and_synthetic_matrix_equal_the_references():
    for n in (1, 7, 64, 100, 1000, 8000, 20000):
        for pass_ in autotune.PASSES:
            assert autotune._default_blocks(n, pass_) == \
                jtune._default_blocks(n, pass_)
    np.testing.assert_array_equal(autotune.random_distance_matrix(33, 2),
                                  jtune.random_distance_matrix(33, 2))
    np.testing.assert_array_equal(autotune.random_features(9, 5, 3),
                                  jtune.random_features(9, 5, 3))


# ---------------------------------------------------------------------------
# conformance: the same cache contents, the same answers
# ---------------------------------------------------------------------------
PORT_B, PORT_I = "NVIDIA H100 80GB HBM3", "cuda"
REF_B, REF_I = "tpu", "pallas"


def _records(spec: dict, backend: str, impl: str) -> dict:
    return {k.format(B=backend, I=impl): v for k, v in spec.items()}


def _rename(src: str) -> str:
    return (src.replace(f"{REF_B}|{REF_I}|", f"{PORT_B}|{PORT_I}|")
            .replace(f"{REF_B}|-|", f"{PORT_B}|-|"))


# (cache contents, block queries (n, pass, kwargs), fused queries (n, d,
# block, block_z, ties), method queries (n,))
SCENARIOS = {
    "cold": ({}, [(1024, "pald", {}), (64, "cohesion_tri", {}),
                  (20000, "cohesion_tri", {}), (300, "pald_topk",
                                                {"k": 8, "d": 3})],
             [(48, 4, "auto", None, None), (48, 4, 64, "auto", None)],
             [64, 256, 257, 8192]),
    "exact-and-nearest": (
        {"{B}|{I}|1024|pald": {"block": 64, "block_z": 256},
         "{B}|{I}|4096|pald": {"block": 256, "block_z": 512},
         "{B}|{I}|512|cohesion_tri": {"block": 32}},
        [(1024, "pald", {}), (2048, "pald", {}), (3000, "pald", {}),
         (100000, "pald", {}), (16, "pald", {}), (40, "pald", {}),
         (1024, "focus", {}), (512, "cohesion_tri", {}),
         (700, "cohesion_tri", {})],
        [], []),
    "ties-keys": (
        {"{B}|{I}|256|pald": {"block": 64, "block_z": 64},
         "{B}|{I}|256|pald:t-split": {"block": 32, "block_z": 128},
         "{B}|{I}|256|pald:w-soft@0.05": {"block": 16, "block_z": 16},
         "{B}|{I}|512|pald:w-kernelized": {"block": 8, "block_z": 8}},
        [(256, "pald", {"ties": t}) for t in _TIES]
        + [(300, "pald", {"ties": t}) for t in _TIES],
        [], []),
    "wrong-typed": (
        {"{B}|{I}|128|pald": {"block": "64", "block_z": 64},
         "{B}|{I}|128|focus": {"block": True},
         "{B}|{I}|128|cohesion": {"block": 64, "block_z": 2.5},
         "{B}|{I}|128|pald_tri": "not-a-dict",
         "{B}|{I}|128|focus_tri": {"no_block": 1},
         "{B}|{I}|128|cohesion_tri": {"block": -8},
         "{B}|{I}|128|pald:t-split": {"block": 0},
         "{B}|{I}|128|pald_fused:d4": {"block": 64.0, "block_z": 32.0},
         "not|a|key": {"block": 1}, "short|key": {"block": 1}},
        [(128, "pald", {}), (200, "focus", {}), (128, "cohesion", {}),
         (128, "pald_tri", {}), (128, "focus_tri", {}),
         (128, "cohesion_tri", {}), (128, "pald", {"ties": "split"})],
        [(128, 4, "auto", None, None), (128, 4, 16, "auto", None)],
        []),
    "topk-mesh-knn": (
        {"{B}|{I}|4096|pald_topk:k32:d8": {"block": 512, "block_z": 64},
         "{B}|{I}|4096|pald_topk:k32:d8:p4": {"block": 256, "block_z": 32},
         "{B}|{I}|4096|pald_knn:k16": {"block": 64, "block_z": 0},
         "{B}|{I}|4096|pald_knn:k16:t-split": {"block": 32},
         "{B}|{I}|2048|pald_knn:k16:t-split": {"block": "x"}},
        [(4096, "pald_topk", {"k": 32, "d": 8}),
         (4096, "pald_topk", {"k": 32, "d": 8, "p": 4}),
         (4096, "pald_topk", {"k": 32, "d": 8, "p": 2}),
         (9000, "pald_topk", {"k": 32, "d": 8, "p": 4}),
         (4096, "pald_topk", {"k": 16, "d": 8}),
         (4096, "pald_knn", {"k": 16}),
         (4096, "pald_knn", {"k": 16, "ties": "split"}),
         (2048, "pald_knn", {"k": 16, "ties": "split"}),
         (4096, "pald_knn", {"k": 16, "ties": "ignore"}),
         (4096, "pald_knn", {"k": 32})],
        [], []),
    "fused": (
        {"{B}|{I}|48|pald_fused:d4": {"block": 24, "block_z": 48},
         "{B}|{I}|48|pald_fused:d4:t-split": {"block": 16, "block_z": 8},
         "{B}|{I}|96|pald_fused:d8": {"block": 200, "block_z": 300}},
        [],
        [(48, 4, "auto", None, None), (48, 4, "auto", "auto", None),
         (48, 4, 32, "auto", None), (48, 4, "auto", 40, None),
         (48, 4, 32, None, None), (48, 4, 32, 40, None),
         (48, 4, "auto", None, "split"), (48, 4, "auto", None, "ignore"),
         (60, 4, "auto", None, None), (96, 8, "auto", None, None),
         (48, 16, "auto", None, None)],
        []),
    "methods": (
        {"{B}|-|64|method": {"method": "dense", "timings": {}},
         "{B}|-|1024|method": {"method": "triplet"},
         "{B}|-|256|method": {"method": "kernel"}},
        [], [], [64, 100, 128, 256, 400, 512, 1024, 8192, 3]),
    "bad-methods": (
        {"{B}|-|64|method": {"method": "knn"},
         "{B}|-|1024|method": "not-a-dict",
         "{B}|-|300|method": {"method": 3}},
        [], [], [64, 80, 300, 1024, 8192]),
}


def _warnings_off(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.mark.parametrize("name", sorted(SCENARIOS) + ["corrupt"])
def test_resolution_conforms_to_the_reference(name, tmp_path):
    if name == "corrupt":
        spec, bq, fq, mq = SCENARIOS["cold"]
    else:
        spec, bq, fq, mq = SCENARIOS[name]
    pp, rp = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    faults.write_cache(pp, _records(spec, PORT_B, PORT_I))
    jfaults.write_cache(rp, _records(spec, REF_B, REF_I))
    if name == "corrupt":
        for p in (pp, rp):
            Path(p).write_text('{"x|y|1|pald": {"block": 25')
    for n, pass_, kw in bq:
        kw_port = {**kw, "ties": _functional(kw.get("ties"), True)}
        kw_ref = {**kw, "ties": _functional(kw.get("ties"), False)}
        got = _warnings_off(autotune.resolve_blocks_ex, n, pass_,
                            impl=PORT_I, backend=PORT_B, path=pp, **kw_port)
        want = _warnings_off(jtune.resolve_blocks_ex, n, pass_, impl=REF_I,
                             backend=REF_B, path=rp, **kw_ref)
        assert got == want[:2] + (_rename(want[2]),), (n, pass_, kw)
    for n, d, b, bz, t in fq:
        got = _warnings_off(autotune.resolve_fused_tiles, n, d, b, bz,
                            impl=PORT_I, backend=PORT_B, path=pp,
                            ties=_functional(t, True))
        want = _warnings_off(jtune.resolve_fused_tiles, n, d, b, bz,
                             impl=REF_I, backend=REF_B, path=rp,
                             ties=_functional(t, False))
        assert got == want[:2] + (None if want[2] is None
                                  else _rename(want[2]),), (n, d, b, bz, t)
    for n in mq:
        got = _warnings_off(autotune.method_for_ex, n, backend=PORT_B,
                            path=pp)
        want = _warnings_off(jtune.method_for_ex, n, backend=REF_B, path=rp)
        assert got == (want[0], _rename(want[1])), n
    if name == "corrupt":
        assert list(tmp_path.glob("port.json.corrupt-*"))
        assert list(tmp_path.glob("ref.json.corrupt-*"))


# ---------------------------------------------------------------------------
# the plans: the knobs that raised until the tuning cache was ported
# (tests/test_torch_pald.py, tests/test_torch_fused.py,
# tests/test_torch_knn.py), each held to the reference's plan on the same
# records (the port's impl "torch" where the reference's is "jnp")
# ---------------------------------------------------------------------------
N_PLAN = 22
_PLAN_RECORDS = {
    f"cpu|{{I}}|{N_PLAN}|pald": {"block": 8, "block_z": 16},
    f"cpu|{{I}}|{N_PLAN}|pald_tri": {"block": 16, "block_z": 8},
    f"cpu|{{I}}|{N_PLAN}|pald_fused:d3": {"block": 8, "block_z": 16},
    f"cpu|{{I}}|{N_PLAN}|pald_knn:k3": {"block": 8, "block_z": 0},
    f"cpu|{{I}}|{N_PLAN}|pald_topk:k3:d3": {"block": 8, "block_z": 4},
    f"cpu|-|{N_PLAN}|method": {"method": "pairwise", "timings": {}},
}
_PLAN_CASES = [
    ("pald-knn-select_tile", "distance",
     {"method": "knn", "k": 3, "select_tile": 8}),
    ("pald-triplet-block", "distance", {"method": "triplet", "block": "auto"}),
    ("pald-tri-block_z", "distance",
     {"method": "kernel", "schedule": "tri", "block_z": "auto"}),
    ("pald-kernel-block", "distance", {"method": "kernel", "block": "auto"}),
    ("pald-kernel-block_z", "distance",
     {"method": "kernel", "block_z": "auto"}),
    ("pald-auto", "distance", {"block": "auto", "block_z": "auto"}),
    ("fused-triplet-block", "features", {"method": "triplet", "block": "auto"}),
    ("fused-tri-block_z", "features", {"schedule": "tri", "block_z": "auto"}),
    ("fused-block", "features", {"block": "auto"}),
    ("knn-select_tile", "features", {"k": 3, "select_tile": 64}),
    ("knn-select_block", "features", {"k": 3, "select_block": "auto"}),
    ("knn-defaults", "features", {"k": 3}),
]
_EXPLAINED = ("method", "method_source", "schedule", "block", "block_z",
              "block_source", "select_block", "select_tile", "select_source")


@pytest.mark.parametrize("cached", [False, True], ids=["cold", "cached"])
@pytest.mark.parametrize("kind,knobs", [c[1:] for c in _PLAN_CASES],
                         ids=[c[0] for c in _PLAN_CASES])
def test_auto_knobs_resolve_as_the_reference(kind, knobs, cached, tmp_path,
                                             monkeypatch):
    pp, rp = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", pp)
    monkeypatch.setenv("REPRO_TUNE_CACHE", rp)
    if cached:
        faults.write_cache(pp, {k.format(I="torch"): v
                                for k, v in _PLAN_RECORDS.items()})
        jfaults.write_cache(rp, {k.format(I="jnp"): v
                                 for k, v in _PLAN_RECORDS.items()})
    rng = np.random.default_rng(5)
    X = rng.normal(size=(N_PLAN, 3)).astype(np.float32)
    x = cdist_reference(torch.from_numpy(X)).numpy() if kind == "distance" \
        else X
    try:
        jp = jpald.plan(jnp.asarray(x), kind=kind, **knobs)
    except ValueError:
        with pytest.raises(ValueError):
            pald.plan(x, kind=kind, device="cpu", **knobs)
        return
    p = pald.plan(x, kind=kind, device="cpu", **knobs)
    got, want = p.explain(), jp.explain()
    for key in _EXPLAINED:
        w = want[key]
        if isinstance(w, str):
            w = w.replace("cpu|jnp|", "cpu|torch|")
        assert got[key] == w, (key, got[key], want[key])
    if cached and "select_tile" not in knobs and "select_block" not in knobs:
        assert "cache:" in got["block_source"] or got["method_source"] \
            .startswith("cache:") or got["select_source"].startswith("cache:")
    C = p.execute(x).numpy()
    np.testing.assert_allclose(C, np.asarray(jp.execute(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def test_hillclimb_blocks_methods_topk(tmp_path, capsys):
    cache = str(tmp_path / "hc.json")
    common = ["--device", "cpu", "--iters", "1", "--cache", cache]
    hillclimb.main(["blocks", "--n", "20", "--pass", "pald", "--impl",
                    "cuda", "--blocks", "8,16"] + common)
    out = capsys.readouterr().out
    assert "padded_n=24" in out and "padded_n=32" in out and "<- best" in out
    hillclimb.main(["methods", "--ns", "16"] + common)
    assert "best=" in capsys.readouterr().out
    hillclimb.main(["topk", "--n", "30", "--k", "4", "--d", "3", "--impl",
                    "torch", "--blocks", "16", "--tiles", "4,direct"]
                   + common)
    out = capsys.readouterr().out
    assert "tile=4" in out and "direct" in out
    assert set(autotune.load_cache(cache)) == {
        "cpu|cuda|20|pald", "cpu|-|16|method", "cpu|torch|30|pald_topk:k4:d3"}
    # the mesh cell: a local world of 4 ranks, keyed as the reference keys
    # it (jtune._pass_key)
    hillclimb.main(["topk", "--n", "30", "--k", "4", "--d", "3", "--impl",
                    "torch", "--blocks", "16", "--tiles", "4", "--p", "4"]
                   + common)
    out = capsys.readouterr().out
    assert "p=4" in out and "tile=4" in out and "<- best" in out
    mesh_key = jtune._pass_key("pald_topk", 3, k=4, p=4)
    assert mesh_key == "pald_topk:k4:d3:p4"
    assert f"cpu|torch|30|{mesh_key}" in autotune.load_cache(cache)


def test_hillclimb_runs_as_a_module(tmp_path):
    cache = str(tmp_path / "hc.json")
    src = str(Path(next(iter(repro_torch.__path__))).resolve().parent)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuning.hillclimb", "blocks",
         "--n", "12", "--pass", "focus", "--device", "cpu", "--blocks",
         "4,12", "--block-z", "12", "--iters", "1", "--cache", cache],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "cpu|torch|12|focus" in json.loads(Path(cache).read_text())

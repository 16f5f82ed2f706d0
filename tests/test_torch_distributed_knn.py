"""Mesh-sharded k-NN PaLD of the port (repro_torch.core.distributed_knn) in
worlds of spawned ranks on the CPU: bitwise the port's single-device fused
pipeline, and held against the JAX package (tests/test_distributed_knn.py,
the sharded laws of tests/test_pald_properties.py:130-190, the sharded
fault tests of tests/test_faults.py:480-550).

The conformance matrix crosses every strategy x mesh size x k x weight
functional on a tie-heavy integer feature matrix whose n is not divisible
by the larger meshes.  The port's sharded C (``pald.from_features(...,
mesh=)``) must equal its single-device C bitwise, and the reference's
within rtol 1e-5, atol 1e-6 (the two packages' distance loops round
differently: ROADMAP.md queue 3); the graph's indices must equal the
reference's.  Every rank returns the same bits.

Worlds: one rank in this process (``World(1, spawn=False)``), and 2, 4 and
8 spawned ranks (gloo, one thread a rank), each started once per module.
The fault rules are armed inside the ranks (``World.run(faults=...)``).
"""
import warnings

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import assume, given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.core import distributed_knn as jdknn  # noqa: E402
from repro.core import pald as jpald  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import mesh as jmeshlib  # noqa: E402
from repro.tuning import autotune as jtune  # noqa: E402
from repro_torch.core import distributed_knn as dknn  # noqa: E402
from repro_torch.core import pald  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.testing.world import MeshSpec, World, WorldError  # noqa: E402
from repro_torch.tuning import autotune  # noqa: E402

from conftest import euclidean_distance_matrix  # noqa: E402

N, DIM = 50, 4
WEIGHTS = ("drop", "split", "ignore")
K_VALUES = (1, 33, N - 1)  # tiny, mid, and the k >= n-1 dense boundary
RTOL, ATOL = 1e-5, 1e-6
SHARDED = "repro_torch.core.distributed_knn:pald_knn_sharded"
EXECUTE = "repro_torch.testing.world:execute_plan"
EXPLAIN = "repro_torch.testing.world:explain_plan"

# p in {1, 2, 4, 8}; 50 % 4 != 0 and 50 % 8 != 0: uneven shards at the
# larger meshes.  2d needs >= 2 dimensions: (1, 1), (1, 2), (2, 2), (4, 2),
# the last two with pr != 1 (the strided candidate split).
MESH_SHAPES = {
    "allgather": [(1,), (2,), (4,), (8,)],
    "ring": [(1,), (2,), (4,), (8,)],
    "2d": [(1, 1), (1, 2), (2, 2), (4, 2)],
}
CELLS = [
    (strategy, shape, k, weight)
    for strategy, shapes in MESH_SHAPES.items()
    for shape in shapes
    for k in K_VALUES
    for weight in WEIGHTS
]


@pytest.fixture(autouse=True, scope="module")
def _private_tuning_caches(tmp_path_factory):
    """The plans read both packages' tuning caches: keep them (and the
    ranks, which inherit the environment) away from any cache file of the
    machine."""
    d = tmp_path_factory.mktemp("tuning")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(d / "port.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(d / "reference.json"))
        yield d / "port.json"


@pytest.fixture(scope="module")
def worlds(_private_tuning_caches):
    """One world per size, started at first use."""
    started = {}

    def get(p):
        if p not in started:
            started[p] = World(p, spawn=p > 1).start()
        return started[p]

    yield get
    for w in started.values():
        w.close()


def _spec(shape):
    return MeshSpec(tuple(shape), tuple(f"ax{i}" for i in range(len(shape))))


def _jmesh(shape):
    return jmeshlib.make_test_mesh(
        shape, tuple(f"ax{i}" for i in range(len(shape))))


def _run(worlds, target, *args, shape, **kw):
    """Every rank's result (bitwise the same), rank 0's."""
    p = int(np.prod(shape))
    outs = worlds(p).run(target, *args, _spec(shape), device="cpu", **kw)
    for o in outs[1:]:
        for a, b in zip(o if isinstance(o, tuple) else (o,),
                        outs[0] if isinstance(o, tuple) else (outs[0],)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return outs[0]


def _sharded(worlds, X, shape, **kw):
    """(indices, distances, values) of ``pald_knn_sharded``."""
    g, v = _run(worlds, SHARDED, X, shape=shape, **kw)
    return g.indices, g.distances, v


@pytest.fixture(scope="module")
def X():
    # integers 0..3: massive exact distance ties in every metric
    rng = np.random.default_rng(42)
    return rng.integers(0, 4, (N, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def single_device(X):
    """(port C, reference C), single device, cached per (k, weight)."""
    cache = {}

    def get(k, weight):
        if (k, weight) not in cache:
            cache[(k, weight)] = (
                pald.from_features(X, method="knn", k=k, weight=weight,
                                   device="cpu").numpy(),
                np.asarray(jpald.from_features(jnp.asarray(X), method="knn",
                                               k=k, weight=weight)))
        return cache[(k, weight)]

    return get


# ---------------------------------------------------------------------------
# the conformance matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy,shape,k,weight", CELLS)
def test_conformance_bitwise(worlds, X, single_device, strategy, shape, k,
                             weight):
    outs = worlds(int(np.prod(shape))).run(
        "repro_torch.core.pald:from_features", X, method="knn", k=k,
        weight=weight, mesh=_spec(shape), strategy=strategy, device="cpu")
    C = outs[0]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, C)
    port, ref = single_device(k, weight)
    np.testing.assert_array_equal(C, port)
    np.testing.assert_allclose(C, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# module-level contract (graph + values, past the engine)
# ---------------------------------------------------------------------------
def _check_graph(got, X, k, **kw):
    """Bitwise the port's select_cohere; indices the reference's, values
    within tolerance of its."""
    gi, gd, gv = got
    gr, vr = ops.select_cohere(torch.as_tensor(X), k=k, normalize=True,
                               **kw)
    np.testing.assert_array_equal(gi, gr.indices.numpy())
    np.testing.assert_array_equal(gd, gr.distances.numpy())
    np.testing.assert_array_equal(gv, vr.numpy())
    jkw = {key: v for key, v in kw.items() if key in ("metric", "ties")}
    jg, jv = jops.select_cohere(jnp.asarray(X), k=k, impl="jnp",
                                normalize=True, **jkw)
    np.testing.assert_array_equal(gi, np.asarray(jg.indices))
    np.testing.assert_allclose(gv, np.asarray(jv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strategy,shape", [
    ("allgather", (4,)), ("ring", (8,)), ("2d", (2, 2)),
])
def test_sharded_graph_matches_fused(worlds, X, strategy, shape):
    """Neighbor indices, distances and values, not only the scattered C."""
    got = _sharded(worlds, X, shape, k=7, strategy=strategy)
    _check_graph(got, X, 7)


@pytest.mark.parametrize("strategy,shape", [
    ("allgather", (4,)), ("ring", (4,)), ("2d", (2, 2)),
])
def test_sharded_k_full_runs_sharded(worlds, X, strategy, shape):
    """k = n-1 through the shard bodies themselves (the engine runs the
    dense method there; the module still answers exactly)."""
    got = _sharded(worlds, X, shape, k=N - 1, strategy=strategy)
    _check_graph(got, X, N - 1)


def test_k_clamped_and_short_circuit(worlds, X):
    """The engine's k >= n-1 dense short-circuit holds on a mesh plan."""
    C = worlds(4).run("repro_torch.core.pald:from_features", X,
                      method="knn", k=N - 1, mesh=_spec((2, 2)),
                      device="cpu")[0]
    np.testing.assert_array_equal(
        C, pald.from_features(X, method="dense", device="cpu").numpy())


@pytest.mark.parametrize("n", [7, 13, 53])
def test_uneven_prime_n(worlds, n):
    """Prime-ish n on p = 4: every shard padded otherwise; pad lanes
    contribute nothing."""
    rng = np.random.default_rng(n)
    Xp = rng.integers(0, 3, (n, 3)).astype(np.float32)
    k = min(5, n - 1)
    C = worlds(4).run("repro_torch.core.pald:from_features", Xp,
                      method="knn", k=k, mesh=_spec((4,)), strategy="ring",
                      device="cpu")[0]
    np.testing.assert_array_equal(
        C, pald.from_features(Xp, method="knn", k=k, device="cpu").numpy())
    np.testing.assert_allclose(
        C, np.asarray(jpald.from_features(jnp.asarray(Xp), method="knn",
                                          k=k)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["sqeuclidean", "manhattan", "cosine"])
def test_other_metrics(worlds, X, metric):
    for strategy, shape in (("allgather", (4,)), ("ring", (4,)),
                            ("2d", (2, 2))):
        got = _sharded(worlds, X, shape, k=9, metric=metric,
                       strategy=strategy)
        gr, vr = ops.select_cohere(torch.as_tensor(X), k=9, metric=metric,
                                   normalize=True)
        np.testing.assert_array_equal(got[0], gr.indices.numpy())
        np.testing.assert_array_equal(got[2], vr.numpy())


def test_cuda_wrappers_route_as_the_plain_versions(worlds, X):
    """``impl="cuda"`` (the kernels' wrappers, their CPU route) and
    ``impl="torch"`` give the same bits; ``ties="ignore"``'s index
    tiebreak takes each shard's global row offset."""
    for strategy, shape in (("allgather", (4,)), ("ring", (4,)),
                            ("2d", (2, 2))):
        a = _sharded(worlds, X, shape, k=6, strategy=strategy, impl="cuda",
                     ties="ignore")
        b = _sharded(worlds, X, shape, k=6, strategy=strategy, impl="torch",
                     ties="ignore")
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        _check_graph(a, X, 6, ties="ignore")


# ---------------------------------------------------------------------------
# plan surface
# ---------------------------------------------------------------------------
def test_explain_reports_mesh(worlds, X):
    e = worlds(8).run(EXPLAIN, X, kind="features", k=7, mesh=_spec((2, 4)),
                      device="cpu")[0]
    want = jpald.plan(jnp.asarray(X), kind="features", k=7,
                      mesh=_jmesh((2, 4))).explain()
    assert e["mesh"] == (2, 4)
    assert e["mesh_axes"] == ("ax0", "ax1")
    assert e["strategy"] == "2d"  # auto on a 2-dimension mesh
    assert e["shard_rows"] * 8 >= N
    est = e["comm_estimate"]
    assert est["strategy"] == "2d" and est["p"] == 8
    assert set(est["breakdown"]) == {
        "allgather_x", "allgather_ids", "rowcand_slabs", "merge_partials"}
    for key in ("mesh", "mesh_axes", "strategy", "shard_rows",
                "comm_estimate"):
        assert e[key] == want[key], key


def test_explain_off_mesh_is_none(X):
    e = pald.plan(X, kind="features", k=7, device="cpu").explain()
    assert e["mesh"] is None and e["strategy"] is None
    assert e["shard_rows"] is None and e["comm_estimate"] is None


def test_auto_strategy_1d_is_ring(worlds, X):
    e = worlds(4).run(EXPLAIN, X, kind="features", k=7, mesh=_spec((4,)),
                      device="cpu")[0]
    assert e["strategy"] == "ring"
    assert jpald.plan(jnp.asarray(X), kind="features", k=7,
                      mesh=_jmesh((4,))).strategy == "ring"


@pytest.mark.parametrize("knobs,match", [
    ({"k": 7, "strategy": "ring", "mesh": None}, "strategy"),
    ({"method": "fused", "mesh": "m"}, "mesh"),
    ({"k": 7, "mesh": "m", "batch": 2}, "batch"),
    ({"k": 7, "mesh": "m", "strategy": "2d"}, "2d"),
    ({"k": 7, "mesh": "m", "strategy": "torus"}, "strategy"),
])
def test_validation_errors(worlds, X, knobs, match):
    """The reference's errors, on a one-dimension mesh (one rank)."""
    jk = {kk: (_jmesh((1,)) if v == "m" else v) for kk, v in knobs.items()}
    with pytest.raises(ValueError, match=match):
        jpald.plan(jnp.asarray(X), kind="features", **jk)
    pk = {kk: (_spec((1,)) if v == "m" else v) for kk, v in knobs.items()}
    with pytest.raises(ValueError, match=match):
        worlds(1).run(EXPLAIN, X, kind="features", device="cpu", **pk)


def test_sharded_entry_validation(worlds, X):
    for kw in ({"strategy": "torus"}, {"metric": "nope"},
               {"strategy": "2d"}):
        with pytest.raises(ValueError):
            jdknn.pald_knn_sharded(jnp.asarray(X), _jmesh((1,)), k=7, **kw)
        with pytest.raises(ValueError):
            worlds(1).run(SHARDED, X, _spec((1,)), k=7, device="cpu", **kw)


def test_shard_shape_resolution():
    for n, p, chunk in ((50, 4, 64), (50, 4, 8), (7, 8, 3), (1000, 3, 100)):
        got = dknn.resolve_shard_shapes(n, p=p, chunk=chunk)
        assert got == jdknn.resolve_shard_shapes(n, p=p, chunk=chunk)
    chunk, quantum, m = dknn.resolve_shard_shapes(50, p=4, chunk=64)
    assert chunk == 13 and quantum == 52 and m == 52  # clamped to ceil(n/p)
    chunk, quantum, m = dknn.resolve_shard_shapes(50, p=4, chunk=8)
    assert chunk == 8 and quantum == 32 and m == 64
    assert m % 4 == 0 and (m // 4) % chunk == 0


def test_comm_estimate_model():
    est = dknn.comm_estimate("ring", n=1000, d=16, k=8, p=8)
    # ring moves 2 (p-1)/p n d words a rank
    assert est["per_device_words"] == 2 * 7 * 125 * 16
    est = dknn.comm_estimate("allgather", n=1000, d=16, k=8, p=8)
    assert est["per_device_words"] == 7 * 125 * 16
    for strategy, kw in (("allgather", {}), ("ring", {}),
                         ("2d", {"pr": 4, "pc": 2}), ("auto", {"pr": 2,
                                                               "pc": 4}),
                         ("auto", {})):
        assert (dknn.comm_estimate(strategy, n=1000, d=16, k=8, p=8, **kw)
                == jdknn.comm_estimate(strategy, n=1000, d=16, k=8, p=8,
                                       **kw))
    for mod in (dknn, jdknn):
        with pytest.raises(ValueError):
            mod.comm_estimate("torus", n=10, d=2, k=1, p=2)


def test_tuning_key_gains_p(_private_tuning_caches, worlds, X):
    """The selection pass keys on p as the reference's; a mesh plan reads
    the mesh cell, and falls back to the single-device cell on a miss."""
    for p in (4, 1, None):
        kw = {"k": 7} if p is None else {"k": 7, "p": p}
        assert (autotune._pass_key("pald_topk", 4, **kw)
                == jtune._pass_key("pald_topk", 4, **kw))
    assert autotune._pass_key("pald_topk", 4, k=7, p=4) == "pald_topk:k7:d4:p4"
    cache = str(_private_tuning_caches)  # the ranks' cache too
    autotune.save_entry("cpu", "torch", N, "pald_topk:k7:d4",
                        {"block": 20, "block_z": N}, cache)
    autotune.save_entry("cpu", "torch", N, "pald_topk:k7:d4:p4",
                        {"block": 9, "block_z": N}, cache)
    for shape, block in (((4,), 9), ((2,), 20)):
        e = worlds(int(np.prod(shape))).run(
            EXPLAIN, X, kind="features", k=7, mesh=_spec(shape),
            device="cpu")[0]
        assert e["select_block"] == block, shape


# ---------------------------------------------------------------------------
# sharded laws (tests/test_pald_properties.py:130-190)
# ---------------------------------------------------------------------------
def _points(draw, nmin, nmax, dim=3):
    n = draw(st.integers(nmin, nmax))
    flat = draw(st.lists(st.floats(-100, 100, allow_nan=False, width=32),
                         min_size=n * dim, max_size=n * dim))
    X = np.asarray(flat, np.float64).reshape(n, dim)
    # jitter deterministically to kill exact duplicates / ties
    return X + np.arange(n * dim).reshape(n, dim) * 1e-3


@st.composite
def feature_sets(draw, nmin=8, nmax=12, dim=3):
    return np.asarray(_points(draw, nmin, nmax, dim), np.float32)


@settings(max_examples=6, deadline=None)
@given(feature_sets())
def test_sharded_shard_count_invariance(worlds, X):
    """The graph and values are the same bits for any shard count:
    sharding moves data, it never changes a value."""
    i1, d1, v1 = _sharded(worlds, X, (1,), k=3, strategy="ring")
    for p in (2, 4):
        ip, dp, vp = _sharded(worlds, X, (p,), k=3, strategy="ring")
        np.testing.assert_array_equal(ip, i1)
        np.testing.assert_array_equal(dp, d1)
        np.testing.assert_array_equal(vp, v1)


@settings(max_examples=6, deadline=None)
@given(feature_sets(), st.randoms(use_true_random=False))
def test_sharded_permutation_equivariance(worlds, X, rnd):
    """Permuting the points permutes the selected neighborhoods (as sets,
    on tie-free input) and the cohesion matrix equivariantly."""
    n = X.shape[0]
    D = euclidean_distance_matrix(X)
    iu = np.triu_indices(n, 1)
    assume(len(np.unique(D[iu])) == len(iu[0]))
    perm = list(range(n))
    rnd.shuffle(perm)
    perm = np.asarray(perm)
    i0, _, v0 = _sharded(worlds, X, (4,), k=3, strategy="ring")
    ip, _, vp = _sharded(worlds, X[perm], (4,), k=3, strategy="ring")
    np.testing.assert_array_equal(np.sort(perm[ip], axis=1),
                                  np.sort(i0[perm], axis=1))
    ids = np.arange(n)
    full0 = np.concatenate([ids[:, None], i0], axis=1)
    fullp = np.concatenate([perm[:, None], perm[ip]], axis=1)
    C0 = np.zeros((n, n), np.float64)
    Cp = np.zeros((n, n), np.float64)
    np.add.at(C0, (np.repeat(ids, full0.shape[1]), full0.reshape(-1)),
              v0.reshape(-1))
    np.add.at(Cp, (np.repeat(perm, fullp.shape[1]), fullp.reshape(-1)),
              vp.reshape(-1))
    np.testing.assert_allclose(Cp, C0, rtol=1e-4, atol=1e-6)


@settings(max_examples=6, deadline=None)
@given(st.sampled_from([5, 7, 11, 13, 17, 19, 23]),
       st.integers(0, 2**31 - 1))
def test_sharded_pad_lane_masking(worlds, n, seed):
    """Prime-ish n on p = 4: the padded lanes never leak into a selected
    neighborhood or a value; bitwise the single-device pipeline, indices
    the reference's."""
    rng = np.random.default_rng(seed)
    Xs = np.asarray(rng.integers(0, 3, (n, 3)), np.float32)  # ties welcome
    k = min(3, n - 1)
    _check_graph(_sharded(worlds, Xs, (4,), k=k), Xs, k)


# ---------------------------------------------------------------------------
# the mesh rungs (tests/test_faults.py:480-550), rules armed in the ranks:
# a dead shard body re-enters the single-device fused pipeline
# ---------------------------------------------------------------------------
def _Xf(n=17, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _mesh_execute(worlds, X, faults, strategy=None, on_error="fallback"):
    """(C, explain) of a (2, 2) mesh plan on every rank; ``impl="cuda"``
    (its CPU route), so the chain after the mesh rung starts with
    ``impl:torch`` as the reference's starts with its other impls."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return worlds(4).run(EXECUTE, X, returns="C+explain",
                             kind="features", k=5, impl="cuda",
                             mesh=MeshSpec((2, 2), ("rows", "cols")),
                             strategy=strategy, on_error=on_error,
                             device="cpu", faults=faults)


def _baseline(X):
    return pald.from_features(X, method="knn", k=5, device="cpu").numpy()


def test_mesh_body_fault_rescues_single_device_bitwise(worlds):
    X = _Xf()
    for C, e in _mesh_execute(worlds, X, [{"site": "distributed_knn.body"}]):
        np.testing.assert_array_equal(C, _baseline(X))
        (evt,) = e["degradations"]
        assert evt["fallback"] == "mesh:single-device"
        assert evt["mesh"] == (2, 2)
        assert evt["strategy"] == "2d"
        assert evt["cell"] == ("features", "knn", "dense")


@pytest.mark.parametrize("strategy", ["allgather", "ring", "2d"])
def test_mesh_fault_matches_strategy(worlds, strategy):
    """A rule for one strategy fires on that strategy's body only; the
    rescue works the same from each."""
    X = _Xf()
    rules = [{"site": "distributed_knn.body",
              "match": {"strategy": strategy}}]
    for C, e in _mesh_execute(worlds, X, rules, strategy=strategy):
        np.testing.assert_array_equal(C, _baseline(X))
        (evt,) = e["degradations"]
        assert evt["strategy"] == strategy and evt["mesh"] == (2, 2)
    other = "ring" if strategy != "ring" else "allgather"
    for C, e in _mesh_execute(worlds, X, rules, strategy=other):
        np.testing.assert_array_equal(C, _baseline(X))
        assert e["degradations"] == []


def test_mesh_fault_strict_mode_raises(worlds):
    with pytest.raises(WorldError) as ei:
        _mesh_execute(worlds, _Xf(), [{"site": "distributed_knn.dispatch"}],
                      on_error="raise")
    assert sorted(ei.value.errors) == [0, 1, 2, 3]
    assert all("RuntimeError: injected fault" in e
               for e in ei.value.errors.values())


def test_mesh_rescue_survives_dead_primary_impl_too(worlds):
    """Mesh body dead and the single-device re-entry dead too: the walk
    goes on (mesh:single-device -> impl rungs) and still answers bitwise,
    with the mesh cell on the final event."""
    X = _Xf()
    rules = [{"site": "distributed_knn.body"},
             {"site": "resilience.step",
              "match": {"step": "mesh:single-device"}}]
    for C, e in _mesh_execute(worlds, X, rules):
        np.testing.assert_array_equal(C, _baseline(X))
        evt = e["degradations"][-1]
        assert evt["fallback"].startswith("impl:")
        assert evt["mesh"] == (2, 2)


@pytest.mark.parametrize("strategy", ["allgather", "ring", "2d"])
def test_sharded_entry_fallback_and_strict(worlds, X, strategy):
    """``pald_knn_sharded(on_error=...)`` itself: a killed body in every
    rank answers bitwise the single-device pipeline under "fallback" and
    raises in every rank under "raise"; the world then runs on."""
    rule = [{"site": "distributed_knn.body"}]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for g, v in worlds(4).run(SHARDED, X, _spec((2, 2)), k=7,
                                  strategy=strategy, on_error="fallback",
                                  device="cpu", faults=rule):
            _check_graph((g.indices, g.distances, v), X, 7)
    with pytest.raises(WorldError) as ei:
        worlds(4).run(SHARDED, X, _spec((2, 2)), k=7, strategy=strategy,
                      device="cpu", faults=rule)
    assert len(ei.value.errors) == 4
    _check_graph(_sharded(worlds, X, (2, 2), k=7, strategy=strategy), X, 7)


@pytest.mark.parametrize("site", ["distributed_knn.dispatch",
                                  "distributed_knn.body"])
def test_failure_on_one_rank_raises_on_every_rank(worlds, X, site):
    """A fault on rank 0 only: the ranks agree before any collective, so
    every rank raises (rank 0 its own error) and none hangs; the world
    runs on."""
    outs = worlds(2).run("repro_torch.testing.world:on_rank", 0,
                         [{"site": site}], SHARDED, X, _spec((2,)), k=4,
                         strategy="ring", device="cpu", deadline=60)
    assert outs[0].startswith("RuntimeError: injected fault")
    assert outs[1] == ("RuntimeError: the distributed call failed on "
                       "another rank of the mesh")
    _check_graph(_sharded(worlds, X, (2,), k=4), X, 4)

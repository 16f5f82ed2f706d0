"""Distributed PaLD of the port (repro_torch.core.distributed) in worlds of
spawned ranks on the CPU, held against the JAX package's
repro.core.distributed on its 8 forced host devices (tests/conftest.py).

Every case of tests/test_distributed.py, on the same D or X: the 1-D
strategies at p = 8, 2-D on (4, 2) and (2, 4), the pod stream on
(2, 2, 2), padding at n = 50, bfloat16 communication, "auto", the feature
strategies x metrics, the asymmetric 2-D meshes; C within rtol 1e-5, atol
1e-6 of the reference's (tests/test_distributed.py:39's tolerance: the
shard bodies sum the same terms in other orders), and of the port's own
single-device ``pald.cohesion``.  Every rank returns the global C, bitwise
the same.  Then the shard bodies' guard (tests/test_faults.py:339-365) with
the fault rules armed inside the ranks, and the analytic cost model of
``launch/dryrun_pald.py`` against the reference's.

The worlds (gloo, one thread a rank, a ``file://`` store each) start once
per module and serve every case.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import distributed as jdistributed
from repro.core import features as jfeatures
from repro.core import pald as jpald
from repro.launch import mesh as jmeshlib
from repro_torch.core import pald
from repro_torch.testing.world import MeshSpec, World, WorldError

from conftest import euclidean_distance_matrix

RTOL, ATOL = 1e-5, 1e-6
DIST = "repro_torch.core.distributed:pald_distributed"
FEAT = "repro_torch.core.distributed:pald_distributed_from_features"


@pytest.fixture(scope="module")
def world8():
    with World(8) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with World(4) as w:
        yield w


@pytest.fixture(scope="module")
def D48():
    rng = np.random.default_rng(7)
    return euclidean_distance_matrix(rng.normal(size=(48, 4)))


@pytest.fixture(scope="module")
def D50():
    # not divisible by any mesh size: the padding path
    rng = np.random.default_rng(8)
    return euclidean_distance_matrix(rng.normal(size=(50, 4)))


@pytest.fixture(scope="module")
def X50():
    rng = np.random.default_rng(9)
    return rng.normal(size=(50, 4)).astype(np.float32)


def _axes(shape):
    return {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]


def _run(world, target, x, shape, axes=None, **kw):
    """The port's result on every rank (bitwise the same), rank 0's."""
    outs = world.run(target, x, MeshSpec(shape, axes or _axes(shape)),
                     device="cpu", **kw)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


def _ref(D, shape, axes=None, **kw):
    mesh = jmeshlib.make_test_mesh(shape, axes or _axes(shape))
    return np.asarray(jdistributed.pald_distributed(
        jnp.asarray(D), mesh, impl=kw.pop("impl", "jnp"), **kw))


def _single(D, **kw):
    return pald.cohesion(D, device="cpu", **kw).numpy()


def _close(C, *wants):
    for want in wants:
        np.testing.assert_allclose(C, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_1d_strategies(world8, D48, strategy):
    C = _run(world8, DIST, D48, (8,), strategy=strategy)
    _close(C, _ref(D48, (8,), strategy=strategy), _single(D48))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (2, 2, 2)])
def test_2d_strategy(world8, D48, shape):
    C = _run(world8, DIST, D48, shape, strategy="2d")
    _close(C, _ref(D48, shape, strategy="2d"), _single(D48))


def test_2d_pod_stream_equals_full_gather(world8, D48):
    """The pod-streamed schedule only moves data otherwise: both equal the
    reference's pod stream and each other."""
    C1 = _run(world8, DIST, D48, (2, 2, 2), strategy="2d", pod_stream=False)
    C2 = _run(world8, DIST, D48, (2, 2, 2), strategy="2d", pod_stream=True)
    _close(C2, _ref(D48, (2, 2, 2), strategy="2d", pod_stream=True),
           _single(D48))
    np.testing.assert_allclose(C1, C2, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("strategy", ["ring", "2d"])
def test_padding_path(world8, D50, strategy):
    shape = (8,) if strategy == "ring" else (4, 2)
    C = _run(world8, DIST, D50, shape, strategy=strategy)
    _close(C, _ref(D50, shape, strategy=strategy), _single(D50))


def test_interpret_kernels_under_shard_map(world4, D48):
    """Each rank's compute through the kernel wrappers (``impl="cuda"``,
    whose CPU route is the plain versions) against the reference's Pallas
    kernels in interpret mode."""
    C = _run(world4, DIST, D48, (2, 2), strategy="2d", impl="cuda")
    _close(C, _ref(D48, (2, 2), strategy="2d", impl="interpret"),
           _single(D48))


def test_bf16_comm_dtype(world8, D48):
    """bfloat16 distance communication: single-device PaLD on the
    bfloat16-cast D (every bfloat16 value is a float32 value), and close
    to the reference's bfloat16 run and to float32 on generic data."""
    C = _run(world8, DIST, D48, (4, 2), strategy="2d",
             comm_dtype=torch.bfloat16)
    Db = torch.as_tensor(D48).to(torch.bfloat16).to(torch.float32)
    _close(C, _single(Db.numpy()))
    Cj = _ref(D48, (4, 2), strategy="2d", comm_dtype=jnp.bfloat16)
    assert np.abs(C - Cj).max() < 5e-3
    assert np.abs(C - _single(D48)).max() < 5e-3
    assert abs(C.sum() - 24.0) < 0.1   # mass ~ n/2 preserved


def test_auto_strategy(world8, D48):
    for shape in ((8,), (4, 2)):
        C = _run(world8, DIST, D48, shape)
        _close(C, _ref(D48, shape), _single(D48))


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_from_features_strategies(world8, X50, strategy, metric):
    mesh = jmeshlib.make_test_mesh((8,), ("data",))
    want = np.asarray(jdistributed.pald_distributed_from_features(
        jnp.asarray(X50), mesh, metric=metric, strategy=strategy,
        impl="jnp"))
    Cd = np.asarray(jpald.cohesion(
        jfeatures.cdist_reference(X50, metric=metric), method="dense"))
    C = _run(world8, FEAT, X50, (8,), metric=metric, strategy=strategy)
    _close(C, want, Cd, pald.from_features(X50, metric=metric,
                                           device="cpu").numpy())


def test_from_features_multi_axis_mesh_flattens(world8, X50):
    mesh = jmeshlib.make_test_mesh((4, 2), ("data", "model"))
    want = np.asarray(jdistributed.pald_distributed_from_features(
        jnp.asarray(X50), mesh, impl="jnp"))
    C = _run(world8, FEAT, X50, (4, 2))
    _close(C, want, pald.from_features(X50, device="cpu").numpy())


def test_from_features_rejects_unknown_strategy(world8, X50):
    mesh = jmeshlib.make_test_mesh((8,), ("data",))
    with pytest.raises(ValueError):
        jdistributed.pald_distributed_from_features(
            jnp.asarray(X50), mesh, strategy="2d")
    with pytest.raises(WorldError) as ei:
        _run(world8, FEAT, X50, (8,), strategy="2d")
    assert len(ei.value.errors) == 8
    assert all("ValueError: unknown feature strategy '2d'" in e
               for e in ei.value.errors.values())


@pytest.mark.parametrize("shape,axes", [
    ((8, 1), ("data", "model")),   # all rows, trivial column dimension
    ((1, 8), ("data", "model")),   # trivial row dimension, all columns
    ((4, 2, 1), ("pod", "data", "model")),  # pr = 8 (two row dims), pc = 1
])
def test_2d_strategy_asymmetric(world8, D50, shape, axes):
    C = _run(world8, DIST, D50, shape, axes, strategy="2d")
    _close(C, _ref(D50, shape, axes, strategy="2d"), _single(D50))


@pytest.mark.parametrize("ties", ["split", "ignore"])
def test_ties_on_every_strategy(world8, ties):
    """A tie-heavy D under the non-default tie modes: ``ignore``'s index
    tiebreak takes each shard's global offsets."""
    X = np.random.default_rng(3).integers(0, 3, (40, 2)).astype(np.float64)
    D = euclidean_distance_matrix(X)
    want = _single(D, ties=ties)
    for strategy, shape in (("allgather", (8,)), ("ring", (8,)),
                            ("2d", (4, 2))):
        C = _run(world8, DIST, D, shape, strategy=strategy, ties=ties)
        _close(C, want, _ref(D, shape, strategy=strategy, ties=ties))


# ---------------------------------------------------------------------------
# the shard bodies' guard (tests/test_faults.py:339-365), rules in the ranks
# ---------------------------------------------------------------------------
def _Dfault():
    X = np.random.default_rng(3).normal(size=(32, 3))
    return euclidean_distance_matrix(X)


def test_distributed_shard_bodies_degrade_across_impls(world4):
    """Every kernel-wrapper call fails in every rank (``impl="cuda"``, the
    rung the card would run): the bodies' guard walks to the plain
    versions and answers as the unfaulted run does."""
    D = _Dfault()
    mesh = jmeshlib.make_test_mesh((4,), ("dev",))
    baseline = _run(world4, DIST, D, (4,), ("dev",), strategy="ring",
                    impl="cuda")
    rule = {"site": "ops.", "match": {"impl": "cuda"}}
    out = _run(world4, DIST, D, (4,), ("dev",), strategy="ring", impl="cuda",
               on_error="fallback")
    out_faulted = world4.run(DIST, D, MeshSpec((4,), ("dev",)),
                             strategy="ring", impl="cuda",
                             on_error="fallback", device="cpu",
                             faults=[rule])
    for o in out_faulted:
        np.testing.assert_allclose(o, baseline, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out, baseline)
    _close(baseline, np.asarray(jdistributed.pald_distributed(
        jnp.asarray(D), mesh, strategy="ring")))


def test_distributed_strict_mode_still_raises(world4):
    D = _Dfault()
    with pytest.raises(WorldError) as ei:
        world4.run(DIST, D, MeshSpec((4,), ("dev",)), strategy="ring",
                   impl="cuda", device="cpu",
                   faults=[{"site": "ops.", "match": {"impl": "cuda"}}])
    assert sorted(ei.value.errors) == [0, 1, 2, 3]
    assert all("injected fault" in e for e in ei.value.errors.values())
    # the world lives on: the next call runs
    C = _run(world4, DIST, D, (4,), ("dev",), strategy="ring")
    _close(C, _single(D))


# ---------------------------------------------------------------------------
# launch/dryrun_pald: the sharded-knn cost model against the reference's
# ---------------------------------------------------------------------------
def test_dryrun_knn_comm_matches_nd_claim():
    """Every strategy moves O(n d) feature words a rank, never the O(n^2)
    distances; ring moves exactly twice allgather's; the words equal the
    reference's model term for term."""
    from repro.launch.dryrun_pald import knn_shard_estimate as jestimate
    from repro_torch.launch.dryrun_pald import knn_shard_estimate

    n, d, k = 100_000, 64, 32
    for p in (8, 64, 256):
        ag = knn_shard_estimate(n, d, k, strategy="allgather", pr=1, pc=p)
        ring = knn_shard_estimate(n, d, k, strategy="ring", pr=1, pc=p)
        wa = ag["comm"]["per_device_words"]
        assert wa == (p - 1) * (-(-n // p)) * d
        assert wa < n * d and wa * p < n * n
        assert ring["comm"]["per_device_words"] == 2 * wa
    for strategy, pr, pc in (("2d", 16, 16), ("2d", 32, 8), ("2d", 2, 128),
                             ("ring", 1, 8), ("allgather", 1, 64)):
        got = knn_shard_estimate(n, d, k, strategy=strategy, pr=pr, pc=pc)
        want = jestimate(n, d, k, strategy=strategy, pr=pr, pc=pc)
        assert got["comm"] == want["comm"]
        assert got["coll_bytes_per_chip"] == want["coll_bytes_per_chip"]
        for key in ("selection_ops_per_chip", "cohesion_ops_per_chip",
                    "workload", "strategy", "mesh", "chips"):
            assert got[key] == want[key], key


def test_dryrun_knn_estimate_cell_shape():
    from repro_torch.launch.dryrun_pald import (PEAK_OPS, knn_pald_ops,
                                                knn_shard_estimate, pald_ops)
    from repro.launch.dryrun_pald import knn_pald_ops as jknn_pald_ops
    from repro.launch.dryrun_pald import pald_ops as jpald_ops

    cell = knn_shard_estimate(10_000, 16, 8, strategy="ring", pr=1, pc=16)
    assert cell["status"] == "ok" and cell["chips"] == 16
    t = cell["roofline"]
    assert t["bottleneck"] in ("compute", "collective")
    assert t["compute_s"] > 0 and t["collective_s"] > 0
    assert cell["comm"]["strategy"] == "ring"
    assert "H100" in cell["rates"] and "700 W" in cell["rates"]
    assert t["compute_s"] == pytest.approx(
        (cell["selection_ops_per_chip"] + cell["cohesion_ops_per_chip"])
        / PEAK_OPS)
    assert pald_ops(1000) == jpald_ops(1000)
    assert knn_pald_ops(1000, 7) == jknn_pald_ops(1000, 7)

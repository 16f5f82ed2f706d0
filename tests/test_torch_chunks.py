"""Chunks of items through the fused and k-NN cells (``batch=`` on
``from_features`` and ``method="knn"``) against the JAX reference's vmap.

On the card the fused, selection and k-NN values kernels take a whole
chunk in one launch (the item on a grid axis); on this CPU the executors
split a chunk for the plain versions, which take one item.  Held to:

- the registry: the fused and both k-NN cells take chunks;
- every ``batch=`` (1, 2, None) bitwise the items one at a time, and the
  reference's batched ``from_features`` / ``cohesion`` on the same
  numpy-seeded stack within rtol 1e-5, atol 1e-6 (tests/test_conformance.py;
  the two packages sum in another order), the k-NN graphs' indices
  bitwise on tie-free inputs;
- the kernel route's control flow: with the CUDA wrappers replaced by
  stand-ins that take a chunk (the plain versions item by item) and the
  engine told the chunk goes whole, one call of each wrapper a chunk,
  bitwise the items;
- the chunk forms of ``knn_from_distances`` and ``scatter_dense`` bitwise
  their items, and the fused panel's size for a chunk (``panel_rows``).

The kernels themselves are held to their items on the card by
tests/test_torch_cuda.py and ``chip_smoke.py`` (phase 17).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import knn as jknn
from repro.core import pald as jpald
from repro_torch.core import engine, knn, pald
from repro_torch.core.features import cdist_reference
from repro_torch.kernels import ops, pald_fused, pald_knn, pald_topk

RTOL, ATOL = 1e-5, 1e-6
CHUNK_CELLS = [("features", "fused", "dense"), ("features", "knn", "dense"),
               ("distance", "knn", "dense")]


@pytest.fixture(autouse=True)
def _isolated_tuning_cache(tmp_path, monkeypatch):
    """Both packages resolve method / block 'auto' through their tuning
    caches; keep them away from any cache file of the machine."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "port_tune.json"))


def _Xb(b, n, d=3, seed=0):
    """A (b, n, d) stack of tie-free Gaussian features."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, d)).astype(np.float32)


def _tie_Xb(b, n, d=3, seed=0):
    """Features on a coarse grid (exact distance ties) with every fifth
    row a duplicate of an earlier one, item by item."""
    rng = np.random.default_rng(seed)
    X = (rng.integers(-2, 3, size=(b, n, d)) * 0.5).astype(np.float32)
    X[:, 5::5] = X[:, rng.integers(0, 5, size=X[0, 5::5].shape[0])]
    return X


def _Db(Xb):
    return np.stack([cdist_reference(torch.from_numpy(x)).numpy()
                     for x in Xb])


def _run(cell, xb, **kw):
    kind, method, _ = cell
    if kind == "distance":
        return pald.cohesion(xb, method=method, device="cpu", **kw)
    return pald.from_features(xb, method=method, device="cpu", **kw)


def _input(cell, xb):
    return _Db(xb) if cell[0] == "distance" else xb


@pytest.mark.parametrize("cell", CHUNK_CELLS)
def test_fused_and_knn_cells_take_chunks(cell):
    assert engine.get_executor(*cell).chunks is True


@pytest.mark.parametrize("batch", [1, 2, None])
@pytest.mark.parametrize("ties", ["split", "ignore"])
@pytest.mark.parametrize("cell", CHUNK_CELLS)
def test_batch_bitwise_items(cell, ties, batch):
    """Every chunk size gives each item's C bitwise, on tie-heavy input."""
    xb = _input(cell, _tie_Xb(3, 17, seed=4))
    kw = dict(ties=ties, **({"k": 5} if cell[1] == "knn" else {}))
    out = _run(cell, xb, batch=batch, **kw)
    assert out.shape == (3, 17, 17)
    for i in range(3):
        assert torch.equal(out[i], _run(cell, xb[i], **kw)), i


@pytest.mark.parametrize("batch", [1, 2, None])
@pytest.mark.parametrize("cell", CHUNK_CELLS)
def test_batch_matches_reference(cell, batch):
    """The port's chunks against the reference's vmapped chunks of the same
    stack."""
    xb = _input(cell, _Xb(3, 19, seed=7))
    kw = dict(ties="drop", normalize=True,
              **({"k": 6} if cell[1] == "knn" else {}))
    got = _run(cell, xb, batch=batch, **kw).numpy()
    run = jpald.cohesion if cell[0] == "distance" else jpald.from_features
    want = np.asarray(run(jnp.asarray(xb), method=cell[1], batch=batch,
                          **kw))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_chunk_graph_indices_match_reference():
    """The distance kind's selection on a (b, n, n) chunk: each item's
    indices and distances bitwise the reference's vmapped selection on
    tie-free D."""
    Db = _Db(_Xb(4, 23, seed=11))
    g = knn.knn_from_distances(torch.from_numpy(Db), 6, row_chunk=8)
    jg = jax.vmap(lambda d: jknn.knn_from_distances(d, 6))(jnp.asarray(Db))
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_array_equal(g.distances.numpy(),
                                  np.asarray(jg.distances))


@pytest.mark.parametrize("row_chunk", [1, 5, 1024])
def test_knn_from_distances_chunk_bitwise_items(row_chunk):
    """Ties, +inf rows and duplicates: the chunk's graph is each item's."""
    Db = torch.from_numpy(_Db(_tie_Xb(3, 16, seed=2)))
    Db[1, 3, :] = Db[1, :, 3] = float("inf")
    Db[1, 3, 3] = 0.0
    g = knn.knn_from_distances(Db, 7, row_chunk=row_chunk)
    assert g.indices.shape == (3, 16, 7) and g.indices.dtype == torch.int32
    for i in range(3):
        gi = knn.knn_from_distances(Db[i], 7)
        assert torch.equal(g.indices[i], gi.indices)
        assert torch.equal(g.distances[i], gi.distances)
    assert knn.knn_from_distances(Db, 0).indices.shape == (3, 16, 0)


@pytest.mark.parametrize("k", [0, 1, 6])
def test_scatter_dense_chunk_bitwise_items(k):
    """One indexed write for a (b, n, k) graph: bitwise the per-item
    scatter, the diagonal written last."""
    Db = torch.from_numpy(_Db(_Xb(3, 12, seed=3)))
    g = knn.knn_from_distances(Db, k)
    vals = torch.from_numpy(
        np.random.default_rng(5).random((3, 12, k + 1)).astype(np.float32))
    C = knn.scatter_dense(g, vals)
    assert C.shape == (3, 12, 12)
    for i in range(3):
        gi = knn.NeighborGraph(g.indices[i], g.distances[i])
        assert torch.equal(C[i], knn.scatter_dense(gi, vals[i]))


@pytest.mark.parametrize("n", [1, 63, 256, 4096, 8192, 50_000])
def test_panel_rows_for_a_chunk(n):
    """A multiple of 64, at least 64, at most n rounded up to 64; the
    chunk's panels within the budget whenever P > 64; one item's as
    before (the budget at the row stride)."""
    ld = pald_fused.panel_stride(n)
    one = max(64, min(pald_fused.PANEL_BUDGET // (4 * ld) // 64 * 64, ld))
    assert pald_fused.panel_rows(n) == pald_fused.panel_rows(n, 1) == one
    for b in (1, 2, 3, 16, 64, 1000, 65535):
        P = pald_fused.panel_rows(n, b)
        assert P % 64 == 0 and 64 <= P <= max(ld, 64)
        if P > 64:
            assert b * P * ld * 4 <= pald_fused.PANEL_BUDGET, (b, P)
        assert P <= pald_fused.panel_rows(n, max(b // 2, 1))


def test_fused_grids_count_item_grids():
    """The norms once for the chunk, then a panel writer and a pass per
    panel for each grid of up to MAX_ITEMS items."""
    assert pald_fused.fused_grids(256, "euclidean", 64) == 1 + 2 * 4
    assert pald_fused.fused_grids(256, "manhattan", 64, items=5) == 2 * 4
    assert (pald_fused.fused_grids(8, "cosine", 64, items=65537)
            == 1 + 2 * 2)


# ---------------------------------------------------------------------------
# the kernel route's control flow, with stand-in wrappers on the CPU
# ---------------------------------------------------------------------------
def _stand_in(wrapper, calls, graph=False):
    """A wrapper that takes a chunk: the real one (its CPU route, the plain
    version) item by item; each call recorded as (name, took a chunk)."""
    def run(*args, **kw):
        chunk = args[0].ndim == 3
        calls.append((wrapper.__name__, chunk))
        if not chunk:
            return wrapper(*args, **kw)
        outs = [wrapper(*(a[i] if torch.is_tensor(a) else a for a in args),
                        **kw) for i in range(args[0].shape[0])]
        if graph:
            return knn.NeighborGraph(torch.stack([o.indices for o in outs]),
                                     torch.stack([o.distances for o in outs]))
        return torch.stack(outs)
    return run


@pytest.fixture
def kernel_route(monkeypatch):
    """The engine sends chunks whole (as on the card) to stand-ins of the
    five wrappers; the list of their calls."""
    calls = []
    monkeypatch.setattr(engine, "whole_chunk", lambda x, impl: impl != "torch")
    for name, graph in (("focus_fused_cuda", False),
                        ("cohesion_fused_cuda", False),
                        ("topk_select_cuda", True),
                        ("knn_values_from_features_cuda", False),
                        ("knn_values_from_distances_cuda", False)):
        monkeypatch.setattr(ops, name,
                            _stand_in(getattr(ops, name), calls, graph))
    return calls


@pytest.mark.parametrize("batch", [2, None])
@pytest.mark.parametrize("cell", CHUNK_CELLS)
def test_kernel_route_one_call_a_chunk(kernel_route, cell, batch):
    xb = _input(cell, _tie_Xb(5, 14, seed=9))
    kw = dict(ties="ignore", impl="cuda",
              **({"k": 4} if cell[1] == "knn" else {}))
    out = _run(cell, xb, batch=batch, **kw)
    chunks = -(-5 // (batch or 5))
    want = {"fused": ["focus_fused_cuda", "cohesion_fused_cuda"],
            "knn": (["topk_select_cuda", "knn_values_from_features_cuda"]
                    if cell[0] == "features"
                    else ["knn_values_from_distances_cuda"])}[cell[1]]
    assert kernel_route == [(w, True) for w in want] * chunks
    for i in range(5):
        assert torch.equal(out[i], _run(cell, xb[i], **kw)), i


@pytest.mark.parametrize("knobs,calls", [
    ({"k": 13}, []),
    ({"k": 4, "select": "torch"}, [("knn_values_from_features_cuda",
                                    False)] * 3),
    ({"k": 4, "select": "chunked"}, [("knn_values_from_features_cuda",
                                      False)] * 3),
    ({"k": 4, "impl": "torch"}, [])])
def test_kernel_route_item_by_item(kernel_route, knobs, calls):
    """k >= n-1 (the dense path), a plain or chunked selection, or plain
    values: the k-NN chunk runs item by item, so no chunk reaches a
    wrapper."""
    Xb = _tie_Xb(3, 14, seed=1)
    kw = dict(**{"impl": "cuda", **knobs})
    out = pald.from_features(Xb, device="cpu", **kw)
    assert kernel_route == calls
    for i in range(3):
        assert torch.equal(out[i], pald.from_features(Xb[i], device="cpu",
                                                      **kw))


def test_select_cohere_chunk_on_the_kernel_route(kernel_route):
    """``select_cohere`` and ``pald_knn`` on a chunk: one selection and one
    values call, a (b, n, k) graph, bitwise each item's."""
    Xb = torch.from_numpy(_tie_Xb(3, 15, seed=6))
    g, v = ops.select_cohere(Xb, k=5, impl="cuda", ties="split")
    assert g.indices.shape == (3, 15, 5) and v.shape == (3, 15, 6)
    assert kernel_route == [("topk_select_cuda", True),
                            ("knn_values_from_features_cuda", True)]
    Db = torch.from_numpy(_Db(Xb.numpy()))
    gd, vd = ops.pald_knn(Db, k=5, impl="cuda", ties="split")
    for i in range(3):
        gi, vi = ops.select_cohere(Xb[i], k=5, impl="cuda", ties="split")
        assert torch.equal(g.indices[i], gi.indices)
        assert torch.equal(v[i], vi)
        gdi, vdi = ops.pald_knn(Db[i], k=5, impl="cuda", ties="split")
        assert torch.equal(gd.indices[i], gdi.indices)
        assert torch.equal(vd[i], vdi)


def test_c_entries_match_their_ctypes_signatures():
    """Every ``extern "C"`` entry of ``csrc/`` (the chunk entries in their
    own sources) has a ctypes signature in ``_build.SIGNATURES`` with as
    many arguments, and ``_build.entry`` names the one-item entry for one
    item and the chunk entry, with the item count, past it."""
    import re

    from repro_torch.kernels import _build

    found = {}
    for path in _build.CSRC.glob("*.cu"):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            found[name] = (path.stem, len(params.split(",")))
    assert set(found) == set(_build.SIGNATURES)
    for name, (src, argtypes) in _build.SIGNATURES.items():
        assert found[name] == (src, len(argtypes)), name
        assert src in _build.SOURCES
    for stem in ("pald_focus_fused", "pald_cohesion_fused", "pald_topk"):
        assert _build.entry(stem, 1) == (f"{stem}_f32", ())
        assert _build.entry(stem, 3) == (f"{stem}_chunk_f32", (3,))
        one = _build.SIGNATURES[f"{stem}_f32"][1]
        assert len(_build.SIGNATURES[f"{stem}_chunk_f32"][1]) == len(one) + 1


def test_wrappers_count_grids_of_items():
    """The k-NN and selection wrappers add one grid per MAX_ITEMS items
    (the values of a chunk, the selection after its norm pre-pass)."""
    from repro_torch.kernels.pald_focus import MAX_ITEMS, item_grids

    assert item_grids(1) == 1 and item_grids(MAX_ITEMS) == 1
    assert item_grids(MAX_ITEMS + 2) == 2
    assert pald_knn.LARGE_K == pald_topk.LARGE_K == 1024

"""Guarded execution of the port (repro_torch.core.resilience) under forced
failures, held against the JAX package's (repro.core.resilience).

Each single-device test of tests/test_faults.py has its counterpart here,
on ``device="cpu"``, driven by ``repro_torch.testing.faults``:

* with the CUDA impl faulted, every cell's fallback plan on the CPU runs
  no CUDA call and is bitwise its unfaulted run;
* each cell's primary faulted once is rescued by one rung, bitwise an
  unfaulted run of that rung, within rtol 1e-5, atol 1e-6 of its own
  answer and of the JAX package's rescued C on the same input and fault,
  by the corresponding rung (impl names mapped: the reference's "jnp" and
  "interpret" are the port's "torch"; the port's plans take
  ``impl="cuda"``, whose wrappers run the plain versions on CPU tensors,
  so that their chains start as the reference's do off the TPU);
* ``on_error="raise"`` re-raises the original failure and never retries;
* an OOM of a batched call halves ``batch`` (4 -> 2 -> 1) bitwise, and at
  the floor the chain continues to the reference oracle;
* exhaustion raises ``FallbackExhausted`` naming the cell, the cause and
  every step, chained from the original failure; a sticky CUDA error
  stops the walk at once;
* warnings are given once per cause; user functionals reach the
  reference rung with the same functional.

On a plan whose device is the card the chain keeps the kernels: every
rung that would run a plain version or copy to the host is unavailable,
so a failure the OOM halving does not rescue ends in ``FallbackExhausted``
(held here on CPU inputs through a plan whose device is set to the card).

Beyond them: a chunk of b items is bitwise b single items on every cell
(``batch=``), and the ``select="chunked"`` rung against the port's own
``_top_k_rows`` and the JAX package's chunked rung.  The sharded tests of
tests/test_faults.py (:339-357, :482-530) run in worlds of spawned ranks
in tests/test_torch_distributed.py and tests/test_torch_distributed_knn.py.
"""
import dataclasses
import warnings
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import pald as jpald
from repro.core import resilience as jres
from repro.kernels import ops as jops
from repro.testing import faults as jfaults
from repro_torch.core import engine, knn, pald, resilience
from repro_torch.core.features import masked_dist_tile
from repro_torch.kernels import ops
from repro_torch.testing import faults

RTOL, ATOL = 1e-5, 1e-6
CELLS = engine.available_executors()
_IDS = ["-".join(c) for c in CELLS]
_IMPL_METHODS = ("kernel", "fused", "knn")


@pytest.fixture(autouse=True, scope="module")
def _private_tuning_caches(tmp_path_factory):
    """Plans read the tuning caches of both packages (``method="auto"``,
    the "auto" tiles): keep them away from any cache file of the
    machine."""
    d = tmp_path_factory.mktemp("tuning")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(d / "port.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(d / "reference.json"))
        yield


@pytest.fixture(autouse=True)
def _fresh_harness():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _D(n=17, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return D.astype(np.float32)


def _X(n=17, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _input_for(kind, n=17, seed=0):
    return _X(n, seed=seed) if kind == "features" else _D(n, seed=seed)


def _cell_knobs(kind, method, schedule, *, n=17, d=3):
    kw = dict(kind=kind, method=method, schedule=schedule, n=n)
    if method == "knn":
        kw["k"] = 5
    if kind == "features":
        kw["d"] = d
    return kw


def _plan_for_cell(kind, method, schedule, *, on_error="fallback",
                   impl=None, **extra):
    kw = _cell_knobs(kind, method, schedule)
    kw.update(extra)
    if impl is not None and method in _IMPL_METHODS:
        kw["impl"] = impl
    return pald.plan(on_error=on_error, device="cpu", **kw)


def _jplan_for_cell(kind, method, schedule, *, on_error="fallback",
                    **extra):
    kw = _cell_knobs(kind, method, schedule)
    kw.update(extra)
    return jpald.plan(on_error=on_error, **kw)


def _mapped(label):
    """A reference rung's label in the port's impl names."""
    return {"impl:jnp": "impl:torch",
            "impl:interpret": "impl:torch"}.get(label, label)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# the acceptance sweep: every registered cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS, ids=_IDS)
def test_cuda_fault_bitwise_identical_everywhere(cell):
    """Failing every CUDA-impl call leaves every cell's fallback result on
    the CPU bitwise its unfaulted run: a CPU plan makes no CUDA call, so
    nothing trips and nothing degrades."""
    x = _input_for(cell[0])
    baseline = _plan_for_cell(*cell).execute(x)
    p = _plan_for_cell(*cell)
    with faults.fail_kernel(impl="cuda") as rule:
        out = p.execute(x)
    assert torch.equal(out, baseline)
    assert rule.trips == 0
    assert p.explain()["degradations"] == []


@pytest.mark.parametrize("cell", CELLS, ids=_IDS)
def test_primary_failure_walks_chain_with_identical_semantics(cell):
    """Kill each cell's primary dispatch once: one rung rescues it, bitwise
    an unfaulted run of that rung, close to the primary's own answer and
    to the JAX package's rescue by the corresponding rung."""
    x = _input_for(cell[0])
    clean = _plan_for_cell(*cell, impl="cuda")
    baseline = clean.execute(x)
    p = _plan_for_cell(*cell, impl="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("engine.execute", times=1) as rule:
            out = p.execute(x)
    assert rule.trips == 1
    events = p.explain()["degradations"]
    assert len(events) == 1
    evt = events[0]
    assert evt["cause"] == "executor-failure"
    assert evt["cell"] == cell
    assert "injected fault" in evt["error"]
    step = next(s for s in resilience.chain_for(p)
                if s.label == evt["fallback"])
    assert torch.equal(out, step.run(torch.as_tensor(x), clean, None))
    np.testing.assert_allclose(out.numpy(), baseline.numpy(), rtol=RTOL,
                               atol=ATOL)

    jp = _jplan_for_cell(*cell)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jres.DegradationWarning)
        with jfaults.failing("engine.execute", times=1):
            jout = np.asarray(jp.execute(jnp.asarray(x)))
    (jevt,) = jp.explain()["degradations"]
    assert (jevt["cause"], _mapped(jevt["fallback"])) == (
        evt["cause"], evt["fallback"])
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)


def test_fallback_plan_without_faults_changes_nothing():
    D = _D()
    strict = pald.cohesion(D, method="kernel", device="cpu")
    p = pald.plan(D, method="kernel", on_error="fallback", device="cpu")
    assert torch.equal(p.execute(D), strict)
    assert p.explain()["degradations"] == []


# ---------------------------------------------------------------------------
# strict mode: the behavior before the guard, untouched
# ---------------------------------------------------------------------------
def test_strict_mode_reraises_the_original_exception():
    D = _D()
    with faults.failing("engine.execute",
                        exc=lambda: RuntimeError("kernel exploded")):
        with pytest.raises(RuntimeError, match="kernel exploded"):
            pald.cohesion(D, method="kernel", device="cpu")


def test_strict_mode_does_not_retry_oom():
    B = np.stack([_D(seed=s) for s in range(4)])
    p = pald.plan(_D(), method="kernel", batch=4, device="cpu")
    with faults.simulate_oom(max_batch=1) as rule:
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            p.execute(B)
    assert rule.trips == 1


def test_unknown_on_error_rejected_at_plan_time():
    with pytest.raises(ValueError, match="on_error"):
        pald.plan(n=16, on_error="retry", device="cpu")
    with pytest.raises(ValueError, match="on_error"):
        pald.from_features(_X(), on_error="never", device="cpu")
    assert resilience.ON_ERROR_MODES == jres.ON_ERROR_MODES


# ---------------------------------------------------------------------------
# OOM-aware batching
# ---------------------------------------------------------------------------
def test_oom_halves_batch_until_it_fits_bitwise():
    B = np.stack([_D(seed=s) for s in range(5)])
    clean = pald.plan(_D(), method="kernel", batch=4, on_error="fallback",
                      device="cpu")
    baseline = clean.execute(B)
    p = pald.plan(_D(), method="kernel", batch=4, on_error="fallback",
                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.simulate_oom(max_batch=1):  # the "device" fits 1 item
            out = p.execute(B)
    assert torch.equal(out, baseline)  # re-chunking is bitwise
    events = p.explain()["degradations"]
    assert [e["cause"] for e in events] == ["oom", "oom"]  # 4 -> 2 -> 1
    assert [e["batch"] for e in events] == [2, 1]

    jp = jpald.plan(jnp.asarray(_D()), method="kernel", batch=4,
                    on_error="fallback")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jres.DegradationWarning)
        with jfaults.simulate_oom(max_batch=1):
            jout = np.asarray(jp.execute(jnp.asarray(B)))
    assert ([(e["cause"], e["batch"]) for e in jp.explain()["degradations"]]
            == [(e["cause"], e["batch"]) for e in events])
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)


def test_oom_at_the_floor_degrades_to_the_chain():
    B = np.stack([_D(seed=s) for s in range(4)])
    clean = pald.plan(_D(), method="kernel", batch=4, on_error="fallback",
                      device="cpu")
    baseline = clean.execute(B)
    p = pald.plan(_D(), method="kernel", batch=4, on_error="fallback",
                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.simulate_oom():  # every batched call, batch=1 too
            out = p.execute(B)
    causes = [e["cause"] for e in p.explain()["degradations"]]
    assert "oom-floor" in causes
    final = p.explain()["degradations"][-1]
    # only the reference oracle does not go through the batch layer
    assert final["cause"] == "executor-failure"
    assert final["fallback"] == "reference"
    np.testing.assert_allclose(out.numpy(), baseline.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_oom_retry_runs_after_the_failed_chunk_is_freed():
    """The halved retry must not run beside the failed attempt's tensors:
    only the message survives the failure (the traceback's frames hold
    the chunk's buffers)."""
    x = torch.zeros((4, 3, 3))
    p = pald.plan(n=3, method="kernel", on_error="fallback", device="cpu")
    refs = []

    def run(xi, b):
        assert all(r() is None for r in refs), "a failed chunk is alive"
        buf = torch.empty(1 << 10)
        refs.append(weakref.ref(buf))
        if b > 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 4.00 KiB")
        return xi

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        out, batch = resilience._run_with_oom_retries(run, x, p, 4,
                                                      ("distance",))
    assert out is x and batch == 1 and len(refs) == 3
    errors = [e["error"] for e in p.explain()["degradations"]]
    assert all(isinstance(e, str) and "CUDA out of memory" in e
               for e in errors)


def test_failure_classes():
    assert resilience.is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert resilience.is_oom(MemoryError())
    assert resilience.is_oom(resilience.simulated_oom())
    assert not resilience.is_oom(ValueError("k=2048 exceeds the limit"))
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: unspecified launch failure",
                "pald_focus_square_f32: CUDA error 700 at launch",
                "pald_cohesion_f32: CUDA error 719 at launch"):
        assert resilience.is_sticky(RuntimeError(msg)), msg
    for msg in ("pald_cohesion_f32: CUDA error 1 at launch",
                "CUDA out of memory"):
        assert not resilience.is_sticky(RuntimeError(msg)), msg


# ---------------------------------------------------------------------------
# exhaustion: the error message is the debugging surface
# ---------------------------------------------------------------------------
def test_fallback_exhausted_names_cell_cause_and_every_step():
    D = _D()
    p = pald.plan(D, method="kernel", impl="cuda", on_error="fallback",
                  device="cpu")
    with faults.failing(""):  # every site: primary, chain steps, reference
        with pytest.raises(resilience.FallbackExhausted) as ei:
            p.execute(D)
    msg = str(ei.value)
    for frag in (
        "every fallback failed for cell",
        "('distance', 'kernel', 'dense')",
        "primary raised RuntimeError: injected fault",
        "degradation chain attempted",
        "impl:torch",
        "method:triplet",
        "method:dense",
        "reference",
    ):
        assert frag in msg, f"missing {frag!r} in {msg!r}"
    assert isinstance(ei.value.__cause__, RuntimeError)


def test_sticky_cuda_error_stops_the_walk():
    """After a sticky CUDA error no rung on the card can run: the call
    ends in FallbackExhausted at once, chained from that error."""
    D = _D()
    p = pald.plan(D, method="kernel", impl="cuda", on_error="fallback",
                  device="cpu")
    sticky = "CUDA error: an illegal memory access was encountered"
    with faults.failing("engine.execute",
                        exc=lambda: RuntimeError(sticky)), \
         faults.failing("resilience.step") as steps:
        with pytest.raises(resilience.FallbackExhausted,
                           match="sticky CUDA error") as ei:
            p.execute(D)
    assert steps.calls == 0
    assert sticky in str(ei.value.__cause__)
    assert p.explain()["degradations"] == []


def test_reference_rung_refuses_large_n():
    """The numpy oracle is an O(n^3) Python loop: past REFERENCE_MAX_N the
    rung is unavailable, so a call whose other rungs are dead ends in
    FallbackExhausted at once instead of running for hours."""
    n = resilience.REFERENCE_MAX_N + 1
    D = np.zeros((n, n), np.float32)
    p = pald.plan(D, method="kernel", on_error="fallback", device="cpu")
    with faults.failing("engine.execute"), \
         faults.failing("resilience.step",
                        pred=lambda site, **c: c.get("step") != "reference"):
        with pytest.raises(resilience.FallbackExhausted,
                           match="reference: FallbackUnavailable"):
            p.execute(D)


def test_features_chain_exhausts_when_distance_frontend_is_dead():
    """Every non-fused features path (the materializing executors and the
    reference oracle) funnels through cdist: killing it exhausts."""
    X = _X()
    p = pald.plan(X, kind="features", method="pairwise", on_error="fallback",
                  device="cpu")
    with faults.failing("features.cdist"):
        with pytest.raises(resilience.FallbackExhausted) as ei:
            p.execute(X)
    assert "('features', 'pairwise', 'dense')" in str(ei.value)


@pytest.mark.parametrize("impl", [None, "cuda"])
def test_knn_chain_is_impl_only(impl):
    """The k-NN chain never degrades onto a dense method: the impls, then
    the select:chunked rung."""
    for kind in ("distance", "features"):
        p = _plan_for_cell(kind, "knn", "dense", impl=impl)
        labels = [s.label for s in resilience.chain_for(p)]
        assert labels and labels[-1] == "select:chunked"
        assert all(lb.startswith("impl:") for lb in labels[:-1])
        assert "reference" not in labels
        assert ("impl:torch" in labels) == (impl == "cuda")
        assert "impl:cuda" not in labels  # a CPU plan


# ---------------------------------------------------------------------------
# the select -> cohere sites degrade bitwise
# ---------------------------------------------------------------------------
def _knn_features_plan(on_error="fallback"):
    return pald.plan(kind="features", method="knn", n=33, d=3, k=5,
                     on_error=on_error, device="cpu")


def test_fused_selection_fault_rescued_bitwise():
    """Kill the plain select -> cohere pipeline: the terminal
    select:chunked rung answers, bitwise (the same distances, the same
    stable sort; finite distances, so both self rules agree)."""
    x = _X(n=33)
    baseline = _knn_features_plan().execute(x)
    p = _knn_features_plan()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("ops.select_cohere", match={"select": "torch"}):
            out = p.execute(x)
    assert torch.equal(out, baseline)
    events = p.explain()["degradations"]
    assert events and events[-1]["fallback"] == "select:chunked"


def test_topk_select_fault_rescued_bitwise():
    x = _X(n=33)
    baseline = _knn_features_plan().execute(x)
    p = _knn_features_plan()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("ops.topk_select", match={"impl": "torch"}):
            out = p.execute(x)
    assert torch.equal(out, baseline)
    assert len(p.explain()["degradations"]) == 1


def test_terminal_selection_rung_answers_alone_bitwise():
    x = _X(n=33)
    baseline = _knn_features_plan().execute(x)
    p = _knn_features_plan()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("engine.execute", times=1), \
             faults.failing("resilience.step",
                            pred=lambda site, **c: str(
                                c.get("step", "")).startswith("impl:")):
            out = p.execute(x)
    assert torch.equal(out, baseline)
    assert p.explain()["degradations"][-1]["fallback"] == "select:chunked"


def test_selection_faults_raise_in_strict_mode():
    x = _X(n=33)
    p = _knn_features_plan(on_error="raise")
    with faults.failing("ops.select_cohere", match={"select": "torch"}):
        with pytest.raises(RuntimeError, match="injected fault"):
            p.execute(x)


# ---------------------------------------------------------------------------
# degradation events + once-per-cause warnings
# ---------------------------------------------------------------------------
def test_degradation_warns_once_per_cause_then_stays_quiet():
    D = _D()
    p = pald.plan(D, method="kernel", impl="cuda", on_error="fallback",
                  device="cpu")
    with faults.failing("engine.execute"):
        with pytest.warns(resilience.DegradationWarning,
                          match="degraded to impl:torch"):
            p.execute(D)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # any further warning fails
            p.execute(D)
    assert len(p.explain()["degradations"]) == 2


def test_explain_surfaces_on_error_and_degradations():
    p = pald.plan(n=16, method="kernel", on_error="fallback", device="cpu")
    info = p.explain()
    assert info["on_error"] == "fallback"
    assert info["degradations"] == []
    info["degradations"].append("junk")  # a copy, not the plan's log
    assert p.explain()["degradations"] == []
    assert pald.plan(n=16, device="cpu").explain()["on_error"] == "raise"


# ---------------------------------------------------------------------------
# weight functionals through the chain: every rung re-enters with the SAME
# functional
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS, ids=_IDS)
def test_chain_rescues_with_same_weight_functional(cell):
    x = _input_for(cell[0])
    clean = _plan_for_cell(*cell, impl="cuda", weight="soft")
    baseline = clean.execute(x)
    p = _plan_for_cell(*cell, impl="cuda", weight="soft")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("engine.execute", times=1) as rule:
            out = p.execute(x)
    assert rule.trips == 1
    events = p.explain()["degradations"]
    assert len(events) == 1 and events[0]["cause"] == "executor-failure"
    assert p.explain()["weight"] == "soft"
    step = next(s for s in resilience.chain_for(p)
                if s.label == events[0]["fallback"])
    assert torch.equal(out, step.run(torch.as_tensor(x), clean, None))
    np.testing.assert_allclose(out.numpy(), baseline.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_terminal_reference_rung_speaks_weight_functionals():
    """Everything above the terminal rung dead, weight='soft': the rung
    takes the torch oracle with the same functional, against the
    reference's same rescue."""
    D = _D()
    baseline = pald.cohesion(D, method="dense", weight="soft", device="cpu")
    p = pald.plan(D, method="kernel", weight="soft", on_error="fallback",
                  device="cpu")
    dead_rungs = dict(pred=lambda site, **c: str(c.get("step", "")).startswith(
        ("impl:", "method:")))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.failing("engine.execute"), \
             faults.failing("resilience.step", **dead_rungs):
            out = p.execute(D)
    assert p.explain()["degradations"][-1]["fallback"] == "reference"
    np.testing.assert_allclose(out.numpy(), baseline.numpy(), rtol=RTOL,
                               atol=ATOL)
    jp = jpald.plan(jnp.asarray(D), method="kernel", weight="soft",
                    on_error="fallback")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jres.DegradationWarning)
        with jfaults.failing("engine.execute"), \
             jfaults.failing("resilience.step", **dead_rungs):
            jout = np.asarray(jp.execute(jnp.asarray(D)))
    assert jp.explain()["degradations"][-1]["fallback"] == "reference"
    np.testing.assert_allclose(out.numpy(), jout, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# batch= as a chunk bound
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 2, 3, 5])
@pytest.mark.parametrize("cell", CELLS, ids=_IDS)
def test_chunks_bitwise_single_items(cell, b):
    """A chunk of b items over a ragged B = 7 is bitwise the items run one
    at a time, and the batch layer sees chunks of min(b, B)."""
    xs = np.stack([_input_for(cell[0], seed=s) for s in range(7)])
    p = _plan_for_cell(*cell, on_error="raise", batch=b)
    sizes = []
    with faults.failing("engine.batch", pred=lambda site, batch=None, **c:
                        sizes.append(batch) and False):
        out = p.execute(xs)
    assert sizes == [b]
    single = _plan_for_cell(*cell, on_error="raise")
    for i, xi in enumerate(xs):
        assert torch.equal(out[i], single.execute(xi)), (cell, b, i)


def test_chunk_executors_take_chunks():
    """The kernel cells (and triplet, the fused and k-NN cells, and the
    materializing features cells) run a chunk as one; the others item by
    item."""
    chunked = {c for c in CELLS if engine.get_executor(*c).chunks}
    assert chunked == {c for c in CELLS
                       if c[1] in ("kernel", "triplet", "fused", "knn")
                       or (c[0] == "features" and c[1] in (
                           "dense", "pairwise"))}


def test_batched_kernel_executors_match_items():
    """The kernel and triplet executors on a padded (b, n, n) chunk:
    bitwise the items, padded z counted alike (``split`` on a ragged n),
    the plain versions given one item at a time."""
    Db = torch.as_tensor(np.stack([_D(n=19, seed=s) for s in range(3)]))
    Db[1, 0, 5] = Db[1, 5, 0] = float("inf")
    seen = []
    plain = ops.focus_general_torch

    def one_item(*a, **kw):
        seen.append(a[0].ndim)
        return plain(*a, **kw)

    for cell in (("distance", "kernel", "dense"),
                 ("distance", "kernel", "tri"),
                 ("distance", "triplet", "dense")):
        p = pald.plan(n=19, method=cell[1], schedule=cell[2], block=8,
                      ties="split", normalize=True, device="cpu",
                      **({"block_z": 16} if cell[1] == "kernel" else {}))
        fn = engine.get_executor(*cell)
        ops.focus_general_torch = one_item
        try:
            Cb = fn(Db, p)
        finally:
            ops.focus_general_torch = plain
        for i in range(3):
            assert torch.equal(Cb[i], fn(Db[i], p)), (cell, i)
    assert seen == [2, 2, 2]  # the dense cell's items, one at a time


# ---------------------------------------------------------------------------
# a plan on the card keeps its kernels
# ---------------------------------------------------------------------------
def _on_card(p):
    """The plan with its device set to the card (its chain is built from
    the device; these tests feed it CPU inputs and run no kernel)."""
    return dataclasses.replace(p, device=torch.device("cuda"))


@pytest.mark.parametrize("cell", CELLS, ids=_IDS)
def test_card_plan_chain_ends_exhausted(cell):
    """A card plan's failed primary is not answered by a plain version
    or the host: every rung past the kernels is unavailable, and the call
    ends in FallbackExhausted naming the cell and each rung, chained from
    the original failure, with no degradation recorded."""
    x = torch.as_tensor(_input_for(cell[0]))
    p = _on_card(_plan_for_cell(*cell, impl="cuda"))
    labels = [s.label for s in resilience.chain_for(p)]
    assert labels == [s.label for s in resilience.chain_for(
        _plan_for_cell(*cell, impl="cuda"))]
    with faults.failing("engine.execute", times=1), \
         faults.failing("resilience.step") as steps:
        with pytest.raises(resilience.FallbackExhausted) as ei:
            resilience.execute_plan(p, x)
    assert steps.calls == 0  # no rung ran
    msg = str(ei.value)
    assert str(cell) in msg and "injected fault" in msg
    for label in labels:
        assert f"{label}: FallbackUnavailable" in msg, (label, msg)
    assert "injected fault" in str(ei.value.__cause__)
    assert p.explain()["degradations"] == []


def test_card_plan_keeps_the_cuda_rung_and_the_halving():
    """On the card the impl:cuda rung of an impl="torch" plan stays
    runnable, and an OOM of a batched call is still halved, bitwise."""
    p = _on_card(pald.plan(n=17, method="kernel", impl="torch",
                           on_error="fallback", device="cpu"))
    (cuda_step, *rest) = resilience.chain_for(p)
    assert cuda_step.label == "impl:cuda"
    with faults.failing("resilience.step") as rule:
        with pytest.raises(RuntimeError, match="injected fault"):
            cuda_step.run(torch.as_tensor(_D()), p, None)
    assert rule.trips == 1
    for step in rest:
        with pytest.raises(resilience.FallbackUnavailable, match="card"):
            step.run(torch.as_tensor(_D()), p, None)

    B = torch.as_tensor(np.stack([_D(seed=s) for s in range(5)]))
    baseline = pald.plan(n=17, method="kernel", batch=1,
                         device="cpu").execute(B)
    p = _on_card(pald.plan(n=17, method="kernel", batch=4,
                           on_error="fallback", device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", resilience.DegradationWarning)
        with faults.simulate_oom(max_batch=1):
            out = resilience.execute_plan(p, B)
    assert torch.equal(out, baseline)
    assert [e["batch"] for e in p.explain()["degradations"]] == [2, 1]


# ---------------------------------------------------------------------------
# the select="chunked" rung
# ---------------------------------------------------------------------------
def _own_top_k(X, k, metric):
    n = X.shape[0]
    rows = masked_dist_tile(X, X, metric, 0, 0, n)
    rows.fill_diagonal_(float("inf"))
    return knn._top_k_rows(rows, k)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine",
                                    "manhattan"])
@pytest.mark.parametrize("k,row_chunk", [(1, 7), (5, 16), (32, 1024)])
def test_chunked_rung_is_top_k_rows_on_its_distances(metric, k, row_chunk):
    """Indices bitwise the port's ``_top_k_rows`` over its own distances
    with self at +inf, distances bitwise those distances, on quantized
    features with duplicated rows (ties everywhere)."""
    rng = np.random.default_rng(k)
    X = rng.integers(0, 4, size=(60, 3)).astype(np.float32)
    X[7] = X[3]
    X = torch.as_tensor(X)
    g = ops.topk_select(X, k, metric=metric, impl="chunked", block=row_chunk)
    dv, di = _own_top_k(X, k, metric)
    assert torch.equal(g.indices, di) and torch.equal(g.distances, dv)
    # the plain selection: the same graph wherever self cannot tie (finite)
    p = ops.topk_select(X, k, metric=metric, impl="torch")
    assert torch.equal(p.indices, g.indices)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_chunked_rung_matches_reference_rung(metric):
    """Tie-free draws: the indices equal the JAX package's chunked rung,
    the distances within tolerance (its sums run in another order)."""
    X = _X(n=70, d=5, seed=3)
    g = ops.topk_select(torch.as_tensor(X), 6, metric=metric,
                        impl="chunked", block=16)
    jg = jops.topk_select(jnp.asarray(X), 6, metric=metric, impl="chunked",
                          block=16)
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_allclose(g.distances.numpy(),
                               np.asarray(jg.distances), rtol=RTOL,
                               atol=ATOL)


def test_chunked_rung_excludes_self_by_the_reference_rule():
    """Among +inf entries self takes its index's place in the chunked rung
    (the reference rung's rule), where the plain selection and the kernel
    sort it after every candidate; the JAX package's rung agrees."""
    X = np.array([[3e19], [0.0], [1.0], [2.0]], np.float32)
    for metric in ("sqeuclidean", "euclidean"):
        g = ops.topk_select(torch.as_tensor(X), 2, metric=metric,
                            impl="chunked", block=2)
        assert g.indices[0].tolist() == [0, 1]  # self among the +inf
        assert g.indices.tolist() == [[0, 1], [2, 3], [1, 3], [2, 1]]
        assert ops.topk_select(torch.as_tensor(X), 2, metric=metric,
                               impl="torch").indices[0].tolist() == [1, 2]
        jg = jops.topk_select(jnp.asarray(X), 2, metric=metric,
                              impl="chunked", block=2)
        np.testing.assert_array_equal(g.indices.numpy(),
                                      np.asarray(jg.indices))


def test_chunked_rung_edges():
    X = torch.as_tensor(_X(n=9))
    g = ops.topk_select(X, 0, impl="chunked")
    assert g.indices.shape == (9, 0) and g.distances.shape == (9, 0)
    with pytest.raises(ValueError, match="exceeds"):
        ops.topk_select(X, 9, impl="chunked")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.topk_select(X, 2, impl="pallas")
    D = torch.as_tensor(_D(n=40, seed=2))
    ref = knn.knn_from_distances(D, 6)
    got = ops._knn_from_distances_chunked(D, 6, row_chunk=7)
    assert torch.equal(got.indices, ref.indices)
    assert torch.equal(got.distances, ref.distances)


@pytest.mark.parametrize("kind", ["distance", "features"])
def test_select_chunked_knob_runs_bitwise(kind):
    """``select="chunked"`` plans on both kinds and gives the default
    plan's C bitwise on finite inputs, and the reference's C."""
    x = _input_for(kind, n=30, seed=4)
    run = pald.cohesion if kind == "distance" else pald.from_features
    C = run(x, k=6, ties="ignore", device="cpu")
    p = pald.plan(x, kind=kind, k=6, ties="ignore", select="chunked",
                  device="cpu")
    assert p.explain()["select"] == "chunked"
    assert torch.equal(p.execute(x), C)
    Cj = np.asarray(jpald.plan(jnp.asarray(x), kind=kind, k=6, ties="ignore",
                               select="chunked").execute(jnp.asarray(x)))
    np.testing.assert_allclose(C.numpy(), Cj, rtol=RTOL, atol=ATOL)


def test_select_on_distances_takes_only_chunked():
    D = _D()
    for select in ("cuda", "torch"):
        with pytest.raises(ValueError, match="chunked"):
            pald.plan(D, k=3, select=select, device="cpu")
    with pytest.raises(ValueError, match="unknown select"):
        pald.plan(_X(), kind="features", k=3, select="pallas", device="cpu")


# ---------------------------------------------------------------------------
# the plan's provenance (tests/test_engine.py:52-110), against the
# reference's plans; each test's caches are private and cold
# ---------------------------------------------------------------------------
@pytest.fixture
def cold_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    return tmp_path


def _both(D, **knobs):
    """(port explain, reference explain) of one knob set."""
    return (pald.plan(D, device="cpu", **knobs).explain(),
            jpald.plan(jnp.asarray(D), **knobs).explain())


def test_plan_auto_resolves_method_and_records_provenance(cold_caches):
    D = _D(n=12)
    p, jp = _both(D, method="auto")
    assert p["method"] in ("dense", "pairwise", "triplet", "kernel")
    assert (p["method"], p["method_source"]) == (jp["method"],
                                                 jp["method_source"])
    assert p["method_source"] == "heuristic"
    pt, jpt = _both(D, schedule="tri")
    assert pt["method"] == "kernel" and pt["method_source"] == "schedule=tri"
    assert (pt["method"], pt["method_source"]) == (jpt["method"],
                                                   jpt["method_source"])
    pe, _ = _both(D, method="triplet", block=8)
    assert pe["method_source"] == "explicit"
    assert pe["block_source"] == "explicit"
    pa, jpa = _both(D, method="triplet", block="auto")
    assert pa["block_source"] == jpa["block_source"] == "default"
    assert pa["block"] == jpa["block"]
    # a measured crossover of this device wins over the heuristic
    faults.write_cache(str(cold_caches / "port.json"),
                       {"cpu|-|12|method": {"method": "pairwise"}})
    pm = pald.plan(D, device="cpu").explain()
    assert (pm["method"], pm["method_source"]) == (
        "pairwise", "cache:cpu|-|12|method")
    pn = pald.plan(_D(n=20), device="cpu").explain()
    assert pn["method_source"] == "nearest:cpu|-|12|method"


def test_explain_contract(cold_caches):
    D = _D(n=12)
    p = pald.plan(D, method="kernel", schedule="tri", block=8, block_z=8,
                  device="cpu")
    info = p.explain()
    for key in ("kind", "method", "schedule", "impl", "block", "block_z",
                "ties", "normalize", "n", "padded_n", "padded_shape",
                "method_source", "block_source", "select_block",
                "select_tile", "select_source", "executor",
                "est_smem_bytes_per_cta"):
        assert key in info, key
    assert info["method"] == "kernel" and info["schedule"] == "tri"
    assert info["padded_n"] % 8 == 0
    assert info["executor"].startswith("repro_torch.kernels.ops.")
    assert info["est_smem_bytes_per_cta"] > 0
    assert info["select_source"] == "n/a"
    pf = pald.plan(n=32, d=4, kind="features", device="cpu")
    assert pf.explain()["padded_shape"][1] == 4


def test_auto_method_pinned_by_path_specific_knobs(cold_caches):
    """With method='auto', a dense-only or kernel-only knob pins the
    method; "auto" tiles do not, and go through the measured crossover."""
    D = _D(n=12)
    p = pald.plan(D, z_chunk=4, device="cpu")
    assert p.method == "dense" and p.method_source == "z_chunk"
    assert p.z_chunk == 4
    p = pald.plan(D, impl="torch", device="cpu")
    assert p.method == "kernel" and p.method_source == "impl/block_z"
    p = pald.plan(D, block_z=8, device="cpu")
    assert p.method == "kernel" and p.block_z == 8
    with pytest.raises(ValueError, match="explicit method"):
        pald.plan(D, z_chunk=4, impl="torch", device="cpu")
    p, jp = _both(D, block="auto", block_z="auto")
    assert p["method_source"] == jp["method_source"] == "heuristic"
    assert (p["method"], p["block"], p["block_z"]) == (
        jp["method"], jp["block"], jp["block_z"])


def test_block_z_auto_resolves_to_no_tile_on_blocked_paths(cold_caches):
    """block_z='auto' on pairwise / triplet / dense is "no z tile" (None,
    no z provenance); an explicit int stays an error."""
    D = _D(n=12)
    for method in ("pairwise", "triplet"):
        p, jp = _both(D, method=method, block=8, block_z="auto")
        assert p["block_z"] is None and "z:" not in p["block_source"]
        assert (p["block_z"], p["block_source"]) == (jp["block_z"],
                                                     jp["block_source"])
        with pytest.raises(ValueError, match="block_z"):
            pald.plan(D, method=method, block_z=8, device="cpu")
    p = pald.plan(D, method="dense", block_z="auto", device="cpu")
    assert p.block_z is None


# ---------------------------------------------------------------------------
# corrupted tuning state: provenance changes, values never
# (tests/test_faults.py:433)
# ---------------------------------------------------------------------------
def test_corrupt_tuning_cache_changes_only_provenance(tmp_path, monkeypatch):
    cache = tmp_path / "blocktune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
    D = _D(n=20, seed=7)
    p_fresh = pald.plan(D, method="kernel", block="auto", device="cpu")
    baseline = p_fresh.execute(D)
    assert p_fresh.explain()["block_source"] == "default"

    # truncated JSON: quarantined at load, the same defaults, bitwise
    with faults.corrupt_tuning_cache() as p:
        assert p == str(cache)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            p_corrupt = pald.plan(D, method="kernel", block="auto",
                                  device="cpu")
        assert torch.equal(p_corrupt.execute(D), baseline)
        assert p_corrupt.explain()["block_source"] == "default"
        assert list(tmp_path.glob("*.corrupt-*")), "corrupt file not moved"
    assert not list(tmp_path.glob("*.corrupt-*"))  # the harness cleaned up

    # wrong-typed record: quarantined:<key>, the values unchanged
    bad = {"block": -8, "block_z": "nope"}
    faults.write_cache(str(cache), {"cpu|torch|20|pald": bad,
                                    "cpu|cuda|20|pald": bad})
    p_bad = pald.plan(D, method="kernel", block="auto", device="cpu")
    assert p_bad.explain()["block_source"] == "quarantined:cpu|torch|20|pald"
    assert torch.equal(p_bad.execute(D), baseline)
    # the reference's plan on the same records, renamed, agrees
    jcache = tmp_path / "ref.json"
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(jcache))
    jfaults.write_cache(str(jcache), {"cpu|jnp|20|pald": bad})
    jp = jpald.plan(jnp.asarray(D), method="kernel", block="auto")
    assert jp.explain()["block_source"] == "quarantined:cpu|jnp|20|pald"
    np.testing.assert_allclose(
        baseline.numpy(), np.asarray(jp.execute(jnp.asarray(D))),
        rtol=RTOL, atol=ATOL)


def test_a_cached_record_never_moves_a_plan_off_its_device(tmp_path,
                                                           monkeypatch):
    """A method record names a method, never a device or an impl: the
    plan keeps its device and the impl it asked for."""
    cache = tmp_path / "blocktune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(cache))
    faults.write_cache(str(cache), {
        "cpu|-|17|method": {"method": "kernel"},
        "cpu|torch|17|pald": {"block": 8, "block_z": 16}})
    p = pald.plan(_D(), device="cpu")
    assert (p.method, p.impl, p.device.type) == ("kernel", "torch", "cpu")
    assert p.method_source == "cache:cpu|-|17|method"
    pc = pald.plan(_D(), device="cpu", impl="cuda", block="auto")
    assert pc.impl == "cuda" and pc.block_source == "default"  # no cuda key

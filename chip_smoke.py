#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PaLD on one NVIDIA GPU and check it.

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc`` (timed);
2. each kernel against its plain torch version on the card, for every
   built-in weight functional, at a ragged square n = 257 and a
   rectangular (mx, my, mz) = (96, 160, 224) with asymmetric, tie-heavy
   inputs holding +inf entries; ``ignore`` through both tiebreak routes;
3. the main path at full size: ``pald.cohesion(D, method="kernel")`` on a
   clustered n = 8192, d = 8 point set, with the launch counters as proof
   that both kernels ran and no plain version did; mass conservation, a
   64-row slab recomputed by the plain versions, community recovery;
4. each kernel and its plain version timed at n = 8192 (CUDA events,
   median after a warm-up), beside the kernel's bound;
5. the kernels of every built-in weight family timed at n = 8192;
6. the fused features kernels (``pald_fused.cu``) against their plain
   versions on the card: four metrics x five families at a ragged n = 257
   and d in {1, 5, 300} on quantized features with duplicated rows; their
   distances bitwise against ``cdist_reference``, their U bitwise against
   the dense kernels' on the same distances;
7. the second main path at full size: ``pald.from_features(X)`` with every
   knob at its default (euclidean, ``ties="drop"``, ``method="auto"`` ->
   fused) on a clustered n = 8192, d = 64 point set, with the launch
   counters as proof that the fused kernels ran once each and neither the
   dense kernels nor any plain version did; mass, a 64-row slab, community
   recovery, and peak device memory at least one n^2 float32 buffer below
   the materialize-then-kernel path's;
8. the fused kernels and their plain versions timed at n = 8192, d = 64,
   and ``from_features`` end to end, fused against materialize-then-kernel,
   for all four metrics (CUDA events, median after a warm-up).

The line before the last is one JSON object with the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.  Without a GPU the script
fails before printing any result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

N_MAIN = 8192          # the dense methods' size in benchmarks/run.py
D_MAIN = 8
D_FUSED = 64           # the embedding width of examples/pald_text_analysis.py
METRICS = ("sqeuclidean", "euclidean", "cosine", "manhattan")
SLAB = 64
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_LANES = 128 * 132      # FP32 lanes per SM x SMs of an H100 SXM
# lane instructions per (x, y, z) triple that each pass needs at least:
# focus = min + compare + add; cohesion = two compares + tie term + add
OPS_PER_TRIPLE = {"focus": 3, "cohesion": 4}
RTOL, ATOL = 1e-5, 1e-6            # the conformance tolerance
# at n = 8192 a C entry is a sum of up to n positive float32 terms taken in
# another order than the plain version's, so the full-size check is looser
RTOL_MAIN = 1e-4


def fail(msg: str) -> None:
    raise AssertionError(msg)


def smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of ``nvidia-smi --query-gpu=<query>`` (card 0)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          f"--format={fmt}"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(name, got, want, exact, rtol=RTOL, atol=ATOL) -> float:
    """Hold a kernel result against its plain version; return max |err|."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    if exact:
        if not torch.equal(got, want):
            fail(f"{name}: not bitwise equal (max |err| {err!r})")
    elif not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: max |err| {err!r} beyond rtol {rtol}, atol {atol}")
    return err


def functionals():
    from repro_torch.core.weights import (DROP, IGNORE, SPLIT, kernelized,
                                          soft_threshold)

    return [DROP, SPLIT, IGNORE, soft_threshold(), kernelized()]


def exact_focus(w) -> bool:
    """U is an exact count (integers or halves) unless the focus is smooth."""
    return not w.name.startswith("soft")


def quantized_distances(rng, n, dev):
    import torch

    X = rng.integers(0, 6, size=(n, 3)).astype(np.float64)
    D = np.sqrt(((X[:, None, :] - X[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(D, 0.0)
    return torch.as_tensor(D, dtype=torch.float32, device=dev)


def phase_kernels_vs_plain(dev) -> None:
    """Phase 2: every functional, square and rectangular, both routes."""
    import torch
    from repro_torch.core.weights import index_xwins
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    rng = np.random.default_rng(SEED)
    n = 257
    D = quantized_distances(rng, n, dev)
    mx, my, mz = 96, 160, 224

    def rect(shape):
        a = rng.integers(0, 8, size=shape).astype(np.float32) * 0.5
        a[rng.random(shape) < 0.03] = np.inf
        return torch.as_tensor(a, device=dev)

    DXZ, DYZ, DXY = rect((mx, mz)), rect((my, mz)), rect((mx, my))
    Wr = torch.as_tensor(rng.random((mx, my)).astype(np.float32), device=dev)
    XWr = torch.as_tensor(rng.random((mx, my)) < 0.5, device=dev)
    offs = (37, 5)
    checked = 0
    for w in functionals():
        kw = dict(ties=w)
        Uk = ops.focus_general(D, D, D, impl="cuda", **kw)
        Up = ops.focus_general(D, D, D, impl="torch", **kw)
        compare(f"focus {w.name} n={n}", Uk, Up, exact_focus(w))
        W = weights_ref(Up)
        routes = ([dict(xw_offsets=(0, 0)),
                   dict(xwins=index_xwins(0, n, 0, n, device=dev))]
                  if w.needs_index_tiebreak else [{}])
        for r in routes:
            Ck = ops.cohesion_general(D, D, D, W, impl="cuda", **kw, **r)
            Cp = ops.cohesion_general(D, D, D, W, impl="torch", **kw, **r)
            compare(f"cohesion {w.name} n={n} {sorted(r)}", Ck, Cp, False)
            checked += 1
        Uk = ops.focus_general(DXZ, DYZ, DXY, impl="cuda", **kw)
        Up = ops.focus_general(DXZ, DYZ, DXY, impl="torch", **kw)
        compare(f"focus {w.name} {(mx, my, mz)}", Uk, Up, exact_focus(w))
        routes = ([dict(xw_offsets=offs), dict(xwins=XWr)]
                  if w.needs_index_tiebreak else [{}])
        for r in routes:
            Ck = ops.cohesion_general(DXZ, DYZ, DXY, Wr, impl="cuda", **kw, **r)
            Cp = ops.cohesion_general(DXZ, DYZ, DXY, Wr, impl="torch", **kw,
                                      **r)
            compare(f"cohesion {w.name} {(mx, my, mz)} {sorted(r)}", Ck, Cp,
                    False)
            checked += 1
        checked += 2
    torch.cuda.synchronize()
    print(f"phase 2: {checked} kernel-vs-plain checks passed (U bitwise "
          f"except soft; soft U and every C within rtol {RTOL}, atol {ATOL})")


def clustered_points(n, d, seed):
    """Four planted, well-separated clusters of very different scales."""
    rng = np.random.default_rng(seed)
    sizes = [n // 8, n // 4, n // 4, n - n // 8 - 2 * (n // 4)]
    scales = [0.05, 0.5, 2.0, 8.0]
    centers = np.zeros((4, d))
    centers[:, 0] = [0.0, 100.0, 300.0, 700.0]
    X = np.concatenate([rng.normal(size=(s, d)) * sc + c
                        for s, sc, c in zip(sizes, scales, centers)])
    labels = np.repeat(np.arange(4), sizes)
    return X.astype(np.float32), labels


def distances_on_device(X):
    """Euclidean D by the difference formula in row chunks: bitwise
    symmetric (the same ops in the same order for (i, j) and (j, i)) with
    an exactly-zero diagonal.  torch.cdist's matmul mode is neither."""
    import torch

    n, d = X.shape
    D = torch.empty((n, n), dtype=torch.float32, device=X.device)
    for s in range(0, n, 512):
        diff = X[s:s + 512, None, :] - X[None, :, :]
        sq = diff * diff
        acc = sq[..., 0]
        for k in range(1, d):
            acc = acc + sq[..., k]
        D[s:s + 512] = torch.sqrt(acc)
    return D


def phase_main_path(dev, n=N_MAIN, d=D_MAIN):
    """Phase 3: the user's entry point at full size, through both kernels."""
    import torch
    from repro_torch.core import analysis, pald
    from repro_torch.kernels import ops, pald_cohesion, pald_focus

    X, labels = clustered_points(n, d, SEED)
    D = distances_on_device(torch.as_tensor(X, device=dev))
    if not torch.equal(D, D.T) or bool((torch.diagonal(D) != 0).any()):
        fail("D is not bitwise symmetric with a zero diagonal")

    def plain_called(*a, **k):
        fail("a plain torch version ran on the main path")

    patched = [(ops, "focus_general_torch"), (ops, "cohesion_general_torch"),
               (pald_focus, "focus_general_torch"),
               (pald_cohesion, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    for m, a in patched:
        setattr(m, a, plain_called)
    kernels = (pald_focus.focus_general_cuda,
               pald_cohesion.cohesion_general_cuda)
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        C = pald.cohesion(D, method="kernel", ties="ignore")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"focus": kernels[0].launches,
                    "cohesion": kernels[1].launches}
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)
    print(f"phase 3: cohesion(D, method='kernel', ties='ignore') n={n} "
          f"d={d}: {secs:.3f} s wall (first call), launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    if C.shape != (n, n) or C.dtype != torch.float32 or C.device != D.device:
        fail(f"C is {tuple(C.shape)} {C.dtype} on {C.device}")
    if not bool(torch.isfinite(C).all()):
        fail("C has non-finite values")
    mass = float(C.double().sum())
    if abs(mass - n / 2) > 1e-4 * n / 2:
        fail(f"mass {mass!r} != n/2 = {n / 2}")
    print(f"phase 3: mass sum(C) = {mass!r} (n/2 = {n / 2})")

    # a contiguous row slab, not tile-aligned, recomputed by the plain
    # versions through the rectangular forms with global offsets
    r0 = min(3001, n - SLAB)
    rows = D[r0:r0 + SLAB]
    U_slab = ops.focus_general(rows, D, D[r0:r0 + SLAB], impl="torch",
                               ties="ignore")
    zero = U_slab == 0
    W_slab = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, U_slab))
    diag = torch.arange(SLAB, device=dev)
    W_slab[diag, r0 + diag] = 0.0
    C_slab = ops.cohesion_general(rows, D, D[r0:r0 + SLAB], W_slab,
                                  impl="torch", ties="ignore",
                                  xw_offsets=(r0, 0)) / (n - 1)
    compare(f"C rows {r0}:{r0 + SLAB}", C[r0:r0 + SLAB], C_slab, False,
            rtol=RTOL_MAIN)
    # the same float32 terms summed in float64: how far each float32 sum
    # order drifts; the kernel's two-level sum is held to the conformance
    # tolerance against it
    C64 = cohesion_slab_f64(rows, D, W_slab, r0) / (n - 1)
    rel = {k: float(((v.double() - C64).abs() / C64.abs().clamp_min(1e-300))
                    .max()) for k, v in (("kernel", C[r0:r0 + SLAB]),
                                         ("plain", C_slab))}
    print(f"phase 3: C rows {r0}:{r0 + SLAB} against a float64 sum of the "
          f"same terms: max relative error kernel {rel['kernel']!r}, plain "
          f"{rel['plain']!r}")
    compare(f"C rows {r0}:{r0 + SLAB} vs float64", C[r0:r0 + SLAB].double(),
            C64, False)

    comms = analysis.communities(C.cpu().numpy())
    mixed = [c for c in comms if len(set(labels[c].tolist())) > 1]
    if mixed:
        fail(f"{len(mixed)} communities span planted clusters")
    sizes = np.bincount(labels)
    largest = [max((len(c) for c in comms if labels[c[0]] == k), default=0)
               for k in range(len(sizes))]
    print(f"phase 3: {len(comms)} communities, each inside one planted "
          f"cluster; largest per cluster {largest} of {sizes.tolist()}")
    if any(2 * big < size for big, size in zip(largest, sizes)):
        fail("a planted cluster is not recovered: its largest community "
             "holds less than half of it")
    return D, launches, U_slab, r0


def cohesion_slab_f64(rows, D, W_slab, r0, chunk=64, ties="ignore"):
    """Un-normalized C[r0:r0+m] with the float32 support terms accumulated
    in float64."""
    import torch
    from repro_torch.core.weights import index_xwins, support_weight

    m, n = rows.shape
    C = torch.zeros((m, n), dtype=torch.float64, device=rows.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        own = index_xwins(r0, m, s, e - s, device=rows.device)[:, :, None]
        g = support_weight(rows[:, None, :], D[None, s:e, :],
                           rows[:, s:e, None], ties, own)
        C += torch.einsum("xyz,xy->xz", g.double(), W_slab[:, s:e].double())
    return C


def time_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def bound_ms(pass_, mx, my, mz, clock_mhz):
    """Least time for the pass's work: the larger of its bytes (each input
    read once, the output written once) over HBM bandwidth and its lane
    instructions over the FP32 lanes at the card's maximum SM clock."""
    if pass_ == "focus":
        nbytes = 4 * (mx * mz + my * mz + mx * my + mx * my)
    else:
        nbytes = 4 * (mx * mz + my * mz + 2 * mx * my + mx * mz)
    ops = OPS_PER_TRIPLE[pass_] * mx * my * mz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def phase_timing(D, launches, U_slab, r0, clock_mhz, reps=5):
    """Phase 4: kernel and plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    n = D.shape[0]
    src = {"focus": ("src/repro_torch/csrc/pald_focus.cu",
                     "src/repro/kernels/pald_focus.py:55"),
           "cohesion": ("src/repro_torch/csrc/pald_cohesion.cu",
                        "src/repro/kernels/pald_cohesion.py:134")}

    def timed(name, kernel, plain):
        ms_k, out_k = time_ms(kernel, reps)
        ms_p, out_p = time_ms(plain, reps)
        b_ms, b_by = bound_ms(name, n, n, n, clock_mhz)
        print(f"phase 4: {name} n={n}: kernel {ms_k!r} ms, plain {ms_p!r} "
              f"ms, bound {b_ms!r} ms ({b_by}; {OPS_PER_TRIPLE[name]} lane "
              f"instr/triple at {clock_mhz} MHz), kernel/bound "
              f"{ms_k / b_ms:.3f}, library: none")
        row = {"name": f"{name}_general", "route": "cuda",
               "source": src[name][0], "replaces": src[name][1],
               "launches": launches[name], "max_abs_err": None,
               "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        return row, out_k, out_p

    focus_row, Uk, Up = timed(
        "focus", lambda: ops.focus(D, impl="cuda", ties="ignore"),
        lambda: ops.focus(D, impl="torch", ties="ignore"))
    focus_row["max_abs_err"] = compare(f"focus n={n}", Uk, Up, True)
    compare(f"U rows {r0}:{r0 + SLAB}", Uk[r0:r0 + SLAB], U_slab, True)
    W = weights_ref(Uk)
    coh_row, Ck, Cp = timed(
        "cohesion",
        lambda: ops.cohesion_from_weights(D, W, impl="cuda", ties="ignore"),
        lambda: ops.cohesion_from_weights(D, W, impl="torch", ties="ignore"))
    coh_row["max_abs_err"] = compare(f"cohesion n={n}", Ck, Cp, False,
                                     rtol=RTOL_MAIN)
    return [focus_row, coh_row]


def phase_families(D, reps=3):
    """Phase 5: every built-in family's kernels at the main path's size
    (kernel times only; the main path runs ``ignore``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import weights_ref

    n = D.shape[0]
    for w in functionals():
        ms_f, U = time_ms(lambda: ops.focus(D, impl="cuda", ties=w), reps)
        W = weights_ref(U)
        ms_c, _ = time_ms(lambda: ops.cohesion_from_weights(
            D, W, impl="cuda", ties=w), reps)
        print(f"phase 5: {w.name} n={n}: focus kernel {ms_f!r} ms, cohesion "
              f"kernel {ms_c!r} ms (median of {reps})")


def fused_features(rng, n, d, dev):
    """Features quantized to 0.1 (rounded products and sums, exact ties),
    every fifth row a duplicate of an earlier one; no +inf."""
    import torch

    X = np.round(rng.normal(size=(n, d)) * 10) / 10
    dup = np.arange(5, n, 5)
    X[dup] = X[rng.integers(0, 5, size=dup.size)]
    return torch.as_tensor(X.astype(np.float32), device=dev)


def phase_fused_vs_plain(dev) -> None:
    """Phase 6: the fused kernels against their plain versions and against
    the dense kernels on the same distances."""
    import torch
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_fused
    from repro_torch.kernels.ref import weights_ref

    rng = np.random.default_rng(SEED + 6)
    n = 257
    checked = 0
    c_bitwise = c_total = 0
    for d in (1, 5, 300):
        X = fused_features(rng, n, d, dev)
        for metric in METRICS:
            D = cdist_reference(X, metric=metric)
            compare(f"fused distances {metric} d={d}",
                    pald_fused.dist_fused_cuda(X, metric=metric), D, True)
            checked += 1
            for w in functionals():
                kw = dict(metric=metric, ties=w)
                tag = f"{w.name} {metric} n={n} d={d}"
                Uk = pald_fused.focus_fused_cuda(X, **kw)
                Up = pald_fused.focus_fused_torch(X, **kw)
                compare(f"focus_fused {tag}", Uk, Up, exact_focus(w))
                W = weights_ref(Up)
                Ck = pald_fused.cohesion_fused_cuda(X, W, **kw)
                Cp = pald_fused.cohesion_fused_torch(X, W, **kw)
                compare(f"cohesion_fused {tag}", Ck, Cp, False)
                # the dense kernels on the same distances: the same loops
                Ud = ops.focus(D, impl="cuda", ties=w)
                compare(f"focus_fused vs dense {tag}", Uk, Ud,
                        exact_focus(w))
                Cd = ops.cohesion_from_weights(D, W, impl="cuda", ties=w)
                compare(f"cohesion_fused vs dense {tag}", Ck, Cd, False)
                c_bitwise += bool(torch.equal(Ck, Cd))
                c_total += 1
                checked += 4
    torch.cuda.synchronize()
    print(f"phase 6: {checked} fused checks passed (distances bitwise; U "
          f"bitwise except soft against the plain versions and the dense "
          f"kernels; C within rtol {RTOL}, atol {ATOL}); C bitwise equal to "
          f"the dense kernels' in {c_bitwise} of {c_total} cases")


def phase_fused_main_path(dev, n=N_MAIN, d=D_FUSED):
    """Phase 7: ``pald.from_features(X)`` at full size, default knobs."""
    import torch
    from repro_torch.core import analysis, pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import (ops, pald_cohesion, pald_focus,
                                     pald_fused)

    X, labels = clustered_points(n, d, SEED)
    Xg = torch.as_tensor(X, device=dev)

    def plain_called(*a, **k):
        fail("a plain torch version ran on the fused main path")

    patched = [(ops, "focus_fused_torch"), (ops, "cohesion_fused_torch"),
               (pald_fused, "focus_fused_torch"),
               (pald_fused, "cohesion_fused_torch"),
               (ops, "focus_general_torch"), (ops, "cohesion_general_torch"),
               (pald_focus, "focus_general_torch"),
               (pald_cohesion, "cohesion_general_torch")]
    saved = [getattr(m, a) for m, a in patched]
    for m, a in patched:
        setattr(m, a, plain_called)
    counted = {"focus_fused": pald_fused.focus_fused_cuda,
               "cohesion_fused": pald_fused.cohesion_fused_cuda,
               "focus_general": pald_focus.focus_general_cuda,
               "cohesion_general": pald_cohesion.cohesion_general_cuda}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in counted.values():
            k.launches = 0
        t0 = time.perf_counter()
        C = pald.from_features(Xg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: k.launches for name, k in counted.items()}
        peak_fused = torch.cuda.max_memory_allocated() - base
    finally:
        for (m, a), f in zip(patched, saved):
            setattr(m, a, f)
    print(f"phase 7: from_features(X) n={n} d={d} (euclidean, drop, auto -> "
          f"fused): {secs:.3f} s wall (first call), launches {launches}")
    if launches["focus_fused"] != 1 or launches["cohesion_fused"] != 1:
        fail(f"the fused kernels did not run once each: {launches}")
    if launches["focus_general"] or launches["cohesion_general"]:
        fail(f"a dense kernel ran on the fused path: {launches}")
    if C.shape != (n, n) or C.dtype != torch.float32 or C.device != Xg.device:
        fail(f"C is {tuple(C.shape)} {C.dtype} on {C.device}")
    if not bool(torch.isfinite(C).all()):
        fail("C has non-finite values")
    mass = float(C.double().sum())
    if abs(mass - n / 2) > 1e-4 * n / 2:
        fail(f"mass {mass!r} != n/2 = {n / 2}")
    print(f"phase 7: mass sum(C) = {mass!r} (n/2 = {n / 2})")

    # the same call through materialize-then-kernel: D is an extra buffer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    Cm = pald.from_features(Xg, method="kernel")
    torch.cuda.synchronize()
    peak_kernel = torch.cuda.max_memory_allocated() - base
    buf = 4 * n * n
    print(f"phase 7: peak device memory above the input: fused "
          f"{peak_fused} B ({peak_fused / buf:.3f} n^2 float32 buffers), "
          f"materialize-then-kernel {peak_kernel} B "
          f"({peak_kernel / buf:.3f}); difference "
          f"{(peak_kernel - peak_fused) / buf:.3f} buffers")
    if peak_kernel - peak_fused < buf:
        fail("the fused path's peak memory is not one n^2 float32 buffer "
             "below the materialize-then-kernel path's")
    compare("C fused vs materialize-then-kernel", C, Cm, False,
            rtol=RTOL_MAIN)
    print(f"phase 7: C fused bitwise equal to materialize-then-kernel: "
          f"{bool(torch.equal(C, Cm))}")
    del Cm

    # a contiguous row slab, not tile-aligned, by the plain versions on the
    # materialized distances (bitwise the kernels' own)
    D = cdist_reference(Xg)
    r0 = min(3001, n - SLAB)
    rows = D[r0:r0 + SLAB]
    U_slab = ops.focus_general(rows, D, rows, impl="torch", ties="drop")
    zero = U_slab == 0
    W_slab = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, U_slab))
    diag = torch.arange(SLAB, device=dev)
    W_slab[diag, r0 + diag] = 0.0
    C_slab = ops.cohesion_general(rows, D, rows, W_slab, impl="torch",
                                  ties="drop") / (n - 1)
    compare(f"C rows {r0}:{r0 + SLAB}", C[r0:r0 + SLAB], C_slab, False,
            rtol=RTOL_MAIN)
    C64 = cohesion_slab_f64(rows, D, W_slab, r0, ties="drop") / (n - 1)
    rel = {k: float(((v.double() - C64).abs() / C64.abs().clamp_min(1e-300))
                    .max()) for k, v in (("kernel", C[r0:r0 + SLAB]),
                                         ("plain", C_slab))}
    print(f"phase 7: C rows {r0}:{r0 + SLAB} against a float64 sum of the "
          f"same terms: max relative error kernel {rel['kernel']!r}, plain "
          f"{rel['plain']!r}")
    compare(f"C rows {r0}:{r0 + SLAB} vs float64", C[r0:r0 + SLAB].double(),
            C64, False)

    comms = analysis.communities(C.cpu().numpy())
    mixed = [c for c in comms if len(set(labels[c].tolist())) > 1]
    if mixed:
        fail(f"{len(mixed)} communities span planted clusters")
    sizes = np.bincount(labels)
    largest = [max((len(c) for c in comms if labels[c[0]] == k), default=0)
               for k in range(len(sizes))]
    print(f"phase 7: {len(comms)} communities, each inside one planted "
          f"cluster; largest per cluster {largest} of {sizes.tolist()}")
    if any(2 * big < size for big, size in zip(largest, sizes)):
        fail("a planted cluster is not recovered: its largest community "
             "holds less than half of it")
    return Xg, D, launches


def fused_bound_ms(pass_, n, d, clock_mhz):
    """Least time for a fused pass: the larger of its bytes (X and, for
    cohesion, W read once, the output written once) over HBM bandwidth and
    its lane instructions (the triple loop's, plus the distance work
    n^2 (2d + 4) counted once) over the FP32 lanes at the maximum clock."""
    nbytes = 4 * (n * d + n * n + (n * n if pass_ == "cohesion" else 0))
    ops = OPS_PER_TRIPLE[pass_] * n ** 3 + n * n * (2 * d + 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (FP32_LANES * clock_mhz * 1e6)
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def phase_fused_timing(Xg, D, launches, clock_mhz, reps=5):
    """Phase 8: the fused kernels and their plain versions at the main
    path's shapes, then from_features end to end for every metric, fused
    against materialize-then-kernel."""
    import torch
    from repro_torch.core import pald
    from repro_torch.core.features import cdist_reference
    from repro_torch.kernels import ops, pald_fused
    from repro_torch.kernels.ref import weights_ref

    n, d = Xg.shape
    replaces = {"focus": "src/repro/kernels/pald_fused.py:71",
                "cohesion": "src/repro/kernels/pald_fused.py:144"}
    rows = []

    def timed(name, kernel, plain):
        ms_k, out_k = time_ms(kernel, reps)
        ms_p, out_p = time_ms(plain, 1)
        b_ms, b_by = fused_bound_ms(name, n, d, clock_mhz)
        print(f"phase 8: {name}_fused n={n} d={d}: kernel {ms_k!r} ms, plain "
              f"{ms_p!r} ms, bound {b_ms!r} ms ({b_by}), kernel/bound "
              f"{ms_k / b_ms:.3f}, library: none")
        rows.append({"name": f"{name}_fused", "route": "cuda",
                     "source": "src/repro_torch/csrc/pald_fused.cu",
                     "replaces": replaces[name],
                     "launches": launches[f"{name}_fused"],
                     "max_abs_err": None, "ms": ms_k, "plain_ms": ms_p,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
        return out_k, out_p

    # the plain versions with (512, n) slabs: fewer, larger launches
    Uk, Up = timed("focus",
                   lambda: pald_fused.focus_fused_cuda(Xg, ties="drop"),
                   lambda: pald_fused.focus_fused_torch(Xg, block=512,
                                                        ties="drop"))
    rows[0]["max_abs_err"] = compare(f"focus_fused n={n}", Uk, Up, True)
    compare(f"focus_fused vs dense kernel n={n}", Uk,
            ops.focus(D, impl="cuda", ties="drop"), True)
    W = weights_ref(Uk)
    del Up
    Ck, Cp = timed("cohesion",
                   lambda: pald_fused.cohesion_fused_cuda(Xg, W, ties="drop"),
                   lambda: pald_fused.cohesion_fused_torch(Xg, W, block=512,
                                                           ties="drop"))
    rows[1]["max_abs_err"] = compare(f"cohesion_fused n={n}", Ck, Cp, False,
                                     rtol=RTOL_MAIN)
    del Uk, Ck, Cp, W

    ms_cd, _ = time_ms(lambda: cdist_reference(Xg), 3)
    print(f"phase 8: cdist_reference (plain torch, euclidean) n={n} d={d}: "
          f"{ms_cd!r} ms")
    for metric in METRICS:
        ms_f, _ = time_ms(lambda: pald_fused.focus_fused_cuda(
            Xg, metric=metric), 3)
        Wm = weights_ref(pald_fused.focus_fused_cuda(Xg, metric=metric))
        ms_c, _ = time_ms(lambda: pald_fused.cohesion_fused_cuda(
            Xg, Wm, metric=metric), 3)
        del Wm
        ms_e, _ = time_ms(lambda: pald.from_features(Xg, metric=metric), 3)
        ms_m, _ = time_ms(lambda: pald.from_features(
            Xg, metric=metric, method="kernel"), 3)
        print(f"phase 8: {metric} n={n} d={d}: focus_fused {ms_f!r} ms, "
              f"cohesion_fused {ms_c!r} ms; from_features end to end: fused "
              f"{ms_e!r} ms, materialize-then-kernel {ms_m!r} ms "
              f"(fused/materialize {ms_e / ms_m:.3f}; median of 3)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available; this script runs only on "
              "the card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm", "csv,noheader,nounits"))
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, max SM clock {clock_mhz} MHz")

    t0 = time.perf_counter()
    for symbol in _build.SIGNATURES:
        _build.load(symbol)
    print(f"phase 1: kernels built/loaded in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_kernels_vs_plain(dev)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    D, launches, U_slab, r0 = phase_main_path(dev)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels = phase_timing(D, launches, U_slab, r0, clock_mhz)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_families(D)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    del D, U_slab
    t0 = time.perf_counter()
    phase_fused_vs_plain(dev)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    Xg, D, launches = phase_fused_main_path(dev)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels += phase_fused_timing(Xg, D, launches, clock_mhz)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

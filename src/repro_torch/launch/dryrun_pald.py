"""Production-mesh dry run of the paper's own workload, distributed PaLD
(counterpart of ``repro.launch.dryrun_pald``).

The reference lowers and compiles the dense shard bodies of
``pald_distributed`` for n up to 10^5 points on the single-pod (16, 16)
and two-pod (2, 16, 16) TPU meshes, per strategy, and reads XLA's
analyses.  Here one rank of each cell is:

- **counted** (:func:`run_cell`, any device): its share of the dense
  operation count (:func:`pald_ops` over the ranks) over
  :data:`PEAK_OPS`, the bytes its kernel calls and weights step move
  (each operand read once, each output written once, every trip), its
  memory (the input block; the body's arrays alive at once, an upper
  bound), and its collectives by kind (:func:`body_collectives`: the
  analytic count of ``core/distributed.py``'s ``_allgather_body``,
  ``_ring_body`` and ``_2d_body``, which the tests hold to the recorder's
  count in a world of ranks) over the links their groups cross;
- **measured** with ``--device cuda``: the rank's inputs built at their
  post-collective shapes from ``--seed``, and its local work timed
  through the port's rectangular kernel entries
  (``pald_focus.focus_general_cuda``, ``pald_cohesion.cohesion_general_cuda``
  with the shard's ``xw_offsets``; CUDA events, median after a warm-up),
  one step of a loop multiplied by its trip count as the reference
  multiplies by ``trips``.

The sharded k-NN form (``--knn-k``) stays an analytic estimate
(:func:`knn_shard_estimate`), whose communication term is
``core/distributed_knn.comm_estimate``.  The rates are the cost module's
(``launch.cost_analysis``): :data:`PEAK_OPS`, float32 outside the tensor
cores (the PaLD passes are compares and adds, no matrix product), and
each collective over the slowest link its group crosses (NVLink within
an 8-card host, :data:`LINK_BYTES_PER_S`; the host network past it).

    python -m repro_torch.launch.dryrun_pald --n 102400 --mesh both
    python -m repro_torch.launch.dryrun_pald --n 100000 --knn-k 32
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import traceback

from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.cost_analysis import (LINK_BYTES_PER_S, PEAK_OPS,
                                              RATES_SOURCE, CollectiveStats,
                                              group_ranks, roofline_terms)
from repro_torch.launch.mesh import MeshSpec, production_spec

__all__ = ["PEAK_OPS", "LINK_BYTES_PER_S", "PEAK_SOURCE", "STRATEGIES",
           "pald_ops", "knn_pald_ops", "knn_shard_estimate", "geometry",
           "body_collectives", "run_cell", "main"]

PEAK_SOURCE = RATES_SOURCE
# a strip check's tolerance on C: a sum of up to n float32 terms taken in
# another order than the plain version's (U, a count, is held bitwise)
STRIP_RTOL, STRIP_ATOL = 1e-4, 1e-6
STRATEGIES = ("allgather", "ring", "2d", "2d+stream")


def pald_ops(n: int) -> float:
    """Branch-free dense-pairwise op count (compare + select + add), the
    reference's DESIGN.md section 7: pass 1 2 compares + 1 or + 1 add = 4,
    pass 2 2 compares + 1 and + 2 multiply-adds = 5 per (pair, z): ~9 n^3
    over the full cube (the regular dense form does n^3, not n^3/2)."""
    return 9.0 * n ** 3


def knn_pald_ops(n: int, k: int) -> float:
    """Sharded k-NN op count: selection scores every (row, candidate) pair
    (~3 ops a pair: difference, multiply-add, amortized compare) and the
    sparse cohesion runs the dense form's 9-op inner loop over (k+1)-cliques
    only: O(n k^2) instead of O(n^3)."""
    return 3.0 * n * n + 9.0 * n * (k + 1) ** 2


def knn_shard_estimate(n: int, d: int, k: int, *, strategy: str,
                       pr: int, pc: int, dtype_bytes: int = 4) -> dict:
    """Cost model of one mesh-sharded k-NN cell (no run needed).

    Communication is ``distributed_knn.comm_estimate``'s: every strategy
    moves O(n d) feature words a rank, never the O(n^2) distances.
    Compute is the selection term (n^2 d / p distance ops) and the sparse
    cohesion term (n k^2 / p), over :data:`PEAK_OPS`; the collective term
    is the received bytes over :data:`LINK_BYTES_PER_S`.
    """
    from repro_torch.core import distributed_knn as dknn

    p = pr * pc
    comm = dknn.comm_estimate(strategy, n=n, d=d, k=k, p=p, pr=pr, pc=pc)
    sel_ops = 3.0 * n * n * d / p
    coh_ops = 9.0 * n * (k + 1) ** 2 / p
    coll_bytes = comm["per_device_words"] * dtype_bytes
    terms = {
        "compute_s": (sel_ops + coh_ops) / PEAK_OPS,
        "collective_s": coll_bytes / LINK_BYTES_PER_S,
    }
    terms["bottleneck"] = max(
        ("compute_s", "collective_s"), key=lambda kk: terms[kk]
    ).removesuffix("_s")
    return {
        "workload": f"pald-knn-n{n}-k{k}", "strategy": comm["strategy"],
        "mesh": f"{pr}x{pc}", "chips": p, "status": "ok",
        "selection_ops_per_chip": sel_ops,
        "cohesion_ops_per_chip": coh_ops,
        "comm": comm,
        "coll_bytes_per_chip": coll_bytes,
        "roofline": terms,
        "rates": PEAK_SOURCE,
    }


# ---------------------------------------------------------------------------
# the dense shard bodies: one rank's geometry, collectives and kernel calls
# ---------------------------------------------------------------------------
def geometry(strategy: str, n: int, mesh: MeshSpec) -> dict:
    """One rank's shapes in ``core/distributed.py``'s body of ``strategy``
    over ``mesh`` (rows over every dimension but the last, columns over
    the last; "2d+stream" streams the slab over ``pod``): the input block,
    the trips of each pass's loop, and the (mx, my, mz) of each trip's
    focus and cohesion kernel calls."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    p = math.prod(mesh.shape)
    if strategy in ("allgather", "ring"):
        if n % p:
            raise ValueError(f"n = {n} does not split over {p} ranks")
        m = n // p
        if strategy == "allgather":
            return {"block": (m, n), "trips": 1, "p": p, "m": m,
                    "focus": (m, n, n), "cohesion": (m, n, n)}
        return {"block": (m, n), "trips": p, "p": p, "m": m,
                "focus": (m, m, n), "cohesion": (m, m, n)}
    if strategy not in ("2d", "2d+stream"):
        raise ValueError(f"unknown strategy {strategy!r}")
    row_axes, col = mesh.axes[:-1], mesh.axes[-1]
    if not row_axes:
        raise ValueError("the 2d strategies need a mesh of >= 2 dimensions")
    stream = strategy == "2d+stream"
    if stream and "pod" not in row_axes:
        raise ValueError("2d+stream needs a 'pod' row dimension")
    pr, pc = math.prod(sizes[a] for a in row_axes), sizes[col]
    if n % pr or n % pc:
        raise ValueError(f"n = {n} does not split over ({pr}, {pc})")
    mr, mc = n // pr, n // pc
    steps = sizes["pod"] if stream else 1
    slab = n // steps
    return {"block": (mr, mc), "trips": steps, "p": p, "mr": mr, "mc": mc,
            "slab_rows": slab, "row_axes": row_axes, "col_axis": col,
            "gathered_rows": tuple(a for a in row_axes
                                   if not (stream and a == "pod")),
            "focus": (mr, mc, slab), "cohesion": (mr, slab, mc)}


def body_collectives(strategy: str, n: int, mesh: MeshSpec,
                     dtype_bytes: int = 4) -> CollectiveStats:
    """One rank's collectives in the body of ``strategy`` at n over
    ``mesh`` (D's elements ``dtype_bytes`` wide on the wire; U float32):
    allgather one all-gather of D's rows; ring 2 (p - 1) shifts of the row
    block; 2d the row-block and column-slab gathers and U's row gather,
    and with the pod stream 2 (pods - 1) shifts of the slab."""
    g = geometry(strategy, n, mesh)
    sizes = dict(zip(mesh.axes, mesh.shape))
    eb = dtype_bytes
    everyone = group_ranks(mesh, mesh.axes)
    stats = CollectiveStats()
    if strategy == "allgather":
        stats.add("all-gather", g["m"] * n * eb, n * n * eb, everyone)
        return stats
    if strategy == "ring":
        for _ in range(2 * (g["p"] - 1)):
            stats.add("collective-permute", g["m"] * n * eb,
                      g["m"] * n * eb, everyone)
        return stats
    mr, mc, col = g["mr"], g["mc"], g["col_axis"]
    cols = group_ranks(mesh, (col,))
    stats.add("all-gather", mr * mc * eb, mr * n * eb, cols)
    if g["gathered_rows"]:
        q = math.prod(sizes[a] for a in g["gathered_rows"])
        stats.add("all-gather", mr * mc * eb, q * mr * mc * eb,
                  group_ranks(mesh, g["gathered_rows"]))
    pods = group_ranks(mesh, ("pod",)) if g["trips"] > 1 else None
    for _ in range(2 * (g["trips"] - 1)):
        stats.add("collective-permute", g["slab_rows"] * mc * eb,
                  g["slab_rows"] * mc * eb, pods)
    stats.add("all-gather", mr * mc * 4, mr * n * 4, cols)
    return stats


def _kernel_bytes(g: dict) -> dict:
    """Bytes each pass's kernels move in one trip (each operand read
    once, the output written once; the cohesion's sum into C read and
    written again in the loops) and the weights step's."""
    mx, my, mz = g["focus"]
    focus = 4 * (mx * mz + my * mz + mx * my + mx * my)
    cx, cy, cz = g["cohesion"]
    coh = 4 * (cx * cz + cy * cz + 2 * cx * cy + cx * cz)
    if g["trips"] > 1:
        coh += 8 * cx * cz
    return {"focus": focus, "cohesion": coh}


def _arrays(strategy: str, n: int, g: dict, eb: int) -> dict:
    """{name: (shape, element bytes)}: the rank's input block ("D") and
    the arrays of the body alive at its peak, at their post-collective
    shapes (D's elements ``eb`` wide; a copy cast to float32 where D is
    narrower; kernel outputs "U" and "Cstep" one trip's)."""
    f32 = 4
    cast = eb != f32
    a: dict = {}
    if strategy == "allgather":
        m = g["m"]
        a = {"D": ((m, n), eb), "Dall": ((n, n), eb), "U": ((m, n), f32),
             "W": ((m, n), f32), "C": ((m, n), f32)}
        if cast:
            a.update(D32=((m, n), f32), Dall32=((n, n), f32))
    elif strategy == "ring":
        m = g["m"]
        a = {"D": ((m, n), eb), "blk": ((m, n), eb), "next": ((m, n), eb),
             "U": ((m, n), f32), "W": ((m, n), f32), "C": ((m, n), f32),
             "Cstep": ((m, n), f32)}
        if cast:
            a.update(D32=((m, n), f32), blk32=((m, n), f32))
    else:
        mr, mc, slab = g["mr"], g["mc"], g["slab_rows"]
        a = {"D": ((mr, mc), eb), "Grow": ((mr, n), f32),
             "slab": ((slab, mc), eb), "slabT32": ((mc, slab), f32),
             "U": ((mr, mc), f32), "Urow": ((mr, n), f32),
             "Wrow": ((mr, n), f32), "C": ((mr, mc), f32),
             "Cstep": ((mr, mc), f32)}
        if cast:
            a.update(D32=((mr, mc), f32), Grow_wire=((mr, n), eb),
                     slab32=((slab, mc), f32))
        if g["trips"] > 1:       # the pod stream: a slab in flight, slices
            a.update(next=((slab, mc), eb), DXZ=((mr, slab), f32),
                     Wstep=((mr, slab), f32))
    return a


def _memory(arrays: dict) -> dict:
    size = {k: math.prod(s) * b for k, (s, b) in arrays.items()}
    return {"argument_size_in_bytes": size["D"],
            "temp_size_in_bytes": sum(size.values()) - size["D"]}


def _strip(fn, args, rows: int, kw=None):
    """``fn`` on the first ``rows`` rows of x: the operands indexed by x
    (the first, the third and W) cut to them, the rest whole."""
    cut = [a[:rows] if i in (0, 2, 3) else a for i, a in enumerate(args)]
    return fn(*cut, **(kw or {}))


def _measure(strategy: str, n: int, g: dict, arrays: dict, *, device,
             seed: int, reps: int, check_rows: int = 0,
             guard=contextlib.nullcontext) -> dict:
    """One trip of each pass on the rank's arrays (:func:`_arrays`, made
    from ``seed`` in [0, 1)), timed through the kernel wrappers (the plain
    versions on the CPU) under ``guard()``; the card's peak of allocated
    memory above what was allocated before.  ``check_rows``: then hold
    the first rows of U and C, at the calls' full y and z, against the
    plain versions on the same operands (:data:`STRIP_RTOL`,
    :data:`STRIP_ATOL`; U bitwise)."""
    import torch

    from repro_torch.core.distributed import _weights_rows
    from repro_torch.kernels import pald_cohesion, pald_focus

    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.core.engine import resolve_device

        resolve_device(dev)
    dt = {4: torch.float32, 2: torch.bfloat16}
    # the outputs of the calls below; every other array made here
    made = {"allgather": {"U", "W", "C"}, "ring": {"Cstep"}}.get(
        strategy, {"U", "Cstep"})
    foc = pald_focus.focus_general_cuda
    cohesion = pald_cohesion.cohesion_general_cuda
    n_f, n_c = foc.launches, cohesion.launches
    with ca.peak_memory(dev) as peak:
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = {k: torch.rand(s, generator=gen, device=dev).to(dt[b])
             for k, (s, b) in arrays.items() if k not in made}
        f32 = {k: A.get(k + "32", A.get(k)) for k in ("D", "Dall", "blk",
                                                       "slab")}
        if strategy == "allgather":
            focus_args = (f32["D"], f32["Dall"], f32["D"])
            coh_args = (f32["D"], f32["Dall"], f32["D"])
            offsets = (g["m"], 0)            # the second rank's rows
        elif strategy == "ring":
            m = g["m"]
            dxy = f32["D"][:, m:2 * m].contiguous()
            focus_args = coh_args = (f32["D"], f32["blk"], dxy)
            offsets = (0, m)
        else:
            dxz = A.get("DXZ", A["Grow"])
            focus_args = (dxz, A["slabT32"], f32["D"])
            coh_args = (f32["D"], f32["slab"], dxz)
            offsets = (0, 0)
        with guard():
            U, focus_ms, _ = ca.timed(lambda: foc(*focus_args), dev, reps)
        if strategy == "allgather":
            W = _weights_rows(U, 0, None)
        elif strategy == "ring":           # a trip's columns of the rows' W
            W = A["W"][:, g["m"]:2 * g["m"]].contiguous()
        else:                              # a slab's columns of the rows' W
            W = A.get("Wstep", A["Wrow"])
        kw = {"xw_offsets": offsets}
        with guard():
            Cstep, coh_ms, _ = ca.timed(
                lambda: cohesion(*coh_args, W, **kw), dev, reps)
    out = {**ca.device_info(dev), "focus_ms": focus_ms,
           "cohesion_ms": coh_ms, "trips": g["trips"],
           "kernel_ms": g["trips"] * (focus_ms + coh_ms),
           "launches": {"focus": foc.launches - n_f,
                        "cohesion": cohesion.launches - n_c},
           "peak_bytes": peak.bytes}
    if not bool(torch.isfinite(Cstep).all()):   # after the peak: its temps
        raise FloatingPointError(f"{strategy}: non-finite C")
    if check_rows:
        r = min(check_rows, U.shape[0])
        Up = _strip(pald_focus.focus_general_torch, focus_args, r)
        Cp = _strip(pald_cohesion.cohesion_general_torch, coh_args + (W,),
                    r, kw)
        out["strip"] = {
            "rows": r, "focus_bitwise": bool(torch.equal(U[:r], Up)),
            "focus_max_abs_err": float((U[:r].double() - Up.double())
                                       .abs().max()),
            "cohesion_max_abs_err": float((Cstep[:r].double() - Cp.double())
                                          .abs().max()),
            "cohesion_within": bool(torch.allclose(
                Cstep[:r], Cp, rtol=STRIP_RTOL, atol=STRIP_ATOL)),
            "rtol": STRIP_RTOL, "atol": STRIP_ATOL}
        del Up, Cp
    del A, f32, U, W, Cstep, focus_args, coh_args
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run_cell(n: int, multi_pod: bool, strategy: str, *, dtype="float32",
             device="meta", seed: int = 0, reps: int = 1,
             check_rows: int = 0, guard=contextlib.nullcontext,
             verbose: bool = True) -> dict:
    """One rank of one dense cell (module docstring): counted, and with
    ``device`` "cuda" or "cpu" also measured (``check_rows``, ``guard``:
    :func:`_measure`'s)."""
    mesh = production_spec(multi_pod)
    chips = math.prod(mesh.shape)
    eb = {"float32": 4, "bfloat16": 2}[dtype]
    cell = {"workload": f"pald-n{n}", "strategy": strategy, "dtype": dtype,
            "mesh": "x".join(str(s) for s in mesh.shape), "chips": chips}
    g = geometry(strategy, n, mesh)
    arrays = _arrays(strategy, n, g, eb)
    coll = body_collectives(strategy, n, mesh, eb)
    kb = _kernel_bytes(g)
    rows = g["block"][0]
    cast = (eb != 4) * 6 * rows * g["block"][1]
    # the kernels every trip, W = 1/U over the rank's rows of U, the casts
    nbytes = g["trips"] * (kb["focus"] + kb["cohesion"]) + 8 * rows * n \
        + cast
    ops = pald_ops(n) / chips
    terms = roofline_terms(flops=ops, bytes_accessed=nbytes,
                           coll_s=coll.seconds, peak=PEAK_OPS)
    cell.update(
        status="ok",
        block=list(g["block"]),
        trips=g["trips"],
        kernel_calls={"focus": list(g["focus"]),
                      "cohesion": list(g["cohesion"])},
        pald_ops_per_chip=ops,
        bytes_per_rank=nbytes,
        coll_bytes_per_rank=coll.total_traffic,
        coll_by_kind=coll.as_dict(),
        memory_analysis=_memory(arrays),
        roofline=terms,
        collectives=coll.as_dict(),
        rates=PEAK_SOURCE,
    )
    if device != "meta":
        m = _measure(strategy, n, g, arrays, device=device, seed=seed,
                     reps=reps, check_rows=check_rows, guard=guard)
        ma = cell["memory_analysis"]
        est = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        m["peak_estimate_bytes"] = est
        if m["peak_bytes"] is not None:
            m["peak_ratio"] = m["peak_bytes"] / est
        cell["measured"] = m
    if verbose:
        ma = cell["memory_analysis"]
        tot = (ma["temp_size_in_bytes"] + ma["argument_size_in_bytes"]) / 2**30
        line = (f"  ok  bytes/rank {tot:6.2f} GiB  coll "
                f"{coll.total_traffic / 2**20:,.0f} MiB  compute "
                f"{terms['compute_s'] * 1e3:.1f} ms  coll_t "
                f"{terms['collective_s'] * 1e3:.1f} ms  bottleneck "
                f"{terms['bottleneck']}")
        if "measured" in cell:
            m = cell["measured"]
            line += (f"  kernels {m['kernel_ms']:.1f} ms ({m['trips']} x "
                     f"({m['focus_ms']:.2f} + {m['cohesion_ms']:.2f}))")
        print(line)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun_pald",
        description="per-rank costs of distributed PaLD on the production "
                    "meshes: the dense cells counted (and measured on the "
                    "card), or the sharded k-NN estimates")
    ap.add_argument("--n", type=int, default=102400)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both",
                    help="the reference's production meshes: 16x16, and "
                         "2x16x16 for two pods (32x16 for the k-NN "
                         "estimates)")
    ap.add_argument("--strategies", default=",".join(STRATEGIES))
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--out", default="build/dryrun_out_pald")
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "meta"),
                    help="meta: count only; cuda (default) / cpu: count "
                         "and time the rank's kernels")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--knn-k", type=int, default=None,
                    help="emit mesh-sharded k-NN estimates for this k "
                         "instead of the dense cells")
    ap.add_argument("--knn-d", type=int, default=64,
                    help="feature dim of the k-NN estimates")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    print(f"# rates: {PEAK_SOURCE}")
    if args.knn_k is not None:
        for multi in meshes:
            pr, pc = (32, 16) if multi else (16, 16)
            for strat in args.strategies.split(","):
                if strat == "2d+stream":
                    continue
                tag = (f"paldknn{args.n}k{args.knn_k}__{strat}"
                       f"__{'multi' if multi else 'single'}")
                cell = knn_shard_estimate(args.n, args.knn_d, args.knn_k,
                                          strategy=strat, pr=pr, pc=pc)
                print(json.dumps(cell))
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(cell, f, indent=1)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("[dryrun-pald] no CUDA GPU available; pass --device meta "
                  "(count only) or --device cpu", file=sys.stderr)
            return 2
    failures = 0
    for multi in meshes:
        for strat in args.strategies.split(","):
            if strat == "2d+stream" and not multi:
                continue
            tag = (f"pald{args.n}__{strat}__{'multi' if multi else 'single'}"
                   + ("__bf16" if args.dtype == "bfloat16" else ""))
            print(f"[dryrun-pald] {tag}")
            try:
                cell = run_cell(args.n, multi, strat, dtype=args.dtype,
                                device=args.device, seed=args.seed,
                                reps=args.reps)
            except Exception:  # noqa: BLE001 - recorded, exit code 1
                failures += 1
                cell = {"workload": tag, "status": "error",
                        "traceback": traceback.format_exc(limit=12)}
                print(cell["traceback"])
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(cell, f, indent=1)
    print(f"[dryrun-pald] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

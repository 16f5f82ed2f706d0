"""Command line of the port's tuner (counterpart of the reference's
``benchmarks/hillclimb.py``): measure on a device and persist the winners
in the tuning cache that ``block="auto"``, ``select_block`` /
``select_tile="auto"`` and ``method="auto"`` read, or climb one LM cell of
the dry run.

``cell`` (the default when no subcommand is named, as in the reference):
the dry run of one (arch, shape, mesh) cell (``launch.dryrun.run_cell``)
with config overrides (``--set field=value``, repeated; ``moe.top_k=2``
sets a nested field), and the roofline, memory and (measured) step-time
deltas against the baseline cell's JSON in ``--baseline-dir``;
``--save NAME`` writes the new cell there as ``<tag>__NAME.json``.

    python -m repro_torch.tuning.hillclimb cell --arch gemma2-2b \\
        --shape decode_32k --set remat=dots --device meta

``blocks``: the candidate grid of one (n, pass, impl) cell.  On
``--impl cuda`` the kernels' tiles are fixed, so ``pald`` / ``pald_tri``
sweep the engine's +inf pad (``--blocks``) and every other pass times one
candidate, the size-aware default.

    python -m repro_torch.tuning.hillclimb blocks \\
        --n 8000 --pass pald --impl cuda --blocks 64,128,256,512

``methods``: the method crossover (dense / pairwise / triplet) across n,
the per-n winner recorded for ``pald.cohesion(D)``'s default
``method="auto"``.

    python -m repro_torch.tuning.hillclimb methods --ns 64,256,1024

``topk``: the selection cell (``pald_topk:k<k>:d<d>``): the plain
selection's row slab (``--blocks``) against its tile-min prefilter width
(``--tiles``; a value >= n, or the word ``direct``, sorts whole rows).

    python -m repro_torch.tuning.hillclimb topk \\
        --n 4096 --d 8 --k 32 --impl torch --tiles 32,64,direct

``topk --p P`` (P > 1) tunes the mesh cell ``pald_topk:k<k>:d<d>:p<P>``:
a local world of P ranks on the device (``testing.world``), each timing
the sharded select->cohere on a (P,) mesh; rank 0 records the winner.

Every subcommand takes ``--device`` ("cuda" by default, "cpu"), ``--cache``
(default ``$REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_pald_torch/blocktune.json``), ``--iters`` and ``--budget``
(wall seconds for the sweep).  The records are keyed by the device's name,
so a cache measured on one card never steers another.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.tuning import autotune


SUBCOMMANDS = ("cell", "blocks", "methods", "topk")


def _csv_ints(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def parse_override(s: str):
    """``field=value``: True / False, an int, else the string."""
    k, v = s.split("=", 1)
    if v in ("True", "False"):
        return k, v == "True"
    try:
        return k, int(v)
    except ValueError:
        return k, v


def _overridden(cfg, overrides: dict):
    nested = {k: v for k, v in overrides.items() if "." in k}
    flat = {k: v for k, v in overrides.items() if "." not in k}
    for k, v in nested.items():
        outer, inner = k.split(".", 1)
        flat[outer] = dataclasses.replace(getattr(cfg, outer), **{inner: v})
    return dataclasses.replace(cfg, **flat)


def _mem_bytes(cell: dict) -> int:
    m = cell["memory_analysis"]
    return m.get("temp_size_in_bytes", 0) + m.get("argument_size_in_bytes", 0)


def run_cell(args) -> dict:
    from repro_torch import configs
    from repro_torch.launch import dryrun

    from repro_torch.configs.base import reduced

    overrides = dict(parse_override(s) for s in args.set)
    cfg = configs.get(args.arch)
    cfg = _overridden(reduced(cfg) if args.reduced else cfg, overrides)
    cell = dryrun.run_cell(args.arch, args.shape, args.mesh == "multi",
                           cfg=cfg, q_chunk=args.q_chunk,
                           microbatches=args.microbatches,
                           device=args.device)
    tag = dryrun.cell_tag(args.arch, args.shape, args.mesh == "multi")
    base_path = os.path.join(args.baseline_dir, tag + ".json")
    if os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        if base.get("status") == "ok" and cell.get("status") == "ok":
            print(f"\n=== delta vs baseline {base_path} ===")
            for k in ("compute_s", "memory_s", "collective_s"):
                b, n = base["roofline"][k], cell["roofline"][k]
                print(f"  {k:13s} {b * 1e3:12.2f} -> {n * 1e3:12.2f} ms "
                      f"({(b - n) / b * 100 if b else 0:+.1f}% less)")
            bb, nb = _mem_bytes(base), _mem_bytes(cell)
            print(f"  {'GiB/rank':13s} {bb / 2**30:12.2f} -> "
                  f"{nb / 2**30:12.2f}")
            print(f"  {'useful_ratio':13s} {base['useful_flop_ratio']:12.4f}"
                  f" -> {cell['useful_flop_ratio']:12.4f}")
            bm, nm = base.get("measured") or {}, cell.get("measured") or {}
            if bm.get("step_ms") is not None and nm.get("step_ms") is not None:
                print(f"  {'step_ms':13s} {bm['step_ms']:12.2f} -> "
                      f"{nm['step_ms']:12.2f} (measured)")
    else:
        print(f"# no baseline at {base_path}")
    if args.save:
        os.makedirs(args.baseline_dir, exist_ok=True)
        out = os.path.join(args.baseline_dir, f"{tag}__{args.save}.json")
        cell["overrides"] = overrides
        with open(out, "w") as f:
            json.dump(cell, f, indent=1)
        print(f"saved {out}")
    return cell


def _print_grid(rec: dict, label) -> None:
    for row in rec["grid"]:
        head = f"  block={row['block']:5d} {label(row):16s} "
        if "seconds" in row:
            mark = " <- best" if (row["block"], row["block_z"]) == (
                rec["block"], rec["block_z"]) else ""
            print(f"{head}{row['seconds'] * 1e3:10.3f} ms{mark}")
        elif row.get("failed"):
            print(f"{head}    FAILED: {row['error']}")
        else:
            print(f"{head}   skipped ({row['skipped']})")
    if rec.get("fixed_tiles"):
        print("  (the CUDA kernels' tiles are fixed: one candidate, the "
              "size-aware default)")


def run_blocks(args) -> None:
    from repro_torch.core.weights import resolve_weight

    kw = {}
    if args.blocks:
        kw["blocks"] = _csv_ints(args.blocks)
    if args.block_z:
        kw["blocks_z"] = _csv_ints(args.block_z)
    if getattr(args, "pass") == "pald_fused":
        kw["d"] = args.d
    if getattr(args, "pass") == "pald_knn":
        kw["k"] = args.k
    if args.weight and args.ties != "drop":
        raise SystemExit("--weight and --ties are contradictory; "
                         "--ties is sugar for the built-in modes")
    ties = resolve_weight(args.weight) if args.weight else args.ties
    rec = autotune.tune(
        args.n, getattr(args, "pass"), impl=args.impl, device=args.device,
        path=args.cache, iters=args.iters, ties=ties,
        time_budget=args.budget, **kw)
    print(f"# tuned {getattr(args, 'pass')} n={args.n} "
          f"impl={args.impl or 'default'} weight={args.weight or args.ties} "
          f"on {autotune.backend_of(args.device)}")

    def label(row):
        z = f"block_z={row['block_z']}"
        return f"{z} padded_n={row['padded_n']}" if "padded_n" in row else z

    _print_grid(rec, label)
    print(f"# cached under {autotune.cache_path(args.cache)}")


def _tune_topk(n: int, **kw) -> dict:
    """A rank's job of ``topk --p``: ``autotune.tune`` of the mesh cell."""
    return autotune.tune(n, "pald_topk", **kw)


def run_topk(args) -> None:
    kw = {"d": args.d, "k": args.k}
    if args.blocks:
        kw["blocks"] = _csv_ints(args.blocks)
    if args.tiles:
        # "direct" is a tile >= n: whole rows sorted, no prefilter
        kw["blocks_z"] = tuple(
            args.n if t.strip() == "direct" else int(t)
            for t in args.tiles.split(",") if t.strip())
    kw.update(impl=args.impl, device=args.device, path=args.cache,
              iters=args.iters, time_budget=args.budget)
    if args.p and args.p > 1:
        from repro_torch.testing.world import run_world

        kw["p"] = args.p
        rec = run_world(args.p, "repro_torch.tuning.hillclimb:_tune_topk",
                        (args.n,), kw, device=args.device)[0]
    else:
        rec = autotune.tune(args.n, "pald_topk", **kw)
    mesh = f" p={args.p}" if args.p and args.p > 1 else ""
    print(f"# tuned pald_topk n={args.n} d={args.d} k={args.k}{mesh} "
          f"impl={args.impl or 'default'} on "
          f"{autotune.backend_of(args.device)}")
    _print_grid(rec, lambda row: ("direct" if row["block_z"] >= args.n
                                  else f"tile={row['block_z']}"))
    print(f"# cached under {autotune.cache_path(args.cache)}")


def run_methods(args) -> None:
    rows = autotune.tune_methods(
        ns=_csv_ints(args.ns), device=args.device, path=args.cache,
        iters=args.iters, time_budget=args.budget)
    print(f"# method crossover on {autotune.backend_of(args.device)}")
    for r in rows:
        if "skipped" in r:
            print(f"  n={r['n']:6d} skipped ({r['skipped']})")
            continue
        t = " ".join(f"{m}={s * 1e3:.3f}ms" for m, s in r["timings"].items())
        print(f"  n={r['n']:6d} best={r['method']:9s} {t}")
        for m, err in r.get("failed", {}).items():
            print(f"           {m} FAILED: {err}")
    print(f"# cached under {autotune.cache_path(args.cache)}")


def _common(p) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--cache", default=None, help="tuning cache path")
    p.add_argument("--budget", type=float, default=None,
                   help="wall-seconds budget for the whole sweep; the "
                        "rest is skipped")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.hillclimb",
        description="measure and persist the port's tuning cache")
    sub = ap.add_subparsers(dest="cmd")

    cell = sub.add_parser("cell", help="dry-run one LM cell with config "
                                       "overrides")
    cell.add_argument("--arch", required=True)
    cell.add_argument("--shape", required=True)
    cell.add_argument("--mesh", choices=["single", "multi"],
                      default="single")
    cell.add_argument("--set", action="append", default=[],
                      help="ModelConfig field override, e.g. remat=dots")
    cell.add_argument("--microbatches", type=int, default=1)
    cell.add_argument("--q-chunk", type=int, default=1024)
    cell.add_argument("--baseline-dir", default="build/dryrun_out")
    cell.add_argument("--save", default=None,
                      help="write the new cell's JSON under this tag in "
                           "--baseline-dir")
    cell.add_argument("--device", default="cuda",
                      choices=("cuda", "cpu", "meta"),
                      help="meta: count only; cuda (default) / cpu: also "
                           "measure")
    cell.add_argument("--reduced", action="store_true",
                      help="the arch's reduced same-family config")

    blocks = sub.add_parser("blocks", help="tune one pass's block sizes")
    blocks.add_argument("--n", type=int, required=True)
    blocks.add_argument("--pass", required=True,
                        choices=[p for p in autotune.PASSES
                                 if p != "pald_topk"])
    blocks.add_argument("--impl", default=None, choices=("cuda", "torch"))
    blocks.add_argument("--d", type=int, default=8,
                        help="feature dim (pald_fused cells key on it)")
    blocks.add_argument("--k", type=int, default=16,
                        help="neighborhood size (pald_knn cells key on it)")
    blocks.add_argument("--ties", default="drop",
                        choices=("drop", "split", "ignore"))
    blocks.add_argument("--weight", default=None,
                        help="registered weight functional name; tunes its "
                             "own :w-<name> cell")
    blocks.add_argument("--blocks", default=None, help="csv candidate blocks")
    blocks.add_argument("--block-z", default=None,
                        help="csv candidate z tiles")
    _common(blocks)

    methods = sub.add_parser("methods", help="tune the method crossover")
    methods.add_argument("--ns", default="64,128,256,512,1024")
    _common(methods)

    topk = sub.add_parser("topk", help="tune the neighbor selection "
                                       "(pald_topk)")
    topk.add_argument("--n", type=int, required=True)
    topk.add_argument("--d", type=int, default=8)
    topk.add_argument("--k", type=int, default=16)
    topk.add_argument("--impl", default=None,
                      choices=("cuda", "torch", "chunked"))
    topk.add_argument("--blocks", default=None,
                      help="csv selection row-slab candidates")
    topk.add_argument("--tiles", default=None,
                      help="csv prefilter tiles; >= n or 'direct' sorts "
                           "whole rows")
    topk.add_argument("--p", type=int, default=None,
                      help="mesh device count; p > 1 tunes the mesh cell "
                           "in a local world of p ranks")
    _common(topk)

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in SUBCOMMANDS + ("-h", "--help"):
        argv = ["cell"] + argv  # no subcommand: the cell, as the reference
    args = ap.parse_args(argv)
    if args.cmd == "cell":
        run_cell(args)
    elif args.cmd == "blocks":
        run_blocks(args)
    elif args.cmd == "methods":
        run_methods(args)
    elif args.cmd == "topk":
        run_topk(args)
    else:
        ap.print_help()


if __name__ == "__main__":
    main()

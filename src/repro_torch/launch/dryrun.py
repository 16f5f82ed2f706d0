"""Dry run of every (arch x shape x mesh) cell: what one rank of the
production mesh costs, counted on meta tensors and measured on the card
(counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles the per-chip program of every runnable
cell for the single-pod (16, 16) and the two-pod (2, 16, 16) TPU meshes
and reads XLA's analyses.  The port has no compiler to ask, so a cell is:

- **counted** at full width and depth by running the port's own per-rank
  program (``specs.cell_step``) on ``meta`` tensors, on any host, with
  nothing allocated (``cost_analysis.count``): flops a rank
  (``FlopCounterMode``, forward, backward and recomputation), bytes
  accessed a rank (an unfused upper bound: every aten op's operand and
  result bytes), the peak of the bytes alive (``memory_analysis``'s
  ``temp_size_in_bytes``; ``argument_size_in_bytes``: the rank's state
  blocks, gathered bfloat16 leaves and rows), and the collective bytes a
  rank by kind, counted analytically for the mesh
  (``cost_analysis.train_collectives``); from these the roofline terms
  over the H100's data-sheet rates and the reference's model flops;
- **measured** with ``--device cuda`` where the meta estimate fits the
  card: a step's time (CUDA events, median after a warm-up) and
  ``torch.cuda.max_memory_allocated`` beside the estimate.  A cell whose
  full depth does not fit is measured at 1 and 2 repeats of its layer
  pattern and extrapolated by the reference's affine rule and its clamp
  (``probe_costs``); one whose 2-repeat probe does not fit records
  ``"measured": {"fits": false, ...}`` with the estimates.
  ``run_cell(probe=True)`` measures the probes of a cell that fits too,
  beside its full depth.

A cell that ``configs.base.runnable`` refuses is skipped as the
reference skips it, and so is a train cell whose layout the mesh does
not divide (:func:`layout_refusal`: the port's sharded step refuses it).
Counting needs no probes (eager counting sees every repeat).  The port's
per-rank costs differ from the reference's on purpose: compute is
replicated along ``model`` (one rank runs its rows through the whole
model) and serving is not sharded at all.

    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh single --device meta
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, reduced, runnable
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshSpec, production_spec

__all__ = ["count_cell", "measure_cell", "probe_costs", "run_cell",
           "cell_tag", "layout_refusal", "main", "FIT_FRACTION"]

# share of the card's memory a measured cell's estimate may take
FIT_FRACTION = 0.9


def _mesh_tag(mesh: MeshSpec) -> str:
    return "x".join(str(s) for s in mesh.shape)


def count_cell(cfg, shape, mesh, *, q_chunk=1024, microbatches=1) -> dict:
    """The per-rank counts of one cell on meta (module docstring)."""
    fn, args = specs.cell_step(cfg, shape, mesh, device="meta",
                               q_chunk=q_chunk, microbatches=microbatches)
    arg_bytes = ca.tensor_bytes(args)
    c = ca.count(fn, *args)
    return {"flops": c.flops, "bytes": c.bytes_accessed,
            "argument_bytes": arg_bytes, "temp_bytes": c.temp_bytes,
            "off_meta": c.off_meta, "seconds": c.seconds}


def _capacity(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def measure_cell(cfg, shape, mesh, *, device="cuda", q_chunk=1024,
                 microbatches=1, seed=0, reps=3) -> dict:
    """One cell's per-rank program on ``device`` with real tensors from
    ``seed``: a warm-up step, then ``reps`` steps timed
    (``cost_analysis.timed``); the peak of allocated memory over building
    the arguments, the warm-up step and the steps, above what was
    allocated before (``cost_analysis.peak_memory``; the card only)."""
    dev = specs._device(device)
    with ca.peak_memory(dev) as peak:
        fn, args = specs.cell_step(cfg, shape, mesh, device=dev, seed=seed,
                                   q_chunk=q_chunk, microbatches=microbatches)
        try:
            _, ms, times = ca.timed(lambda: fn(*args), dev, reps)
        finally:
            del fn, args
    return {"step_ms": ms, "step_ms_reps": times, "peak_bytes": peak.bytes}


def layout_refusal(cfg, mesh) -> str | None:
    """Why the port's sharded step cannot lay ``cfg``'s train state over
    ``mesh`` (a leaf dimension that its mesh dimensions do not divide,
    which ``train_step.shard_state`` refuses as ``jax.device_put`` does;
    a reduced MoE's few experts on a 16-wide ``model``), or None."""
    state, layout = specs.state_specs(cfg, mesh)
    for name, t in state["params"].items():
        try:
            specs.block_shape(t.shape, mesh, layout["params"][name])
        except ValueError as e:
            return f"the layout does not divide the mesh: {name}: {e}"
    return None


def _probe_cfg(cfg, repeats: int):
    return dataclasses.replace(cfg, n_layers=repeats * len(cfg.pattern))


def _estimate(cfg, shape, mesh, **kw) -> int:
    c = count_cell(cfg, shape, mesh, **kw)
    return c["argument_bytes"] + c["temp_bytes"]


def probe_costs(cfg, shape, mesh, *, device="cuda", q_chunk=1024,
                microbatches=1, seed=0, reps=3, estimates=None) -> dict:
    """A step's time measured at 1 and 2 repeats of the layer pattern and
    extrapolated to the config's depth by the reference's affine rule,

        t(R) = t(1) + (R - 1) * max(t(2) - t(1), 0),

    the per-repeat slope clamped at zero as the reference clamps it; each
    probe's peak beside its own meta estimate (``estimates``: {repeats:
    bytes} already counted)."""
    R = cfg.n_repeats
    estimates = dict(estimates or {})
    probes = {}
    for r in (1, 2):
        pcfg = _probe_cfg(cfg, r)
        if r not in estimates:
            estimates[r] = _estimate(pcfg, shape, mesh, q_chunk=q_chunk,
                                     microbatches=microbatches)
        m = measure_cell(pcfg, shape, mesh, device=device, q_chunk=q_chunk,
                         microbatches=microbatches, seed=seed, reps=reps)
        m["peak_estimate_bytes"] = estimates[r]
        probes[r] = m
    slope = max(probes[2]["step_ms"] - probes[1]["step_ms"], 0.0)
    return {"repeats": R,
            "probe_step_ms": [probes[1]["step_ms"], probes[2]["step_ms"]],
            "probe_peak_bytes": [probes[1]["peak_bytes"],
                                 probes[2]["peak_bytes"]],
            "probe_peak_estimate_bytes": [probes[1]["peak_estimate_bytes"],
                                          probes[2]["peak_estimate_bytes"]],
            "per_repeat_ms": slope,
            "step_ms": probes[1]["step_ms"] + (R - 1) * slope}


def _measured(cfg, shape, mesh, estimate, *, device, q_chunk, microbatches,
              seed, reps, probe) -> dict:
    dev = specs._device(device)
    cap = FIT_FRACTION * _capacity(dev)
    out = {**ca.device_info(dev), "peak_estimate_bytes": estimate,
           "capacity_bytes": int(cap)}
    full_fits = estimate <= cap
    kw = dict(device=dev, q_chunk=q_chunk, microbatches=microbatches,
              seed=seed, reps=reps)
    if full_fits:
        out.update(fits=True, depth="full",
                   **measure_cell(cfg, shape, mesh, **kw))
        if out["peak_bytes"] is not None:
            out["peak_ratio"] = out["peak_bytes"] / estimate
    if probe or not full_fits:
        two = _estimate(_probe_cfg(cfg, 2), shape, mesh, q_chunk=q_chunk,
                        microbatches=microbatches)
        if two > cap:
            if not full_fits:
                out.update(fits=False, probe_estimate_bytes=two)
            return out
        pr = probe_costs(cfg, shape, mesh, estimates={2: two}, **kw)
        out["probes"] = pr
        if not full_fits:
            out.update(fits=True, depth="probes", step_ms=pr["step_ms"])
        else:
            out["probe_error"] = pr["step_ms"] / out["step_ms"] - 1.0
    return out


def run_cell(arch: str, shape, multi_pod: bool, *, cfg=None, mesh=None,
             q_chunk: int = 1024, microbatches: int = 1, device="meta",
             seed: int = 0, reps: int = 3, probe: bool = False,
             verbose: bool = True) -> dict:
    """One cell's JSON (module docstring).  ``shape``: a name of
    ``SHAPES`` or a ``ShapeConfig``; ``cfg``: the config to run (default
    ``configs.get(arch)``); ``mesh``: a ``MeshSpec`` (default the
    production mesh ``multi_pod`` names); ``device="meta"`` counts only,
    ``"cuda"`` / ``"cpu"`` also measures."""
    cfg = configs.get(arch) if cfg is None else cfg
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = production_spec(multi_pod) if mesh is None else mesh
    chips = math.prod(mesh.shape)
    ok, why = runnable(cfg, shape)
    if ok and shape.kind == "train":
        why = layout_refusal(cfg, mesh)
        ok = why is None
    if shape.kind == "train" and microbatches == 1:
        microbatches = cfg.train_microbatches
    cell = {"arch": arch, "shape": shape.name, "mesh": _mesh_tag(mesh),
            "chips": chips, "microbatches": microbatches}
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell

    counted = count_cell(cfg, shape, mesh, q_chunk=q_chunk,
                         microbatches=microbatches)
    if shape.kind == "train":
        coll = ca.train_collectives(cfg, mesh, shape.global_batch,
                                    microbatches)
        collectives = "per step: the layout's bfloat16 gathers, the "\
            "gradient blocks' all-to-all sums, the grad norm, the agreement"
        once = None
    else:
        coll = ca.CollectiveStats()
        collectives = "none: serving compute replicated"
        once = ca.gather_collectives(cfg, mesh).as_dict()
    terms = ca.roofline_terms(flops=counted["flops"],
                              bytes_accessed=counted["bytes"],
                              coll_s=coll.seconds)
    mf = ca.model_flops(cfg, shape)
    cell.update(
        status="ok",
        kind=shape.kind,
        q_chunk=q_chunk,
        rows_per_rank=specs.batch_rows(shape, mesh),
        count_s=round(counted["seconds"], 2),
        memory_analysis={"argument_size_in_bytes": counted["argument_bytes"],
                         "temp_size_in_bytes": counted["temp_bytes"]},
        flops_per_rank=counted["flops"],
        bytes_per_rank=counted["bytes"],
        bytes_note="unfused upper bound: every aten op's operand and result "
                   "bytes (views excluded)",
        coll_bytes_per_rank=coll.total_traffic,
        coll_by_kind=coll.as_dict(),
        collectives=collectives,
        roofline=terms,
        model_flops_global=mf,
        model_flops_per_chip=mf / chips,
        useful_flop_ratio=(mf / chips / counted["flops"]
                           if counted["flops"] else None),
        rates=ca.RATES_SOURCE,
        off_meta=counted["off_meta"],
    )
    if once is not None:
        cell["one_time_collectives"] = once
        cell["one_time_note"] = ("the bfloat16 serving copy gathered whole "
                                 "once from its layout's blocks")
    if specs._device(device).type != "meta":
        cell["measured"] = _measured(
            cfg, shape, mesh, counted["argument_bytes"]
            + counted["temp_bytes"], device=device, q_chunk=q_chunk,
            microbatches=microbatches, seed=seed, reps=reps, probe=probe)
    if verbose:
        ma = cell["memory_analysis"]
        tot = ma["argument_size_in_bytes"] + ma["temp_size_in_bytes"]
        line = (f"  ok  count {counted['seconds']:6.1f}s  bytes/rank "
                f"{tot / 2**30:8.2f} GiB  flops/rank "
                f"{counted['flops']:,.3g}  coll {coll.total_traffic / 2**20:,.1f}"
                f" MiB  bottleneck {terms['bottleneck']}  useful "
                f"{cell['useful_flop_ratio'] and round(cell['useful_flop_ratio'], 4)}")
        m = cell.get("measured")
        if m is not None:
            if m.get("fits"):
                line += f"  step {m['step_ms']:.2f} ms ({m['depth']})"
                if m.get("peak_ratio") is not None:
                    line += (f" peak {m['peak_bytes'] / 2**30:.2f} GiB = "
                             f"{m['peak_ratio']:.3f} x estimate")
            else:
                line += "  does not fit the card"
        print(line)
    return cell


def cell_tag(arch: str, shape: str, multi: bool) -> str:
    return f"{arch}__{shape}__{'multi' if multi else 'single'}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="per-rank costs of the LM cells: counted on meta, "
                    "measured on the card")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun_out")
    ap.add_argument("--q-chunk", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "cpu", "meta"),
                    help="meta: count only; cuda (default) / cpu: count, "
                         "then measure where the cell fits")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' reduced same-family configs (a quick "
                         "check on the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[dryrun] no CUDA GPU available; pass --device meta (count "
              "only) or --device cpu", file=sys.stderr)
        return 2

    archs = (list(configs.ARCHS) if (args.all or args.arch is None)
             else [args.arch])
    shapes = (list(SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        cfg = configs.get(arch)
        if args.reduced:
            cfg = reduced(cfg)
        for shape in shapes:
            for multi in meshes:
                tag = cell_tag(arch, shape, multi)
                print(f"[dryrun] {tag}")
                try:
                    cell = run_cell(arch, shape, multi, cfg=cfg,
                                    q_chunk=args.q_chunk,
                                    microbatches=args.microbatches,
                                    device=args.device, seed=args.seed,
                                    reps=args.reps)
                    if args.reduced:
                        cell["config"] = cfg.name
                except Exception:  # noqa: BLE001 - recorded, exit code 1
                    failures += 1
                    cell = {"arch": arch, "shape": shape,
                            "mesh": _mesh_tag(production_spec(multi)),
                            "status": "error",
                            "traceback": traceback.format_exc(limit=12)}
                    print("  ERROR")
                    print(cell["traceback"])
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(cell, f, indent=1)
    print(f"[dryrun] done, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

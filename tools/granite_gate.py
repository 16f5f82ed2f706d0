"""granite-moe-1b-a400m's float32 serving gates in fresh processes.

    PYTHONPATH=src:. python3 tools/granite_gate.py [--runs 3]
    PYTHONPATH=src:. python3 tools/granite_gate.py --seeds 32
    PYTHONPATH=src:. python3 tools/granite_gate.py --diagnose 3

Phase 24 of ``chip_smoke.py`` holds granite's cached prefill (at its own
capacity factor, 1.25) and its cached prefill + decode (at a capacity that
drops nothing, experts / top-k = 4.0) to the cache-free forward.  This
script runs the gates in child processes, each a fresh process on the card:

- ``--runs`` times the whole of phase 24 as the smoke runs it (gemma2-2b
  first, so the shared generator is where the smoke leaves it), and once
  more under ``torch.use_deterministic_algorithms(True, warn_only=True)``
  (``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which names every op without a
  deterministic implementation that the gates reach;
- twice granite alone, its inputs from a generator seeded afresh;
- once ``phase_lm_full`` alone (mamba2-780m, then granite), its inputs
  from a generator seeded afresh, as a run of phase 24's full-size archs
  without gemma2-2b before them draws them.

With ``--seeds N`` it runs instead one child that holds granite's weights
(seeded as phase 24 seeds them) and draws both gates' inputs from a
generator seeded 0 .. N - 1 in turn: how far the inputs alone move the
gates.

With ``--diagnose SEED`` it runs one child on that seed's inputs (as the
sweep draws them) and records, in every MoE layer, the experts the
router's top k picks for each token in the cached prefill + decode and in
the cache-free forward.  It prints the layers where a token's experts
differ between the two, in layer order, with the token's position and the
router's margin there (its k-th largest probability less the (k+1)-th, in
each path): a margin at float32 rounding says the two paths broke a
near-tie apart.

Each child prints one JSON line with every gate's max |err| (as
``float.hex``, so equal bits read equal) and the deterministic mode's
warnings; the parent prints them together and whether the runs of each
kind agree bitwise.  Exits 0 when every child passed its gates.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"


def sweep(cs, dev, seeds: int, gates: list) -> None:
    """Granite's two gates on inputs from generators seeded 0 .. seeds - 1,
    the weights phase 24's; a gate that fails is recorded in ``gates`` with
    its message, and the sweep goes on."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models.model import Model

    _, B, S, G = next(c for c in cs.LM_FULL if c[0] == ARCH)
    cfg = configs.get(ARCH)
    params = Model(cfg).init(cs.SEED, dev)
    gate_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, args in (("lm_prompt_gate", (cfg, params, gen, B, S, dev)),
                           ("lm_cache_gate",
                            (gate_cfg, params, gen, B, S, G, dev))):
            try:
                getattr(cs, name)(*args)
            except AssertionError as err:
                gates.append({"arch": ARCH, "gate": name, "failed": str(err)})


def diagnose(cs, dev, seed: int) -> dict:
    """Where the cached path's and the cache-free forward's router picks
    part, on the inputs the sweep draws from ``seed`` (module docstring)."""
    import dataclasses

    import torch
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    _, B, S, G = next(c for c in cs.LM_FULL if c[0] == ARCH)
    cfg = configs.get(ARCH)
    params = Model(cfg).init(cs.SEED, dev)
    gate_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    gen = torch.Generator(device=dev).manual_seed(seed)
    cs.lm_prompt_gate(cfg, params, gen, B, S, dev)
    calls, where = [], {}
    apply0, top0 = moe.moe_apply, moe.top_k

    def apply(p, r, x, *a, **kw):
        where["layer"], where["bs"] = (id(p), r), tuple(x.shape[:2])
        return apply0(p, r, x, *a, **kw)

    def top(probs, k):
        vals, ids = top0(probs, k)
        b, s = where["bs"]
        ranked = torch.sort(probs, dim=-1, descending=True, stable=True).values
        calls.append((where["layer"], ids.reshape(b, s, k),
                      ranked.reshape(b, s, -1)[..., k - 1:k + 1]))
        return vals, ids

    moe.moe_apply, moe.top_k = apply, top
    try:
        try:
            err = repr(cs.lm_cache_gate(gate_cfg, params, gen, B, S, G,
                                        dev)[0])
        except AssertionError as failed:
            err = str(failed)
    finally:
        moe.moe_apply, moe.top_k = apply0, top0
    layers = list(dict.fromkeys(key for key, _, _ in calls))
    cached, forward = calls[:len(layers) * G], calls[len(layers) * G:]
    parts = []
    for i, key in enumerate(layers):
        ids_c = torch.cat([c[1] for c in cached if c[0] == key], 1)
        top_c = torch.cat([c[2] for c in cached if c[0] == key], 1)
        (_, ids_f, top_f), = [c for c in forward if c[0] == key]
        differ = (ids_c.sort(-1).values != ids_f.sort(-1).values).any(-1)
        for b, t in differ.nonzero().tolist():
            parts.append({
                "layer": i, "batch": b, "position": t,
                "experts_cached": ids_c[b, t].tolist(),
                "experts_forward": ids_f[b, t].tolist(),
                "margin_cached": float(top_c[b, t, 0] - top_c[b, t, 1]),
                "margin_forward": float(top_f[b, t, 0] - top_f[b, t, 1])})
    return {"seed": seed, "cache_gate": err, "moe_layers": len(layers),
            "tokens": B * (S + G - 1), "parted": parts}


def child(mode: str, seeds: int = 0, seed: int = 0) -> None:
    import torch

    import chip_smoke as cs

    if mode == "deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = torch.device("cuda", 0)
    gates = []
    for name in ("lm_prompt_gate", "lm_cache_gate"):
        def wrap(cfg, *a, _f=getattr(cs, name), _n=name):
            err, scale = _f(cfg, *a)
            capacity = cfg.moe.capacity_factor if cfg.moe else None
            gates.append({"arch": cfg.name, "gate": _n,
                          "capacity": capacity, "err": float(err).hex(),
                          "err_float": err, "scale": scale})
            return err, scale
        setattr(cs, name, wrap)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if mode == "diagnose":
            print("DIAGNOSE " + json.dumps(diagnose(cs, dev, seed)))
            return
        if mode == "sweep":
            sweep(cs, dev, seeds, gates)
        elif mode in ("alone", "full"):
            if mode == "alone":
                cs.LM_FULL = tuple(c for c in cs.LM_FULL if c[0] == ARCH)
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            cs.phase_lm_full(dev, cs.smi("name,power.limit"), gen)
        else:
            cs.phase_lm_serve(dev, cs.smi("name,power.limit"))
    notes = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print("GATES " + json.dumps({"mode": mode, "gates": [
        g for g in gates if g["arch"] == ARCH], "warnings": notes}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--child",
                    choices=("phase", "deterministic", "alone", "full",
                             "sweep", "diagnose"))
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--diagnose", type=int, default=None, metavar="SEED")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seeds, args.diagnose or 0)
        return 0
    if args.diagnose is not None:
        proc = subprocess.run([sys.executable, __file__, "--child",
                               "diagnose", "--diagnose", str(args.diagnose)],
                              cwd=HERE, capture_output=True, text=True,
                              timeout=900)
        line = [s for s in proc.stdout.splitlines()
                if s.startswith("DIAGNOSE ")]
        if proc.returncode != 0 or not line:
            print(f"diagnose: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            return 1
        res = json.loads(line[0][9:])
        print(f"diagnose: seed {res['seed']}: cache gate {res['cache_gate']}; "
              f"{len(res['parted'])} of {res['tokens']} tokens x "
              f"{res['moe_layers']} MoE layers pick other experts")
        for p in res["parted"]:
            print(f"diagnose: layer {p['layer']}, batch {p['batch']}, "
                  f"position {p['position']}: experts "
                  f"{p['experts_cached']} cached, {p['experts_forward']} "
                  f"forward; margin {p['margin_cached']!r} cached, "
                  f"{p['margin_forward']!r} forward")
        return 0
    modes = (["sweep"] if args.seeds else
             ["phase"] * args.runs + ["deterministic"] + ["alone"] * 2
             + ["full"])
    results, ok = [], True
    for mode in modes:
        env = dict(os.environ)
        if mode == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        proc = subprocess.run([sys.executable, __file__, "--child", mode,
                               "--seeds", str(args.seeds)],
                              cwd=HERE, env=env, capture_output=True,
                              text=True, timeout=900)
        line = [s for s in proc.stdout.splitlines() if s.startswith("GATES ")]
        if proc.returncode != 0 or not line:
            ok = False
            print(f"{mode}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            continue
        res = json.loads(line[0][6:])
        results.append(res)
        for g in res["gates"]:
            if "failed" in g:
                ok = False
                print(f"{mode}: {g['gate']} failed: {g['failed']}")
                continue
            print(f"{mode}: {g['gate']} at capacity {g['capacity']}: max "
                  f"|err| {g['err_float']!r} ({g['err']}), logits up to "
                  f"{g['scale']!r}")
        if mode == "sweep":
            for gate in ("lm_prompt_gate", "lm_cache_gate"):
                errs = [g["err_float"] for g in res["gates"]
                        if g["gate"] == gate and "failed" not in g]
                print(f"sweep: {gate} over {args.seeds} seeds: max |err| "
                      f"from {min(errs)!r} to {max(errs)!r}, "
                      f"{args.seeds - len(errs)} failed")
        for w in res["warnings"]:
            print(f"{mode}: {w}")
    for mode in ("phase", "alone"):
        errs = [tuple(g["err"] for g in r["gates"]) for r in results
                if r["mode"] == mode]
        print(f"{mode}: {len(errs)} runs, bitwise the same: "
              f"{len(set(errs)) <= 1}")
    det = [r for r in results if r["mode"] == "deterministic"]
    phase = [r for r in results if r["mode"] == "phase"]
    if det and phase:
        same = ([g["err"] for g in det[0]["gates"]]
                == [g["err"] for g in phase[0]["gates"]])
        print(f"deterministic against the first phase run: bitwise the "
              f"same: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Which ``gloo`` collectives take CUDA tensors, on this machine's torch.

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py

For each of ``all_gather``, ``all_reduce``, ``broadcast`` and a
``batch_isend_irecv`` exchange, starts a world of two ranks sharing the
card (``testing.world``, gloo) and tries the operation on CUDA float32
tensors in both ranks, checked against the values it should deliver.
Prints the card's name and power limit, then one line per operation:
"accepted", the error it raised, or that a rank process died (a crash
below Python).  ``core/distributed.py`` stages every gloo collective
through host buffers whatever this says; the probe records what a later
change could take from it.  Each world waits at most 60 s a call; run it
under ``timeout`` all the same.  Needs a CUDA GPU.
"""
from __future__ import annotations

import subprocess


OPERATIONS = ("all_gather", "all_reduce", "broadcast", "isend/irecv")


def probe(name: str) -> str:
    """A rank's job: one operation on CUDA tensors, "accepted" or its
    error."""
    import torch
    import torch.distributed as dist

    rank, dev = dist.get_rank(), torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)

    def gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y

    def bcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    def exchange():
        y = torch.empty_like(x)
        peer = 1 - rank
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, peer),
                dist.P2POp(dist.irecv, y, peer)]):
            r.wait()
        return y

    fn, want = {"all_gather": (gather, [1.0] * 4 + [2.0] * 4),
                "all_reduce": (reduce, [3.0] * 4),
                "broadcast": (bcast, [1.0] * 4),
                "isend/irecv": (exchange, [float(2 - rank)] * 4)}[name]
    try:
        got = fn()
        torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - the probe reports it
        return f"{type(exc).__name__}: {str(exc)[:160]}"
    if torch.equal(got.cpu(), torch.tensor(want)):
        return "accepted"
    return f"accepted, wrong values {got.tolist()}"


def main() -> None:
    from repro_torch.testing.world import World, WorldError

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for name in OPERATIONS:
        try:
            with World(2, device="cuda", timeout=60.0) as w:
                outs = w.run(probe, name)
            said = "; ".join(f"rank {r}: {o}" for r, o in enumerate(outs))
        except (WorldError, TimeoutError) as exc:  # the probe reports it
            said = str(exc).splitlines()[0]
        print(f"gloo + CUDA tensors, {name}: {said}")


if __name__ == "__main__":
    main()

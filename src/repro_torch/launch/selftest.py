"""Self-test of the port: PaLD on the device end to end, one rank and a
world of four, one reduced arch through a train step, prefill and decode,
a checkpoint round trip, and one production cell counted on meta tensors
(counterpart of ``repro.launch.selftest``).

    PYTHONPATH=src python -m repro_torch.launch.selftest            # the card
    PYTHONPATH=src python -m repro_torch.launch.selftest --device cpu

Checks, each against the numpy reference oracle (``core.reference``):

- the PaLD core: ``pald.cohesion`` by the four methods (dense, pairwise,
  triplet, kernel) on one device;
- distributed PaLD: ``core.distributed.pald_distributed`` with the ring
  strategy in a local world of four ranks sharing the device
  (``testing.world``, gloo), and the sharded k-NN pipeline
  (``core.distributed_knn.pald_knn_sharded``) bitwise the single-device
  ``select_cohere``;
- the LM path: reduced gemma2-2b (``models/``) through one train step
  (``train.train_step``: bfloat16 compute, AdamW; finite loss), then the
  trained parameters through ``prefill`` and one ``decode_step``, finite
  logits;
- the checkpointer: ``save`` then ``restore_latest`` (``checkpoint/``);
- the dry run (the counterpart of the reference's abstract lowering of one
  production cell): full internvl2-1b's per-rank train program at 256 x 8
  over a (2, 2) ``MeshSpec`` (``launch.specs.cell_step``) counted on meta
  (``launch.cost_analysis.count``): a finite flop count, and no tensor
  made off the meta device.

On the card the kernels run in every rank.  Exit code 0 = healthy.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

__all__ = ["main"]

P_WORLD = 4


def _distances(n: int, seed: int) -> np.ndarray:
    X = np.random.default_rng(seed).normal(size=(n, 4))
    return np.sqrt(((X[:, None] - X[None]) ** 2).sum(-1))


def _pald_core(device: str) -> None:
    from repro_torch.core import pald, reference

    D = _distances(40, 0)
    Cref = reference.pald_pairwise_reference(D, ties="ignore",
                                             normalize=True)
    for m in ("dense", "pairwise", "triplet", "kernel"):
        C = pald.cohesion(D, method=m, block=16, ties="ignore",
                          device=device).cpu().numpy()
        assert np.allclose(C, Cref, atol=1e-5), m


def _pald_distributed(device: str) -> None:
    import torch

    from repro_torch.core import reference
    from repro_torch.kernels import ops
    from repro_torch.testing.world import MeshSpec, World

    D = _distances(48, 1)
    Cref = reference.pald_pairwise_reference(D, ties="ignore",
                                             normalize=True)
    X = np.random.default_rng(2).integers(0, 4, (50, 4)).astype(np.float32)
    g1, v1 = ops.select_cohere(torch.as_tensor(X, device=device), k=7,
                               normalize=True)
    mesh = MeshSpec((P_WORLD,), ("data",))
    with World(P_WORLD, device=device, timeout=300.0) as w:
        for C in w.run("repro_torch.core.distributed:pald_distributed", D,
                       mesh, strategy="ring", ties="ignore", device=device):
            assert np.allclose(C, Cref, atol=1e-5), "ring"
        for g, v in w.run(
                "repro_torch.core.distributed_knn:pald_knn_sharded", X,
                mesh, k=7, strategy="ring", device=device):
            assert np.array_equal(g.indices, g1.indices.cpu().numpy())
            assert np.array_equal(v, v1.cpu().numpy()), "sharded knn"


def _lm_cycle(device: str) -> None:
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import reduced
    from repro_torch.models.model import Model
    from repro_torch.train.train_step import init_state, make_train_step

    cfg = reduced(configs.get("gemma2-2b"))
    model = Model(cfg)
    state = init_state(cfg, 0, device)
    gen = torch.Generator(device=device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                         device=device)
    state, m = make_train_step(cfg)(state, {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(m["loss"])), "train step loss"
    params = state["params"]
    caches = model.init_caches(2, 20, device=device)
    lg, caches = model.prefill(params, {"tokens": toks}, caches)
    lg, caches = model.decode_step(
        params, torch.argmax(lg[..., :cfg.vocab_size], -1)[:, None], caches,
        16)
    assert bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())


def _checkpoint(device: str) -> None:
    import tempfile

    import torch

    from repro_torch.checkpoint import checkpointer

    t = {"a": torch.arange(4.0, device=device)}
    with tempfile.TemporaryDirectory() as d:
        checkpointer.save(d, 1, t)
        r, at = checkpointer.restore_latest(d, t, device=device)
        assert at == 1 and torch.equal(r["a"], t["a"])


def _counted_cell(device: str) -> None:
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import cost_analysis, specs
    from repro_torch.launch.mesh import MeshSpec

    cfg = configs.get("internvl2-1b")
    mesh = MeshSpec((P_WORLD // 2, 2), ("data", "model"))
    fn, args = specs.cell_step(cfg, ShapeConfig("t", 256, 8, "train"), mesh,
                               device="meta", q_chunk=128)
    c = cost_analysis.count(fn, *args)
    assert math.isfinite(c.flops) and c.flops > 0, c.flops
    assert not c.off_meta, f"made off meta: {c.off_meta}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.selftest")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    t0 = time.time()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("[selftest] no CUDA GPU available; pass --device cpu",
              file=sys.stderr)
        return 2
    failures = []

    def check(name, fn):
        t = time.time()
        try:
            fn(args.device)
            print(f"  ok   {name} ({time.time() - t:.1f}s)")
        except Exception as e:  # noqa: BLE001 - reported, and exit code 1
            failures.append(name)
            print(f"  FAIL {name}: {type(e).__name__}: {e}")

    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"[selftest] device: {where}, torch {torch.__version__}")
    check("pald core (4 methods vs reference)", _pald_core)
    check(f"pald distributed (ring, {P_WORLD} ranks; sharded knn bitwise)",
          _pald_distributed)
    check("lm train+prefill+decode (gemma2 reduced)", _lm_cycle)
    check("checkpoint save/restore", _checkpoint)
    check("counted production cell (full internvl2-1b)", _counted_cell)
    print(f"[selftest] "
          f"{'FAILED: ' + ', '.join(failures) if failures else 'all healthy'}"
          f" ({time.time() - t0:.1f}s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

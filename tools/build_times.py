"""Time the nvcc build of the port's CUDA sources, one nvcc each, all
started together as ``kernels/_build.py`` starts them.

    PYTHONPATH=src python3 tools/build_times.py [--csrc DIR] [--runs 1]

``--csrc`` names a directory of ``.cu`` sources (default: the package's
own, ``src/repro_torch/csrc``), for example another checkout's, to compare
two trees' builds on one machine.  Every ``*.cu`` in it is built with
``_build.FLAGS`` into a temporary directory that is removed afterwards.
Prints each source's seconds from the common start to its nvcc's exit,
and the wall time of the whole build (the longest source), for each run.
Exits 1 when a source does not build.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from repro_torch.kernels import _build


def build_once(csrc: Path, out: Path) -> dict:
    """{source stem: seconds from the common start to its nvcc's exit}."""
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    pending = {}
    for p in sorted(csrc.glob("*.cu")):
        with open(out / f"{p.stem}.log", "w") as log:
            pending[p.stem] = subprocess.Popen(
                [nvcc, *_build.FLAGS, "-o", str(out / f"lib{p.stem}.so"),
                 str(p)], stdout=log, stderr=subprocess.STDOUT)
    secs = {}
    while pending:
        for stem, proc in list(pending.items()):
            if proc.poll() is not None:
                secs[stem] = time.perf_counter() - t0
                del pending[stem]
                if proc.returncode != 0:
                    for other in pending.values():
                        other.kill()
                        other.wait()
                    raise RuntimeError(f"nvcc failed on {stem}.cu:\n"
                                       + (out / f"{stem}.log").read_text())
        time.sleep(0.05)
    return secs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    for run in range(args.runs):
        with tempfile.TemporaryDirectory() as out:
            try:
                secs = build_once(args.csrc, Path(out))
            except RuntimeError as err:
                print(err)
                return 1
        for stem, s in sorted(secs.items(), key=lambda kv: kv[1]):
            print(f"build {run}: {stem}.cu {s:.1f} s")
        print(f"build {run}: {len(secs)} sources of {args.csrc} in "
              f"{max(secs.values()):.1f} s wall")
    return 0


if __name__ == "__main__":
    sys.exit(main())

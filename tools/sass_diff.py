"""Compare the machine code (SASS) of two trees' CUDA kernels: which
kernels of a base tree compile to the same instructions in this one.

    PYTHONPATH=src python3 tools/sass_diff.py --base DIR [--sources a,b]

``--base`` is another checkout's ``csrc`` directory (for example the
parent commit unpacked with ``git archive``); ``--sources`` the stems to
compare (default: ``pald_knn,pald_topk,pald_topk_chunk``).  Each source of
both trees is built with ``_build.FLAGS`` (without ``-Xptxas -v``) into a
temporary directory, disassembled with ``cuobjdump -sass``, and each
kernel's instructions (addresses and encodings dropped) are hashed.  A
base kernel counts as unchanged when some kernel of this tree has the same
instructions, whatever its name: a template parameter added with a
default renames a kernel without changing its code.  Prints, per source,
how many base kernels are unchanged and names the others; exits 1 when
any changed.  Needs nvcc and cuobjdump (the machine with the card).
"""
from __future__ import annotations

import argparse
import hashlib
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.kernels import _build


def kernels(lib: Path, cuobjdump: str) -> dict:
    """{kernel name: sha1 of its instructions} of one shared library."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line.split(";")[0]).strip()
            if ins:
                funcs[name].append(ins)
    return {n: hashlib.sha1("\n".join(b).encode()).hexdigest()
            for n, b in funcs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, required=True)
    ap.add_argument("--sources", default="pald_knn,pald_topk,pald_topk_chunk")
    args = ap.parse_args()
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _build.FLAGS if f not in ("-Xptxas", "-v")]
    trees = {"base": args.base, "this": _build.CSRC}
    stems = args.sources.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        def build(job):
            tree, stem = job
            lib = Path(tmp) / f"{tree}_{stem}.so"
            subprocess.run([nvcc, *flags, "-o", str(lib),
                            str(trees[tree] / f"{stem}.cu")], check=True)
            return job, kernels(lib, cuobjdump)

        with ThreadPoolExecutor(len(trees) * len(stems)) as ex:
            got = dict(ex.map(build, [(t, s) for t in trees for s in stems]))
    changed = 0
    for stem in stems:
        base, this = got[("base", stem)], got[("this", stem)]
        ours = set(this.values())
        missing = [n for n, h in base.items() if h not in ours]
        changed += len(missing)
        print(f"{stem}: {len(base) - len(missing)} of {len(base)} base "
              f"kernels unchanged ({len(this)} kernels in this tree)")
        for n in missing:
            print(f"  changed: {n}")
    return 1 if changed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The weight-functional compiler (repro_torch.kernels._functor) on the CPU.

A user-registered ``WeightFunctional`` runs on the card as a C++ functor
that the compiler emits from its traced callables.  Held here, with no
card and no nvcc:

- each of the five built-ins' callables, traced and lowered, runs through
  the IR evaluator bitwise the callables, on a grid of ties, +-0, +-inf,
  nan, denormals and +inf padding;
- the emitted C++ of each, compiled by the host ``g++`` through a shim
  header (the ``_rn`` intrinsics as plain float operations under
  ``-ffp-contract=off``), bitwise the callables on the same grid; a smooth
  functional with ``exp`` and a ``share`` within rtol 1e-5, atol 1e-6;
- an op outside the table and a branch on a tensor's value raise
  ``NotImplementedError`` naming it; the compiled key depends on the
  expressions, not the name, and is the same in another process;
- ``_build``'s user libraries (a stand-in nvcc): the layout, the flags, a
  second build reused, a failed build raising with its log.
"""
import os
import shutil
import stat
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import weights as tw
from repro_torch.kernels import _build, _functor

BUILTINS = ["drop", "split", "ignore", "soft", "kernelized"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smooth_functional(name="_smooth_exp"):
    """A smooth member with ``exp``, a ``share`` and exact zeros on +inf
    padding (the ``inf - inf`` nan guarded)."""
    def focus(dxz, dyz, dxy):
        d = dxy - torch.minimum(dxz, dyz)
        f = 1.0 - torch.exp(-torch.maximum(d, torch.zeros_like(d)) * 3.0)
        return torch.where(torch.isnan(d), 0.0, f)

    def share(own, other):
        return torch.clamp(0.5 + (other - own) * 2.0, 0.0, 1.0)

    def support(own, other, pair, own_wins=None):
        res = share(own, other) * focus(own, other, pair)
        return torch.where(torch.isnan(res), 0.0, res)

    return tw.WeightFunctional(name, focus, support, share=share)


def _grid():
    """Every triple of a value set with ties, +-0, +-inf, nan and
    denormals, each with own_wins False and True, then random values."""
    v = np.array([0.0, -0.0, 1e-45, 3e-39, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0,
                  1e30, np.inf, -np.inf, np.nan, -1.0], dtype=np.float32)
    a, b, c = (m.ravel() for m in np.meshgrid(v, v, v, indexing="ij"))
    rng = np.random.default_rng(0)
    r = (rng.random((3, 4000)) * 4).astype(np.float32)
    a, b, c = (np.concatenate([x, x, y]) for x, y in zip((a, b, c), r))
    w = np.concatenate([np.zeros(v.size ** 3, bool), np.ones(v.size ** 3, bool),
                        rng.random(4000) < 0.5])
    return a, b, c, w


def _bits(x):
    """float32 bits with every nan made one nan."""
    x = np.asarray(x, dtype=np.float32).copy()
    x[np.isnan(x)] = np.nan
    return x.view(np.uint32)


def _callables(w, a, b, c, wins):
    t = [torch.from_numpy(x) for x in (a, b, c)]
    ow = torch.from_numpy(wins) if w.needs_index_tiebreak else None
    out = {"focus": w.focus(*t), "support": w.support(*t, ow)}
    if w.share is not None:
        out["share"] = w.share(t[0], t[1])
    return {k: v.to(torch.float32).numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", BUILTINS)
def test_builtins_through_the_evaluator_are_bitwise(name):
    w = tw.resolve_weight(name)
    cf = _functor.compile_functional(w)
    for prog in cf.programs.values():  # so the g++ build is bitwise too
        assert set(prog.ops()) <= _functor.EXACT_OPS, prog.ops()
    a, b, c, wins = _grid()
    want = _callables(w, a, b, c, wins)
    t = [torch.from_numpy(x) for x in (a, b, c)]
    got = {"focus": _functor.evaluate(cf.programs["focus"], *t),
           "support": _functor.evaluate(cf.programs["support"], *t,
                                        torch.from_numpy(wins))}
    if "share" in cf.programs:
        got["share"] = _functor.evaluate(cf.programs["share"], t[0], t[1])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]),
                                      err_msg=f"{name} {k}")


_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __forceinline__ inline
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
static inline float __uint_as_float(unsigned u) {
  float f; memcpy(&f, &u, 4); return f;
}
namespace pald {
struct Params { float p0, p1; };
inline float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
inline float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
inline float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
"""

_MAIN = r"""
}  // namespace pald
#include <stdio.h>
#include <stdlib.h>
template <class F>
void run(long n, const float* x, const unsigned char* w, float* out) {
  const pald::Params p{0.f, 0.f};
  for (long i = 0; i < n; ++i) {
    out[3 * i] = F::focus(x[i], x[n + i], x[2 * n + i], p);
    out[3 * i + 1] = F::support(x[i], x[n + i], x[2 * n + i], w[i] != 0, p);
    if constexpr (F::kHasShare) out[3 * i + 2] = F::share(x[i], x[n + i], p);
    else out[3 * i + 2] = 0.f;
  }
}
int main(int argc, char** argv) {
  const int which = atoi(argv[1]);
  const long n = atol(argv[2]);
  float* x = (float*)malloc(12 * n);
  unsigned char* w = (unsigned char*)malloc(n);
  float* out = (float*)malloc(12 * n);
  FILE* f = fopen(argv[3], "rb");
  if (fread(x, 4, 3 * n, f) != (size_t)(3 * n) || fread(w, 1, n, f) != (size_t)n)
    return 2;
  fclose(f);
  switch (which) {
%s
  }
  f = fopen(argv[4], "wb");
  fwrite(out, 4, 3 * n, f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def gxx_results(tmp_path_factory):
    """The emitted functors of the built-ins and the smooth functional,
    compiled by g++ into one program and run on the grid."""
    if shutil.which("g++") is None:
        pytest.skip("no host g++")
    funcs = [tw.resolve_weight(n) for n in BUILTINS] + [smooth_functional()]
    cfs = [_functor.compile_functional(w) for w in funcs]
    cases = "\n".join(f"    case {i}: run<pald::{cf.struct}>(n, x, w, out); "
                      "break;" for i, cf in enumerate(cfs))
    d = tmp_path_factory.mktemp("gxx")
    src = d / "functors.cpp"
    src.write_text(_SHIM + "".join(cf.functor for cf in cfs)
                   + _MAIN % cases)
    exe = d / "functors"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-o",
                    str(exe), str(src)], check=True, capture_output=True)
    a, b, c, wins = _grid()
    n = a.size
    (d / "in.bin").write_bytes(np.concatenate([a, b, c]).tobytes()
                               + wins.astype(np.uint8).tobytes())
    out = {}
    for i, w in enumerate(funcs):
        subprocess.run([str(exe), str(i), str(n), str(d / "in.bin"),
                        str(d / "out.bin")], check=True)
        got = np.fromfile(d / "out.bin", dtype=np.float32).reshape(n, 3)
        out[w.name] = (w, got, _callables(w, a, b, c, wins))
    return out


@pytest.mark.parametrize("name", BUILTINS)
def test_emitted_builtins_compiled_by_gxx_are_bitwise(gxx_results, name):
    w, got, want = gxx_results[name]
    for j, k in enumerate(("focus", "support", "share")):
        if k in want:
            np.testing.assert_array_equal(_bits(got[:, j]), _bits(want[k]),
                                          err_msg=f"{name} {k}")


def test_emitted_smooth_functional_compiled_by_gxx(gxx_results):
    """exp is not an exact op: the emitted ``expf`` is held within rtol
    1e-5, atol 1e-6 of torch's, nan where torch gives nan (none after the
    guards), exact zeros where torch gives them."""
    w, got, want = gxx_results["_smooth_exp"]
    for j, k in enumerate(("focus", "support", "share")):
        np.testing.assert_allclose(got[:, j], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(want[k] == 0, got[:, j] == 0)
    assert not np.isnan(want["support"]).any()


# ---------------------------------------------------------------------------
# what the compiler refuses
# ---------------------------------------------------------------------------
def test_op_outside_the_table_raises_naming_it():
    w = tw.WeightFunctional("_cosine_focus",
                            lambda a, b, c: torch.cos(a - c),
                            tw.DROP.support)
    with pytest.raises(NotImplementedError, match=r"_cosine_focus.*aten\.cos"):
        _functor.compile_functional(w)
    with pytest.raises(NotImplementedError, match="aten.cos"):
        tw.kernel_spec(w)


def test_data_dependent_branch_raises():
    def focus(a, b, c):
        if a < c:
            return torch.ones_like(a)
        return torch.zeros_like(a)

    w = tw.WeightFunctional("_branchy", focus, tw.DROP.support)
    with pytest.raises(NotImplementedError, match=r"_branchy.*data-dependent"):
        _functor.compile_functional(w)


def test_item_and_other_dtypes_raise():
    scalar = tw.WeightFunctional("_item", lambda a, b, c: b * a.item(),
                                 tw.DROP.support)
    with pytest.raises(NotImplementedError, match="_local_scalar_dense"):
        _functor.compile_functional(scalar)
    as_int = tw.WeightFunctional("_int", lambda a, b, c: (a < c).int(),
                                 tw.DROP.support)
    with pytest.raises(NotImplementedError, match="torch.int32"):
        _functor.compile_functional(as_int)


# ---------------------------------------------------------------------------
# the key and the spec
# ---------------------------------------------------------------------------
def _key_in_subprocess():
    code = textwrap.dedent("""
        from repro_torch.core import weights as tw
        from repro_torch.kernels import _functor
        s = tw.soft_threshold(0.1)
        w = tw.WeightFunctional("elsewhere", s.focus, s.support,
                                share=s.share)
        print(_functor.compile_functional(w).key)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-c", code], check=True, env=env,
                          capture_output=True, text=True).stdout.strip()


def test_key_depends_on_the_expressions_not_the_name():
    s = tw.soft_threshold(0.1)
    a = tw.WeightFunctional("_soft_a", s.focus, s.support, share=s.share)
    b = tw.WeightFunctional("_soft_b", s.focus, s.support, share=s.share)
    ka = _functor.compile_functional(a).key
    assert ka == _functor.compile_functional(b).key
    assert ka == _functor.compile_functional(s).key
    assert ka == _key_in_subprocess()
    s2 = tw.soft_threshold(0.2)  # another closure constant: another build
    c = tw.WeightFunctional("_soft_a", s2.focus, s2.support, share=s2.share)
    assert _functor.compile_functional(c).key != ka
    # the tiebreak flag is part of the functor
    d = tw.WeightFunctional("_drop_tb", tw.DROP.focus, tw.DROP.support,
                            needs_index_tiebreak=True)
    assert (_functor.compile_functional(d).key
            != _functor.compile_functional(tw.DROP).key)


def test_user_spec_and_literals():
    w = smooth_functional()
    spec = tw.kernel_spec(w)
    assert tuple(spec) == (tw.KERNEL_USER, 0.0, 0.0)
    assert spec.key == spec.functor.key and len(spec.key) == 16
    assert tw.kernel_spec("soft").functor is None
    src = spec.functor.functor
    assert "kHasShare = true" in src and "kPredicated = false" in src
    assert "expf(" in src and "nan_max(" in src and "__fmul_rn(" in src
    assert _functor.literal(0.1) == "0x1.99999ap-4f"
    assert _functor.literal(float("inf")) == "__uint_as_float(0x7f800000u)"
    assert _functor.literal(-0.0) == "-0x0p+0f"


# ---------------------------------------------------------------------------
# _build's user libraries, with a stand-in nvcc
# ---------------------------------------------------------------------------
def _fake_nvcc(path, fail=False):
    """A stand-in nvcc: logs its arguments, writes the -o file (or fails
    with a message)."""
    body = ("echo 'pald_fake.cu(1): error: boom'; exit 1" if fail else
            'echo "$@"; while [ $# -gt 0 ]; do if [ "$1" = -o ]; then '
            'echo lib > "$2"; fi; shift; done')
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_user_libraries_layout_reuse_and_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_user_status", {})
    cf = _functor.compile_functional(smooth_functional("_layout"))
    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path / "nvcc-bad", True))
    with pytest.raises(RuntimeError, match="boom"):
        _build.build_user(cf, sources=("pald_focus",))
    out = _build.user_dir(cf.key)
    assert out.parent.parent == tmp_path / "kernels"
    assert out.name == f"w_{cf.key}"
    assert not (out / "libpald_focus.so").exists()
    assert os.listdir(out) == ["user_weight.cuh"]  # no temporary left

    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path / "nvcc"))
    built = _build.build_user(cf, sources=("pald_focus", "pald_knn"))
    assert built == [(cf.key, "pald_focus"), (cf.key, "pald_knn")]
    log = (out / "libpald_focus.log").read_text()
    assert f"-DPALD_USER_WEIGHT={cf.struct}" in log
    assert str(out / "user_weight.cuh") in log and "sm_90a" in log
    hdr = (out / "user_weight.cuh").read_text()
    assert cf.functor in hdr and '#include "pald_weights.cuh"' in hdr
    assert _build.user_status(cf.key) == {"pald_focus": "built",
                                          "pald_knn": "built"}
    monkeypatch.setattr(_build, "_user_status", {})
    assert _build.build_user(cf, sources=("pald_focus",)) == []
    assert _build.user_status(cf.key) == {"pald_focus": "reused"}
    with pytest.raises(ValueError, match="no weight"):
        _build.build_user(cf, sources=("pald_topk",))


def test_explain_names_the_compiled_functor(monkeypatch):
    from repro_torch.core import pald

    monkeypatch.setattr(_build, "_user_status", {})
    D = torch.rand(9, 9)
    D = (D + D.T).fill_diagonal_(0)
    w = smooth_functional("_explained")
    info = pald.plan(D, method="kernel", device="cpu", weight=w).explain()
    key = tw.kernel_spec(w).key
    assert info["weight_kernel"] == {"functor": "compiled",
                                     "id": tw.KERNEL_USER, "key": key,
                                     "library": "not built yet",
                                     "sources": {}}
    _build._user_status[key] = {"pald_focus": "reused"}
    assert pald.plan(D, device="cpu", weight=w).explain()[
        "weight_kernel"]["library"] == "reused"
    assert pald.plan(D, device="cpu", weight="soft").explain()[
        "weight_kernel"] == {"functor": "builtin", "id": tw.KERNEL_SOFT}
    bad = tw.WeightFunctional("_cos", lambda a, b, c: torch.cos(a),
                              tw.DROP.support)
    info = pald.plan(D, device="cpu", weight=bad).explain()["weight_kernel"]
    assert info["functor"] is None and "aten.cos" in info["error"]

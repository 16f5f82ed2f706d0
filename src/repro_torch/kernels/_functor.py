"""Compile a user-registered weight functional into a CUDA functor.

The reference traces a ``WeightFunctional``'s jnp callables into every
Pallas body; this module is the port's counterpart.  The functional's
callables, ``focus(dxz, dyz, dxy)``, ``support(own, other, pair,
own_wins)`` and, where declared, ``share(own, other)``, are traced with
``make_fx(..., tracing_mode="fake")`` on 0-d float32 inputs (``own_wins``
a 0-d bool when ``needs_index_tiebreak`` is declared, else None), the aten
graph is lowered to a small typed IR (:class:`Node`: an op, its arguments,
its dtype, float32 or bool), and the IR is emitted op for op as a C++
functor with the interface of the hand-written ones in
``csrc/pald_weights.cuh``.  ``_build`` compiles the kernels with it
(``-include`` of the generated header, ``-DPALD_USER_WEIGHT=<struct>``).

The op table (:data:`OPS`): ``add`` / ``sub`` / ``rsub`` / ``mul`` /
``div`` (Tensor and Scalar forms, ``alpha`` 1) and ``neg``; ``lt`` / ``le``
/ ``gt`` / ``ge`` / ``eq`` / ``ne``; ``bitwise_*`` on bools and
``logical_*``; ``where``, ``scalar_tensor``, ``zeros_like`` /
``ones_like`` / ``full_like``; ``minimum`` / ``maximum``, ``clamp`` /
``clamp_min`` / ``clamp_max`` (``clip``) with scalar bounds, ``abs``,
``isnan``, ``isinf``; ``_to_copy`` casts between bool and float32
(``.to``, ``.float()``, ``type_as``); ``sqrt``, ``reciprocal``, ``pow``
by 2 or 0.5; ``exp``, ``log``, ``tanh``, ``sigmoid``.  Any other op, a
dtype other than float32 and bool, a captured tensor, or a Python branch
on a tensor's value raises ``NotImplementedError`` naming the functional
and the op: nothing falls back.

Exactness.  Arithmetic is emitted with ``__fadd_rn`` / ``__fsub_rn`` /
``__fmul_rn`` / ``__fdiv_rn`` / ``__fsqrt_rn``, so nvcc cannot contract
it into an FMA, and every exact op gives the bits torch gives on the same
float32 inputs.  ``minimum`` / ``maximum`` / ``clamp`` keep torch's nan
propagation (``pald::nan_min`` / ``nan_max`` / ``clip``, never a bare
``fminf``); ``isnan`` is ``x != x``; bools combine with the
non-short-circuit ``&`` / ``|``.  The sign of a zero that ``minimum`` /
``maximum`` return from two zeros of opposite signs may differ from
torch's, which never changes a sum that starts at +0 (U and C).  ``exp``,
``log``, ``tanh`` and ``sigmoid`` (``1 / (1 + exp(-x))``) take CUDA's
``expf`` / ``logf`` / ``tanhf``: within a few ulp of torch's, not bitwise.

Scalars.  A Python number in the trace (a closure constant such as
``1 / tau``) is the float32 that torch computes with: the value rounded to
float32, emitted as a hex-float literal (``__uint_as_float`` for inf and
nan), so no decimal round-trip moves a bit.  Each distinct set of
constants is a distinct functor, and so a distinct build.

The compiled key (:attr:`CompiledFunctor.key`) is a hash of the emitted
functor, so it depends on the expressions and the declared flags, not on
the functional's name: two registrations with the same callables share
one build, and new callables under an old name get a new one.
:func:`evaluate` runs the IR with torch ops on the CPU (the tests hold it
bitwise to the callables).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading

import numpy as np
import torch

__all__ = ["Node", "Program", "CompiledFunctor", "compile_functional",
           "trace", "evaluate", "emit_functor", "EXACT_OPS", "OPS"]

F32, BOOL = "float32", "bool"
_DTYPES = {torch.float32: F32, torch.bool: BOOL}


@dataclasses.dataclass(frozen=True)
class Node:
    """One IR value: ``op`` on the values ``args`` (indices of earlier
    nodes) with result ``dtype``; ``value`` holds an ``input``'s position,
    a ``const``'s number or a ``clamp``'s (lo, hi) bounds."""

    op: str
    args: tuple = ()
    dtype: str = F32
    value: object = None


@dataclasses.dataclass(frozen=True)
class Program:
    """One traced callable: its nodes in order and the node it returns
    (cast to float32 on return)."""

    nodes: tuple
    out: int

    def ops(self) -> tuple:
        return tuple(sorted({n.op for n in self.nodes} - {"input", "const"}))


# IR ops: their C++ spelling, on the arguments' C++ expressions
_UNARY = {"neg": "(-{0})", "abs": "fabsf({0})", "sqrt": "__fsqrt_rn({0})",
          "reciprocal": "__fdiv_rn(1.f, {0})", "exp": "expf({0})",
          "log": "logf({0})", "tanh": "tanhf({0})",
          "sigmoid": "__fdiv_rn(1.f, __fadd_rn(1.f, expf(-{0})))",
          "isnan": "({0} != {0})",
          "isinf": "(fabsf({0}) == __uint_as_float(0x7f800000u))"}
_BINARY = {"add": "__fadd_rn({0}, {1})", "sub": "__fsub_rn({0}, {1})",
           "mul": "__fmul_rn({0}, {1})", "div": "__fdiv_rn({0}, {1})",
           "minimum": "nan_min({0}, {1})", "maximum": "nan_max({0}, {1})",
           "lt": "({0} < {1})", "le": "({0} <= {1})", "gt": "({0} > {1})",
           "ge": "({0} >= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})"}
_LOGIC = {"and": "({0} & {1})", "or": "({0} | {1})", "xor": "({0} ^ {1})"}
_CMP = ("lt", "le", "gt", "ge", "eq", "ne")
# the ops whose CUDA spelling gives torch's bits on every input
EXACT_OPS = frozenset(set(_BINARY) | set(_LOGIC) | set(_UNARY)
                      | {"not", "where", "clamp", "cast"}) - {
    "exp", "log", "tanh", "sigmoid"}

# aten op (the overload packet's name) -> the IR lowering that takes it
OPS = ("add", "sub", "rsub", "mul", "div", "neg", "lt", "le", "gt", "ge",
       "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
       "logical_and", "logical_or", "logical_xor", "logical_not", "where",
       "scalar_tensor", "zeros_like", "ones_like", "full_like", "minimum",
       "maximum", "clamp", "clamp_min", "clamp_max", "abs", "isnan", "isinf",
       "_to_copy", "sqrt", "reciprocal", "pow", "exp", "log", "tanh",
       "sigmoid", "alias", "clone", "detach", "lift_fresh_copy")


class _Lowering:
    """Build one :class:`Program` from an aten graph."""

    def __init__(self, who: str):
        self.who = who
        self.nodes: list[Node] = []

    def unsupported(self, what: str) -> NotImplementedError:
        return NotImplementedError(
            f"weight functional {self.who}: {what} is outside the op table "
            "of repro_torch.kernels._functor (its callables cannot be "
            "compiled into the CUDA kernels)")

    def add(self, op, args=(), dtype=F32, value=None) -> int:
        self.nodes.append(Node(op, tuple(args), dtype, value))
        return len(self.nodes) - 1

    def const(self, v, dtype=F32) -> int:
        if dtype == BOOL:
            return self.add("const", (), BOOL, bool(v))
        return self.add("const", (), F32, float(np.float32(v)))

    def cast(self, i: int, dtype: str) -> int:
        return i if self.nodes[i].dtype == dtype else self.add(
            "cast", (i,), dtype)

    def arg(self, a, env) -> int:
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, bool):
            return self.const(a, BOOL)
        if isinstance(a, (int, float)):
            return self.const(a)
        raise self.unsupported(f"the argument {a!r}")

    def lower(self, gm) -> Program:
        env = {}
        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                val = node.meta.get("val")
                env[node] = self.add("input", (), _DTYPES[val.dtype],
                                     len(env))
            elif node.op == "call_function":
                env[node] = self.call(node, env)
            elif node.op == "output":
                (res,) = node.args
                if isinstance(res, (tuple, list)):
                    raise self.unsupported("a tuple of results")
                out = self.arg(res, env)
            else:
                raise self.unsupported(
                    f"a captured tensor constant ({node.target})")
        return Program(tuple(self.nodes), self.cast(out, F32))

    def call(self, node, env) -> int:
        target = node.target
        name = getattr(getattr(target, "overloadpacket", None), "__name__",
                       str(target))
        if name not in OPS:
            raise self.unsupported(f"the op {target}")
        val = node.meta.get("val")
        dtype = _DTYPES.get(getattr(val, "dtype", None))
        if dtype is None or tuple(getattr(val, "shape", (None,))) != ():
            raise self.unsupported(
                f"the op {target} with a {getattr(val, 'dtype', None)} "
                f"result of shape {tuple(getattr(val, 'shape', ()))}")
        args, kw = node.args, node.kwargs
        if name in ("_to_copy", "alias", "clone", "detach",
                    "lift_fresh_copy"):
            return self.cast(self.arg(args[0], env), dtype)
        if name == "scalar_tensor":
            return self.const(args[0], dtype)
        if name in ("zeros_like", "ones_like", "full_like"):
            v = {"zeros_like": 0.0, "ones_like": 1.0}.get(name)
            return self.const(args[1] if v is None else v, dtype)
        if name in ("add", "sub", "rsub"):
            if kw.get("alpha", 1) != 1 or len(args) > 2:
                raise self.unsupported(f"the op {target} with alpha != 1")
        if name == "div" and kw.get("rounding_mode") is not None:
            raise self.unsupported(f"the op {target} with a rounding mode")
        a = [self.arg(x, env) for x in args[:1]]
        if name in ("neg", "abs", "sqrt", "reciprocal", "exp", "log", "tanh",
                    "sigmoid"):
            return self._float_op(name, a, dtype, target)
        if name in ("isnan", "isinf"):
            return self.add(name, (self.cast(a[0], F32),), BOOL)
        if name in ("bitwise_not", "logical_not"):
            if name == "bitwise_not" and self.nodes[a[0]].dtype != BOOL:
                raise self.unsupported(f"the op {target} on a float")
            return self.add("not", (self.cast(a[0], BOOL),), BOOL)
        if name == "pow":
            e = args[1]
            if e == 2:
                x = self.cast(a[0], F32)
                return self.add("mul", (x, x), F32)
            if e == 0.5:
                return self._float_op("sqrt", a, dtype, target)
            raise self.unsupported(f"the op {target} with exponent {e!r}")
        if name in ("clamp", "clamp_min", "clamp_max"):
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            if name == "clamp_max":
                lo, hi = None, lo
            for b in (lo, hi):
                if b is not None and not isinstance(b, (int, float)):
                    raise self.unsupported(f"the op {target} with a tensor "
                                           "bound")
            bounds = tuple(None if b is None else float(np.float32(b))
                           for b in (lo, hi))
            return self._float_op("clamp", a, dtype, target, bounds)
        if name == "where":
            c = self.cast(a[0], BOOL)
            x, y = (self.cast(self.arg(v, env), dtype) for v in args[1:3])
            return self.add("where", (c, x, y), dtype)
        b = self.arg(args[1], env)
        a0 = a[0]
        if name == "rsub":
            a0, b = b, a0
            name = "sub"
        if name in _CMP:
            return self.add(name, (self.cast(a0, F32), self.cast(b, F32)),
                            BOOL)
        if name.startswith(("bitwise_", "logical_")):
            op = name.split("_", 1)[1]
            if name.startswith("bitwise_") and BOOL != self.nodes[a0].dtype:
                raise self.unsupported(f"the op {target} on a float")
            return self.add(op, (self.cast(a0, BOOL), self.cast(b, BOOL)),
                            BOOL)
        if dtype == BOOL:  # bool arithmetic: torch saturates add, mul is and
            if name in ("add", "mul"):
                return self.add("or" if name == "add" else "and", (a0, b),
                                BOOL)
            raise self.unsupported(f"the op {target} on bools")
        return self.add(name, (self.cast(a0, F32), self.cast(b, F32)), F32)

    def _float_op(self, name, a, dtype, target, value=None) -> int:
        if dtype != F32:
            raise self.unsupported(f"the op {target} with a {dtype} result")
        return self.add(name, (self.cast(a[0], F32),), F32, value)


def trace(fn, n_float: int, with_bool: bool, who: str) -> Program:
    """The :class:`Program` of ``fn`` on ``n_float`` 0-d float32 inputs
    (and a 0-d bool after them when ``with_bool``).  Raises
    ``NotImplementedError`` naming ``who`` and what could not be traced."""
    from torch.fx.experimental.proxy_tensor import make_fx

    args = [torch.zeros((), dtype=torch.float32) for _ in range(n_float)]
    if with_bool:
        args.append(torch.zeros((), dtype=torch.bool))
    try:
        gm = make_fx(fn, tracing_mode="fake")(*args)
    except NotImplementedError:
        raise
    except Exception as e:  # noqa: BLE001 - every trace failure says why
        what = ("a Python branch on a tensor's value (data-dependent)"
                if "data-dependent" in str(e) else
                f"a step that does not trace ({type(e).__name__}: "
                f"{str(e).splitlines()[0] if str(e) else ''})")
        raise NotImplementedError(
            f"weight functional {who}: {what} cannot be compiled into the "
            "CUDA kernels (repro_torch.kernels._functor)") from e
    return _Lowering(who).lower(gm)


# ---------------------------------------------------------------------------
# the C++ functor
# ---------------------------------------------------------------------------
def literal(v: float) -> str:
    """A float32 value as a C++ literal with no decimal round-trip."""
    bits = int(np.float32(v).view(np.uint32))
    if not math.isfinite(v):
        return f"__uint_as_float(0x{bits:08x}u)"
    mant, exp = float(np.float32(v)).hex().split("p")
    return mant.rstrip("0").rstrip(".") + "p" + exp + "f"


def _expr(p: Program, i: int, name) -> str:
    n = p.nodes[i]
    a = [name(j) for j in n.args]
    if n.op == "input":
        return f"a{n.value}"
    if n.op == "const":
        return ("true" if n.value else "false") if n.dtype == BOOL else \
            literal(n.value)
    if n.op == "cast":
        src = p.nodes[n.args[0]].dtype
        if src == n.dtype:
            return a[0]
        return f"({a[0]} ? 1.f : 0.f)" if n.dtype == F32 else \
            f"({a[0]} != 0.f)"
    if n.op in _UNARY:
        return _UNARY[n.op].format(*a)
    if n.op in _BINARY:
        return _BINARY[n.op].format(*a)
    if n.op in _LOGIC:
        return _LOGIC[n.op].format(*a)
    if n.op == "not":
        return f"(!{a[0]})"
    if n.op == "where":
        return f"({a[0]} ? {a[1]} : {a[2]})"
    if n.op == "clamp":
        lo, hi = n.value
        x = a[0]
        if lo is not None and hi is not None and lo <= hi:
            return f"clip({x}, {literal(lo)}, {literal(hi)})"
        # torch: min(max(x, lo), hi); nan passes through
        if lo is not None:
            x = f"({x} < {literal(lo)} ? {literal(lo)} : {x})"
        if hi is not None:
            x = f"({x} > {literal(hi)} ? {literal(hi)} : {x})"
        return x
    raise AssertionError(n.op)


def _body(p: Program) -> list[str]:
    lines = []
    for i, n in enumerate(p.nodes):
        ctype = "bool" if n.dtype == BOOL else "float"
        lines.append(f"    const {ctype} v{i} = "
                     f"{_expr(p, i, lambda j: f'v{j}')};")
    lines.append(f"    return v{p.out};")
    return lines


_PLACEHOLDER = "PALD_FUNCTOR_NAME"


def emit_functor(progs: dict, tiebreak: bool, name: str) -> str:
    """The C++ struct ``name`` (namespace ``pald``'s helpers in scope) of
    the programs ``{"focus": ..., "support": ..., "share": ...}``."""
    has_share = "share" in progs
    sig = {"focus": "float a0, float a1, float a2, const Params&",
           "support": "float a0, float a1, float a2, bool a3, const Params&",
           "share": "float a0, float a1, const Params&"}
    out = [f"struct {name} {{",
           f"  static constexpr bool kTiebreak = {str(tiebreak).lower()};",
           "  static constexpr bool kPredicated = false;",
           f"  static constexpr bool kHasShare = {str(has_share).lower()};"]
    for fn in ("focus", "support", "share"):
        if fn not in progs:
            continue
        out.append(f"  __device__ __forceinline__ static float {fn}("
                   f"{sig[fn]}) {{")
        out += _body(progs[fn])
        out.append("  }")
    out.append("};")
    return "\n".join(out) + "\n"


@dataclasses.dataclass(frozen=True)
class CompiledFunctor:
    """A functional compiled to C++: ``key`` (16 hex digits of the emitted
    functor's hash), ``struct`` (its C++ name), ``functor`` (the struct's
    source) and ``programs`` (the IR of each callable)."""

    name: str
    key: str
    struct: str
    functor: str
    programs: dict

    def header(self) -> str:
        """The header that the kernels' sources are built with
        (``-include``): the struct declared, ``pald_weights.cuh``, the
        struct defined.  Like the key, it does not depend on the name."""
        return ("// generated by repro_torch.kernels._functor\n"
                "#pragma once\n"
                f"namespace pald {{ struct {self.struct}; }}\n"
                '#include "pald_weights.cuh"\nnamespace pald {\n'
                f"{self.functor}}}  // namespace pald\n")


_lock = threading.Lock()
_compiled: dict = {}  # id(functional) -> (functional, CompiledFunctor)


def compile_functional(w) -> CompiledFunctor:
    """Trace, lower and emit the functional ``w`` (memoized on the
    instance).  Raises ``NotImplementedError`` naming ``w`` and the op
    that is outside the table."""
    with _lock:
        hit = _compiled.get(id(w))
        if hit is not None and hit[0] is w:
            return hit[1]
    who = repr(w.name)
    tb = bool(w.needs_index_tiebreak)
    progs = {
        "focus": trace(w.focus, 3, False, f"{who} (focus)"),
        "support": (trace(w.support, 3, True, f"{who} (support)") if tb else
                    trace(lambda a, b, c: w.support(a, b, c, None), 3, False,
                          f"{who} (support)")),
    }
    if w.share is not None:
        progs["share"] = trace(w.share, 2, False, f"{who} (share)")
    src = emit_functor(progs, tb, _PLACEHOLDER)
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    struct = f"UserWeight_{key}"
    out = CompiledFunctor(w.name, key, struct,
                          src.replace(_PLACEHOLDER, struct), progs)
    with _lock:
        _compiled[id(w)] = (w, out)
    return out


# ---------------------------------------------------------------------------
# the CPU evaluator
# ---------------------------------------------------------------------------
_TORCH_UNARY = {"neg": torch.neg, "abs": torch.abs, "sqrt": torch.sqrt,
                "reciprocal": torch.reciprocal, "exp": torch.exp,
                "log": torch.log, "tanh": torch.tanh,
                "sigmoid": torch.sigmoid, "isnan": torch.isnan,
                "isinf": torch.isinf, "not": torch.logical_not}
_TORCH_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                 "div": torch.div, "minimum": torch.minimum,
                 "maximum": torch.maximum, "lt": torch.lt, "le": torch.le,
                 "gt": torch.gt, "ge": torch.ge, "eq": torch.eq,
                 "ne": torch.ne, "and": torch.bitwise_and,
                 "or": torch.bitwise_or, "xor": torch.bitwise_xor}
_TORCH_DTYPES = {F32: torch.float32, BOOL: torch.bool}


def evaluate(p: Program, *inputs) -> torch.Tensor:
    """Run ``p`` on tensors (broadcast against each other) with torch ops:
    float32 result."""
    vals = []
    for n in p.nodes:
        a = [vals[j] for j in n.args]
        if n.op == "input":
            v = inputs[n.value]
        elif n.op == "const":
            v = torch.tensor(n.value, dtype=_TORCH_DTYPES[n.dtype])
        elif n.op == "cast":
            v = a[0].to(_TORCH_DTYPES[n.dtype])
        elif n.op in _TORCH_UNARY:
            v = _TORCH_UNARY[n.op](a[0])
        elif n.op in _TORCH_BINARY:
            v = _TORCH_BINARY[n.op](a[0], a[1])
        elif n.op == "where":
            v = torch.where(a[0], a[1], a[2])
        elif n.op == "clamp":
            v = torch.clamp(a[0], *n.value)
        else:
            raise AssertionError(n.op)
        vals.append(v)
    return vals[p.out]

"""Pluggable cohesion weight functionals, in PyTorch.

The counterpart of ``repro.core.weights``: PaLD's two passes are
parameterized by a pass-1 FOCUS weight and a pass-2 SUPPORT weight, and
a :class:`WeightFunctional` bundles the two, plus declared properties.
Every path of this package (plain torch tile bodies, oracles in
``kernels/ref.py``) calls the dispatchers :func:`focus_weight` /
:func:`support_weight`.  The bodies below repeat the reference's jnp
expressions op for op, so on the same float32 inputs they are bitwise
equal to it, the ``inf - inf = nan`` guards on +inf padding included.

The CUDA kernels cannot call a Python callable.  Each built-in family
therefore also carries a ``kernel_id`` and float ``kernel_params``: the
kernels (``csrc/pald_weights.cuh``) specialize on the id as a C++ functor
template and take the parameters as runtime floats.  A user-registered
functional has no id: :func:`kernel_spec` traces its callables and emits
them as a C++ functor (``kernels/_functor.py``), which the CUDA wrappers
build into kernel libraries of its own at first use
(``kernels/_build.py``) and launch under ``KERNEL_USER``, as the
reference traces a functional into its Pallas bodies.  Its closure
constants are baked into the functor, so each distinct set of them is one
build.  A callable that uses an op outside the compiler's table, or
branches on a tensor's value, raises ``NotImplementedError`` on the card
(the plain torch paths take any callable).

Declared properties (same meaning as in the reference):

``needs_index_tiebreak``
    the support weight inspects ``own_wins`` (global x index > y index).
``conserves_mass``
    every pair with a nonempty focus distributes total weight 1.
``is_strict``
    both weights are 0/1 indicators, so U is an integer count.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

TIE_MODES = ("drop", "split", "ignore")
DEFAULT_TIES = "drop"

__all__ = [
    "TIE_MODES", "DEFAULT_TIES", "WeightFunctional", "register_weight",
    "registered_weights", "resolve_weight", "validate_ties",
    "focus_weight", "support_weight", "index_xwins", "kernel_spec",
    "KernelSpec", "KERNEL_USER",
    "soft_threshold", "kernelized", "DROP", "SPLIT", "IGNORE",
]

# kernel ids of the built-in families: the switch in csrc/pald_focus.cu and
# csrc/pald_cohesion.cu maps each onto its functor in csrc/pald_weights.cuh
KERNEL_DROP, KERNEL_SPLIT, KERNEL_IGNORE, KERNEL_SOFT, KERNEL_KERNELIZED = range(5)
# the id of a user functional's generated functor (its own libraries)
KERNEL_USER = 5


@dataclasses.dataclass(frozen=True)
class WeightFunctional:
    """One member of the generalized-PaLD family (module docstring).

    Frozen and hashable; parametrized families memoize their factories so
    equal parameters return the same instance.  ``kernel_id`` /
    ``kernel_params`` name the CUDA functor and its runtime floats (None /
    () for a functional the kernels do not know).
    """

    name: str
    focus: Callable = dataclasses.field(compare=False)
    support: Callable = dataclasses.field(compare=False)
    share: Callable | None = dataclasses.field(default=None, compare=False)
    needs_index_tiebreak: bool = False
    conserves_mass: bool = False
    is_strict: bool = False
    kernel_id: int | None = None
    kernel_params: tuple = ()

    def properties(self) -> dict:
        """The declared-property dict ``plan.explain()`` reports."""
        return {
            "name": self.name,
            "needs_index_tiebreak": self.needs_index_tiebreak,
            "conserves_mass": self.conserves_mass,
            "is_strict": self.is_strict,
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, WeightFunctional] = {}


def register_weight(w: WeightFunctional,
                    overwrite: bool = False) -> WeightFunctional:
    """Register ``w`` under its name so ``weight="<name>"`` resolves to it."""
    if not overwrite and w.name in _REGISTRY and _REGISTRY[w.name] is not w:
        raise ValueError(f"weight functional {w.name!r} already registered")
    _REGISTRY[w.name] = w
    return w


def registered_weights() -> tuple:
    """Sorted names of every registered weight functional."""
    return tuple(sorted(_REGISTRY))


def resolve_weight(weight) -> WeightFunctional:
    """Resolve a ``weight=`` / ``ties=`` spec: an instance (unchanged), a
    registered name, or ``None`` (the default, ``drop``).  Unknown names
    raise a ``ValueError`` enumerating every registered functional."""
    if weight is None:
        return _REGISTRY[DEFAULT_TIES]
    if isinstance(weight, WeightFunctional):
        return weight
    try:
        return _REGISTRY[weight]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown weight functional {weight!r} "
            f"(registered: {registered_weights()})") from None


def validate_ties(ties) -> str:
    """Validate a ``ties=`` mode (sugar for the three built-ins)."""
    if isinstance(ties, WeightFunctional):
        ties = ties.name
    if ties not in TIE_MODES:
        raise ValueError(
            f"unknown ties mode {ties!r} (expected one of {TIE_MODES}; "
            f"for the full family use weight= with one of "
            f"{registered_weights()})")
    return ties


class KernelSpec(tuple):
    """(kernel id, p0, p1) of a functional for the CUDA kernels, and
    ``functor``: None for a built-in family, else the user functional's
    ``kernels._functor.CompiledFunctor`` (whose libraries the wrappers
    load); ``key`` is its compiled key."""

    def __new__(cls, wid: int, p0: float, p1: float, functor=None):
        self = super().__new__(cls, (wid, p0, p1))
        self.functor = functor
        return self

    @property
    def key(self) -> str | None:
        return None if self.functor is None else self.functor.key


def kernel_spec(weight) -> KernelSpec:
    """(kernel id, p0, p1) of a functional for the CUDA kernels.

    A built-in family gives its id and parameters.  A functional without
    a kernel id gives ``KERNEL_USER`` and its compiled functor (traced and
    emitted once per instance, ``kernels/_functor.py``); an op outside the
    compiler's table, or a branch on a tensor's value, raises
    ``NotImplementedError`` naming the functional and the op.
    """
    w = resolve_weight(weight)
    if w.kernel_id is None:
        from repro_torch.kernels._functor import compile_functional

        return KernelSpec(KERNEL_USER, 0.0, 0.0, compile_functional(w))
    p = tuple(float(v) for v in w.kernel_params) + (0.0, 0.0)
    return KernelSpec(w.kernel_id, p[0], p[1])


# ---------------------------------------------------------------------------
# the three built-ins: the reference's jnp expressions, op for op
# ---------------------------------------------------------------------------
def _focus_strict(dxz, dyz, dxy):
    return ((dxz < dxy) | (dyz < dxy)).to(torch.float32)


def _focus_split(dxz, dyz, dxy):
    strict = (dxz < dxy) | (dyz < dxy)
    eq = (dxz == dxy) | (dyz == dxy)
    return torch.where(strict, 1.0, torch.where(eq, 0.5, 0.0)).to(
        torch.float32)


def _support_drop(d_own, d_other, d_pair, own_wins=None):
    lt = d_own < d_other
    memb = d_own < d_pair
    return (lt & memb).to(torch.float32)


def _support_ignore(d_own, d_other, d_pair, own_wins=None):
    if own_wins is None:
        raise ValueError("ties='ignore' needs own_wins (index tiebreak)")
    lt = d_own < d_other
    memb = d_own < d_pair
    return ((lt | ((d_own == d_other) & own_wins)) & memb).to(torch.float32)


def _support_split(d_own, d_other, d_pair, own_wins=None):
    lt = d_own < d_other
    memb = d_own < d_pair
    share = lt.to(torch.float32) + 0.5 * (d_own == d_other).to(torch.float32)
    half = memb.to(torch.float32) + 0.5 * (d_own == d_pair).to(torch.float32)
    return share * half


DROP = register_weight(WeightFunctional(
    "drop", _focus_strict, _support_drop, is_strict=True,
    kernel_id=KERNEL_DROP))
SPLIT = register_weight(WeightFunctional(
    "split", _focus_split, _support_split, conserves_mass=True,
    kernel_id=KERNEL_SPLIT))
IGNORE = register_weight(WeightFunctional(
    "ignore", _focus_strict, _support_ignore,
    needs_index_tiebreak=True, conserves_mass=True, is_strict=True,
    kernel_id=KERNEL_IGNORE))


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------
def focus_weight(dxz, dyz, dxy, ties=DEFAULT_TIES):
    """Pass-1 membership weight of z in the (x, y) local focus."""
    return resolve_weight(ties).focus(dxz, dyz, dxy)


def support_weight(d_own, d_other, d_pair, ties=DEFAULT_TIES, own_wins=None):
    """Pass-2 weight with which z supports the 'own' point of a pair."""
    return resolve_weight(ties).support(d_own, d_other, d_pair, own_wins)


def index_xwins(row_off, nrows: int, col_off, ncols: int,
                device=None) -> torch.Tensor:
    """(nrows, ncols) bool "global x index > global y index" tiebreak,
    derived from the row and column offsets (never a dense (n, n) form)."""
    rows = row_off + torch.arange(nrows, device=device)
    cols = col_off + torch.arange(ncols, device=device)
    return rows[:, None] > cols[None, :]


# ---------------------------------------------------------------------------
# parametrized families
# ---------------------------------------------------------------------------
def _sigmoid(x):
    """Smoothstep sigmoid ``0.5 + x*(0.5 - |x|/8)`` on ``clip(x, -2, 2)``;
    saturates to exactly 0.0 / 1.0, and a nan input stays nan for the
    caller's guard (``torch.clamp`` propagates nan, like ``jnp.clip``)."""
    x = torch.clamp(x, -2.0, 2.0)
    return 0.5 + x * (0.5 - 0.125 * torch.abs(x))


def _safe_unit(diff, inv, tie=0.5):
    """sigmoid(diff * inv) with the inf - inf = nan case pinned to ``tie``."""
    s = _sigmoid(diff * inv)
    return torch.where(torch.isnan(diff), tie, s)


@functools.lru_cache(maxsize=None)
def soft_threshold(tau: float = 0.1) -> WeightFunctional:
    """Sigmoid focus/support with temperature ``tau`` (the reference's
    ``soft_threshold``): membership ``sigmoid((d_pair - min(d_xz, d_yz)) /
    tau)``, support share ``clip(0.5 + (d_other - d_own) / (4 tau), 0, 1)``.
    Conserves mass; recovers ``split`` as tau -> 0.  Memoized on tau."""
    inv = 1.0 / float(tau)
    quarter = 0.25 * inv

    def focus(dxz, dyz, dxy):
        return _safe_unit(dxy - torch.minimum(dxz, dyz), inv, tie=0.0)

    def share(d_own, d_other):
        return torch.clamp(0.5 + (d_other - d_own) * quarter, 0.0, 1.0)

    def support(d_own, d_other, d_pair, own_wins=None):
        memb = _sigmoid((d_pair - torch.minimum(d_own, d_other)) * inv)
        res = share(d_own, d_other) * memb
        return torch.where(torch.isnan(res), 0.0, res)

    name = "soft" if float(tau) == 0.1 else f"soft@{float(tau):g}"
    return WeightFunctional(name, focus, support, share=share,
                            conserves_mass=True, kernel_id=KERNEL_SOFT,
                            kernel_params=(inv, quarter))


@functools.lru_cache(maxsize=None)
def kernelized(gamma: float = 1.0) -> WeightFunctional:
    """Strict focus, Gaussian-kernelized support shares ``sigmoid((d_other^2
    - d_own^2) / gamma^2)`` (the reference's ``kernelized``).  Does not
    conserve mass.  Memoized on gamma."""
    inv = 1.0 / (float(gamma) * float(gamma))

    def support(d_own, d_other, d_pair, own_wins=None):
        memb = d_own < d_pair
        share = _safe_unit(d_other * d_other - d_own * d_own, inv)
        return torch.where(memb, share, 0.0).to(torch.float32)

    name = ("kernelized" if float(gamma) == 1.0
            else f"kernelized@{float(gamma):g}")
    return WeightFunctional(name, _focus_strict, support,
                            kernel_id=KERNEL_KERNELIZED, kernel_params=(inv,))


register_weight(soft_threshold())
register_weight(kernelized())

"""Compatibility names over the weight-functional subsystem.

The counterpart of ``repro.core.ties``: the historical ``ties=`` modes are
the three built-in members of the weight-functional family in
``core/weights.py``; this module only re-exports the stable names.
"""
from __future__ import annotations

from .weights import (  # noqa: F401
    DEFAULT_TIES,
    TIE_MODES,
    WeightFunctional,
    focus_weight,
    index_xwins,
    resolve_weight,
    support_weight,
    validate_ties,
)

__all__ = ["TIE_MODES", "DEFAULT_TIES", "WeightFunctional", "validate_ties",
           "focus_weight", "support_weight", "index_xwins", "resolve_weight"]

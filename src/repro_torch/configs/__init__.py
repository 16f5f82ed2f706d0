"""Architecture configs (one module per assigned arch) + registry
(counterpart of ``repro.configs``).

``get(arch_id)`` resolves an assigned-pool id like ``"qwen2.5-14b"`` to its
``ModelConfig``; ``ARCHS`` lists all ten.  ``reduced(get(id))`` gives the
same-family smoke config used by the per-arch CPU tests.
"""
from __future__ import annotations

from .base import (  # noqa: F401
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    reduced,
    runnable,
)

from . import (  # noqa: E402
    gemma2_2b,
    gemma2_9b,
    granite_moe_1b,
    internvl2_1b,
    jamba15_398b,
    llama32_3b,
    mamba2_780m,
    musicgen_medium,
    phi35_moe_42b,
    qwen25_14b,
)

_MODULES = (
    phi35_moe_42b,
    granite_moe_1b,
    mamba2_780m,
    qwen25_14b,
    llama32_3b,
    gemma2_2b,
    gemma2_9b,
    jamba15_398b,
    musicgen_medium,
    internvl2_1b,
)

REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCHS: tuple[str, ...] = tuple(REGISTRY)


def get(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCHS)}"
        ) from None

"""LM substrate of the port: layers, MoE, Mamba2, the generic decoder, the
model facade and the weight mapping to the reference's param tree
(counterpart of ``repro.models``)."""
from . import convert, layers, mamba2, model, moe, transformer  # noqa: F401

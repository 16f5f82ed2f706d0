"""PyTorch/CUDA port of the PaLD reproduction.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``) so each module has a counterpart there, runs on
an NVIDIA GPU through hand-written CUDA kernels (``csrc/``), and imports
neither JAX nor ``repro``.
"""

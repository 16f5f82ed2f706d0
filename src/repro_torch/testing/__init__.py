"""Test-support utilities shipped with the port (counterpart of
``repro.testing``).

``repro_torch.testing.faults`` is the fault-injection harness: context
managers that arm the named fault points threaded through the engine and
the kernel entry points (``core/resilience.fault_point``) and simulate
running out of memory; the machinery behind ``tests/test_torch_faults.py``.
"""
from . import faults  # noqa: F401

__all__ = ["faults"]

"""Test-support utilities shipped with the port (counterpart of
``repro.testing``).

``repro_torch.testing.faults`` is the fault-injection harness: context
managers that arm the named fault points threaded through the engine and
the kernel entry points (``core/resilience.fault_point``) and simulate
running out of memory; the machinery behind ``tests/test_torch_faults.py``.
``repro_torch.testing.world`` starts local ``torch.distributed`` worlds of
spawned ranks (one device shared), the machinery behind the distributed
tests, the self-test and the tuner's mesh cell.
"""
from . import faults  # noqa: F401

__all__ = ["faults"]

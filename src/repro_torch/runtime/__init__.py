"""Run-time policies over a device mesh (counterpart of ``repro.runtime``)."""

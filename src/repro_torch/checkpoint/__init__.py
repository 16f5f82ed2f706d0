"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""

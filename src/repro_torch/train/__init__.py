"""Serving steps of the port (counterpart of ``repro.train``; the training
step comes with the training slice, ROADMAP.md queue 1, item 12b)."""

"""Training and serving steps of the port (counterpart of ``repro.train``):
the train step on one device (``train_step.py``) and the serving steps
(``serve_step.py``).  Training sharded over a mesh is ROADMAP.md queue 1,
item 12b."""

"""Training and serving steps of the port (counterpart of ``repro.train``):
the train step on one device or sharded over a mesh (``train_step.py``)
and the serving steps (``serve_step.py``)."""

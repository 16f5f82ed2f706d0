"""Launch helpers of the port (counterpart of ``repro.launch``): device
meshes over ``torch.distributed`` (``mesh.py``), the analytic cost model of
distributed PaLD (``dryrun_pald.py``), the LM serving and training
drivers (``serve.py``, ``train.py``) and the self-test (``selftest.py``)."""

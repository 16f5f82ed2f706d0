"""Launch helpers of the port (counterpart of ``repro.launch``): device
meshes over ``torch.distributed`` (``mesh.py``), the analytic cost model of
distributed PaLD (``dryrun_pald.py``), the LM serving driver
(``serve.py``) and the self-test (``selftest.py``)."""

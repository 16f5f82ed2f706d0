"""Launch helpers of the port (counterpart of ``repro.launch``): device
meshes over ``torch.distributed`` (``mesh.py``), the dry run of the LM
cells (``dryrun.py`` over ``specs.py`` and ``cost_analysis.py``) and of
distributed PaLD (``dryrun_pald.py``), the LM serving and training
drivers (``serve.py``, ``train.py``) and the self-test (``selftest.py``)."""

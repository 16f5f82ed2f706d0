"""The port's examples, each run as ``python -m repro_torch.examples.<name>``
(counterparts of the scripts under ``examples/``): ``quickstart``,
``pald_knn_clusters``, ``pald_text_analysis`` and ``serve_lm``."""

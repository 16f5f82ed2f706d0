"""Persistent block-size and method tuning of the port (counterpart of
``repro.tuning``): ``autotune`` is the cache and the tuner, ``hillclimb``
its command line (``python -m repro_torch.tuning.hillclimb``)."""
from .autotune import (  # noqa: F401
    backend_of,
    cache_path,
    load_cache,
    lookup,
    lookup_nearest,
    method_for,
    method_for_ex,
    random_distance_matrix,
    resolve_blocks,
    resolve_blocks_ex,
    save_entry,
    time_fn,
    tune,
    tune_methods,
)

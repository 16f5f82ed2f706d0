"""PaLD core of the PyTorch/CUDA port: weights, engine, facades, oracles."""
from . import analysis, engine, features, knn, pairwise, pald, reference, triplet  # noqa: F401
from .features import cdist_reference  # noqa: F401
from .pald import cohesion, from_features, local_depths, plan  # noqa: F401

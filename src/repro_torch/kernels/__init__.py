"""CUDA kernels of the port, their wrappers, plain versions and entry
points."""

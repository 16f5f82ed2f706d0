"""PaLD core of the PyTorch/CUDA port: weights, engine, facades, oracles."""

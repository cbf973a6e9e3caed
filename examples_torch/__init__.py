"""Examples of the PyTorch/CUDA port, one beside each of ``examples/``."""

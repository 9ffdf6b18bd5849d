"""Kernel wrappers of the port: hand-written CUDA on the card, their plain
PyTorch versions on CPU tensors."""

"""Operators of the port: frozen BatchNorm (`norm`) and the hand-written
CUDA kernels with their plain PyTorch versions (`kernels`)."""

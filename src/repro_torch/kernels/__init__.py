"""The port's CIM kernels: hand-written CUDA in ``csrc/``, their wrappers,
their plain PyTorch versions (``ref``) and the dispatch (``ops``)."""

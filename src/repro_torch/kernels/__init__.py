"""Kernels of the port: hand-written CUDA for Hopper plus their plain
PyTorch versions (``ref``) and the dispatch (``ops``).

Importing this package builds nothing: the CUDA library is compiled at
the first launch on a CUDA tensor.
"""

"""Kernels of the port: hand-written CUDA for Hopper plus their plain
PyTorch versions (``ref``) and the dispatch (``ops``).

Importing this package builds nothing: the CUDA libraries are compiled
(:mod:`.build`) at the first launch on a CUDA tensor.
"""

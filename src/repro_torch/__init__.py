"""PyTorch/CUDA port of the InfiniPipe reproduction (serving, and
training on one card or pipelined over stages).

Mirrors the JAX package's module names (``configs``, ``core``, ``models``,
``kernels``, ``optim``, ``runtime``, ``serve``, ``data``, ``launch``). Imports
``torch`` and numpy only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; see ``README.md`` in this directory.
"""

"""PyTorch/CUDA port of the InfiniPipe reproduction (serving slice).

Mirrors the JAX package's module names (``configs``, ``core``, ``models``,
``kernels``, ``runtime``, ``serve``, ``data``, ``launch``). Imports
``torch`` and numpy only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; see ``README.md`` in this directory.
"""

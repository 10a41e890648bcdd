"""Hopper streaming cross-entropy kernels: load and launch wrappers.

Replace the JAX package's Pallas TPU kernels of
``kernels/cross_entropy.py``: ``cross_entropy_fwd_pallas`` (B),
``cross_entropy_bwd_dh_pallas`` (C1) and ``cross_entropy_bwd_dw_pallas``
(C2). The kernels are CUDA C++ for ``sm_90a`` in ``csrc/cross_entropy.cu``
(its header sets out the design and what bounds them), built at first use
by :mod:`.build` and called through ``ctypes`` on PyTorch's current
stream. The ``[T, V]`` logits are never stored: B folds each vocab tile
into per-token ``(lse, target logit)``, C1 and C2 recompute the tile and
contract ``(softmax - onehot) * g`` at once.

One wrapper and one launch count per kernel: :data:`ce_fwd_cuda`,
:data:`ce_bwd_dh_cuda`, :data:`ce_bwd_dw_cuda`. They take CUDA tensors with
``T`` a multiple of :data:`TOKEN_MULTIPLE` and ``D`` of 32 and raise on
anything else; padding, the autograd function and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`, the plain versions in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

from .build import load_libraries

__all__ = ["TOKEN_MULTIPLE", "VOCAB_TILE", "MAX_VSPLIT", "DS_MAX",
           "CrossEntropyKernel", "ce_fwd_cuda", "ce_bwd_dh_cuda",
           "ce_bwd_dw_cuda", "load_library", "vocab_splits", "d_slices"]

TOKEN_MULTIPLE = 64     # tokens are padded to this (csrc: 2 * R)
VOCAB_TILE = 64         # vocab entries per logits tile (csrc: C)
MAX_VSPLIT = 64         # vocab splits per token tile in B (csrc: MAX_VSPLIT)
DS_MAX = 1152           # accumulator columns per block in C1/C2 (csrc)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclass(frozen=True)
class CrossEntropyLibrary:
    path: Path
    build_log: str
    fwd: ctypes._CFuncPtr
    bwd: ctypes._CFuncPtr


@functools.lru_cache(maxsize=None)
def load_library() -> CrossEntropyLibrary:
    """The cross-entropy library (built with the others at first use)."""
    built = load_libraries()["cross_entropy"]
    lib = built.lib
    for name, want in (("cross_entropy_token_multiple", TOKEN_MULTIPLE),
                       ("cross_entropy_vocab_tile", VOCAB_TILE),
                       ("cross_entropy_max_vsplit", MAX_VSPLIT),
                       ("cross_entropy_ds_max", DS_MAX)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"{built.path.name}: {name}() = {fn()} but "
                               f"the wrapper expects {want}")
    fwd = lib.cross_entropy_fwd
    fwd.argtypes, fwd.restype = [_P] * 7 + [_I] * 5 + [_P], _I
    bwd = lib.cross_entropy_bwd
    bwd.argtypes, bwd.restype = [_P] * 6 + [_I] * 6 + [_P], _I
    return CrossEntropyLibrary(path=built.path, build_log=built.build_log,
                               fwd=fwd, bwd=bwd)


def vocab_splits(T: int, V: int, n_sm: int) -> int:
    """Vocab splits per token tile of B: enough blocks for two per SM,
    at most one split per vocab tile and at most MAX_VSPLIT."""
    tiles = T // 32
    n_vt = -(-V // VOCAB_TILE)
    return max(1, min(MAX_VSPLIT, n_vt, -(-2 * n_sm // tiles)))


def d_slices(D: int) -> int:
    """D slices of C1/C2 (the logits recompute factor): ceil(D / DS_MAX)."""
    return -(-D // DS_MAX)


def _check(hidden, w, targets, *extra) -> Tuple[int, int, int]:
    ts = (hidden, w, targets, *extra)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in ts):
        raise ValueError("the cross-entropy kernels take CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("cross-entropy kernel: tensors on different devices")
    if hidden.dtype not in _DTYPE_CODE or w.dtype != hidden.dtype:
        raise ValueError(f"hidden and w must share one dtype of "
                         f"{list(_DTYPE_CODE)}, got {hidden.dtype}, {w.dtype}")
    if hidden.dim() != 2 or w.dim() != 2 or hidden.shape[1] != w.shape[1]:
        raise ValueError(f"hidden {tuple(hidden.shape)} and w "
                         f"{tuple(w.shape)} must be [T, D] and [V, D]")
    T, D = hidden.shape
    V = w.shape[0]
    if T == 0 or T % TOKEN_MULTIPLE or D == 0 or D % 32 or V == 0:
        raise ValueError(f"T={T} must be a positive multiple of "
                         f"{TOKEN_MULTIPLE} and D={D} of 32 (ops pads T)")
    if targets.dtype != torch.int32 or tuple(targets.shape) != (T,):
        raise ValueError(f"targets must be int32 [{T}]")
    for t in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != (T,):
            raise ValueError(f"lse and g must be float32 [{T}]")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the cross-entropy kernels take contiguous tensors")
    if hidden.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("hidden and w must start on a 16-byte boundary")
    return T, V, D


class CrossEntropyKernel:
    """Launch wrapper of one cross-entropy kernel; ``launches`` counts its
    launches.

    * ``"fwd"`` (B): ``(hidden, w, targets) -> (lse, tgt_logit)``;
    * ``"dh"`` (C1): ``(hidden, w, targets, lse, g) -> dh [T, D]`` in
      hidden's dtype;
    * ``"dw"`` (C2): the same inputs ``-> dW [V, D]`` in w's dtype.
    """

    def __init__(self, which: str) -> None:
        if which not in ("fwd", "dh", "dw"):
            raise ValueError(f"unknown cross-entropy kernel {which!r}")
        self.which = which
        self.launches = 0

    def __call__(self, hidden, w, targets, *lse_g):
        if self.which == "fwd":
            return self._fwd(hidden, w, targets)
        return self._bwd(hidden, w, targets, *lse_g)

    def _fwd(self, hidden, w, targets):
        T, V, D = _check(hidden, w, targets)
        dev = hidden.device
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = vocab_splits(T, V, n_sm)
        lse = torch.empty(T, dtype=torch.float32, device=dev)
        tl = torch.empty(T, dtype=torch.float32, device=dev)
        ws = arrivals = None
        if n_split > 1:
            ws = torch.empty((n_split, T, 3), dtype=torch.float32, device=dev)
            arrivals = torch.zeros(T // 32, dtype=torch.int32, device=dev)
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.fwd(hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
                         lse.data_ptr(), tl.data_ptr(),
                         ws.data_ptr() if ws is not None else None,
                         arrivals.data_ptr() if arrivals is not None else None,
                         T, V, D, _DTYPE_CODE[hidden.dtype], n_split, stream)
        if rc != 0:
            raise RuntimeError(f"ce_fwd_kernel launch failed with cudaError "
                               f"{rc} (T={T}, V={V}, D={D}, {hidden.dtype}, "
                               f"n_split={n_split})")
        self.launches += 1
        return lse, tl

    def _bwd(self, hidden, w, targets, lse, g):
        T, V, D = _check(hidden, w, targets, lse, g)
        dw = self.which == "dw"
        out = torch.empty_like(w if dw else hidden)
        lib = load_library()
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        with torch.cuda.device(hidden.device):
            rc = lib.bwd(hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
                         lse.data_ptr(), g.data_ptr(), out.data_ptr(), T, V, D,
                         _DTYPE_CODE[hidden.dtype], int(dw), d_slices(D),
                         stream)
        if rc != 0:
            raise RuntimeError(f"ce_bwd_kernel<{self.which}> launch failed "
                               f"with cudaError {rc} (T={T}, V={V}, D={D}, "
                               f"{hidden.dtype})")
        self.launches += 1
        return out


ce_fwd_cuda = CrossEntropyKernel("fwd")
ce_bwd_dh_cuda = CrossEntropyKernel("dh")
ce_bwd_dw_cuda = CrossEntropyKernel("dw")

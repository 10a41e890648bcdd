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

bf16 inputs run B, C1 and C2 on the tensor cores (``ce_fwd_mma_kernel``,
``ce_bwd_dh_mma_kernel``, ``ce_bwd_dw_mma_kernel``: bf16 ``mma.sync`` with
float32 sums; C1 and C2 are one cluster design with the roles of h and W
swapped, and round their coefficient to bf16 as the second product's
operand); float32 inputs run the float32 FMA kernels (``ce_fwd_kernel``,
``ce_bwd_kernel<dh>``, ``ce_bwd_kernel<dw>``), which serve the float32
verify phases.

One wrapper and one launch count per function: :data:`ce_fwd_cuda`,
:data:`ce_bwd_dh_cuda`, :data:`ce_bwd_dw_cuda`; ``by_kernel`` splits each
count by the ``__global__`` kernel launched. They take CUDA tensors with
``T`` a multiple of :data:`TOKEN_MULTIPLE` and ``D`` of 32 and raise on
anything else; padding, the autograd function and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`, the plain versions in
:mod:`repro_torch.kernels.ref`. The wrappers hand the kernels the
number of vocab splits of B (:func:`vocab_splits`) and the D slice width
of C1 and C2 (:func:`d_slice_width`); each kernel derives its own vocab
and D ranges from them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import torch

from . import meta
from .build import load_libraries

__all__ = ["TOKEN_MULTIPLE", "VOCAB_TILE", "MAX_VSPLIT", "DS_MAX",
           "FWD_TOKEN_TILE", "MMA_VOCAB_TILE", "DH_SLICE_MULTIPLE",
           "DH_SLICE_MAX", "DH_SLICE_WIDE", "DH_MAX_SLICES", "DH_PORTABLE",
           "CrossEntropyKernel", "ce_fwd_cuda", "ce_bwd_dh_cuda",
           "ce_bwd_dw_cuda", "KERNELS", "load_library", "vocab_splits",
           "d_slice_width", "max_active_clusters"]

TOKEN_MULTIPLE = 64     # tokens are padded to this (csrc: 2 * R)
VOCAB_TILE = 64         # vocab entries per logits tile, float32 (csrc: C)
MAX_VSPLIT = 64         # vocab splits per token tile in B (csrc: MAX_VSPLIT)
DS_MAX = 1152           # accumulator columns per block in C1/C2 (csrc)
# tokens per block of B: float32 32 (csrc: R), bf16 128 (csrc: FB_T)
FWD_TOKEN_TILE = {torch.float32: 32, torch.bfloat16: 128}
MMA_VOCAB_TILE = 128    # vocab entries per tile of the bf16 B
# bf16 C1 and C2: one CTA of a cluster per D slice of at most DH_SLICE_MAX
# columns (a multiple of DH_SLICE_MULTIPLE), at most DH_MAX_SLICES a
# cluster: D <= 6,144. Slices of up to DH_SLICE_WIDE columns where 384
# would need more than DH_PORTABLE CTAs and DH_SLICE_WIDE needs no more.
DH_SLICE_MULTIPLE, DH_SLICE_MAX, DH_MAX_SLICES = 64, 384, 16
DH_SLICE_WIDE, DH_PORTABLE = 448, 8
# the ``__global__`` kernel each wrapper launches, by the inputs' dtype
KERNELS = {"fwd": {torch.float32: "ce_fwd_kernel",
                   torch.bfloat16: "ce_fwd_mma_kernel"},
           "dh": {torch.float32: "ce_bwd_kernel<dh>",
                  torch.bfloat16: "ce_bwd_dh_mma_kernel"},
           "dw": {torch.float32: "ce_bwd_kernel<dw>",
                  torch.bfloat16: "ce_bwd_dw_mma_kernel"}}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclass(frozen=True)
class CrossEntropyLibrary:
    path: Path
    build_log: str
    fwd: ctypes._CFuncPtr
    bwd: ctypes._CFuncPtr
    occupancy: ctypes._CFuncPtr


@functools.lru_cache(maxsize=None)
def load_library() -> CrossEntropyLibrary:
    """The cross-entropy library (built with the others at first use)."""
    built = load_libraries()["cross_entropy"]
    lib = built.lib
    for name, want in (("cross_entropy_token_multiple", TOKEN_MULTIPLE),
                       ("cross_entropy_vocab_tile", VOCAB_TILE),
                       ("cross_entropy_max_vsplit", MAX_VSPLIT),
                       ("cross_entropy_ds_max", DS_MAX),
                       ("cross_entropy_fwd_mma_token_tile",
                        FWD_TOKEN_TILE[torch.bfloat16]),
                       ("cross_entropy_mma_vocab_tile", MMA_VOCAB_TILE),
                       ("cross_entropy_dh_mma_slice_multiple",
                        DH_SLICE_MULTIPLE),
                       ("cross_entropy_dh_mma_slice_max", DH_SLICE_MAX),
                       ("cross_entropy_dh_mma_slice_wide", DH_SLICE_WIDE),
                       ("cross_entropy_dh_mma_max_slices", DH_MAX_SLICES)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"{built.path.name}: {name}() = {fn()} but "
                               f"the wrapper expects {want}")
    fwd = lib.cross_entropy_fwd
    fwd.argtypes, fwd.restype = [_P] * 7 + [_I] * 5 + [_P], _I
    bwd = lib.cross_entropy_bwd
    bwd.argtypes, bwd.restype = [_P] * 6 + [_I] * 6 + [_P], _I
    occ = lib.cross_entropy_bwd_max_active_clusters
    occ.argtypes, occ.restype = [_I] * 3 + [ctypes.POINTER(_I)], _I
    return CrossEntropyLibrary(path=built.path, build_log=built.build_log,
                               fwd=fwd, bwd=bwd, occupancy=occ)


def _vocab_tile(dtype) -> int:
    return MMA_VOCAB_TILE if dtype == torch.bfloat16 else VOCAB_TILE


def vocab_splits(T: int, V: int, n_sm: int,
                 dtype=torch.bfloat16) -> int:
    """Vocab splits per token tile of B.

    float32 (32-token tiles, one block per SM at a time): enough blocks
    for two per SM. bf16 (128-token tiles, two blocks per SM): at least
    ``ceil(sqrt(2 n_sm))`` as well, so that the blocks resident at once
    (token tile ``b // S``, split ``b % S``) hold few h tiles and few W
    ranges, which then stay in L2. At most one split per vocab tile and at
    most MAX_VSPLIT."""
    slots = 2 * n_sm
    tiles = -(-T // FWD_TOKEN_TILE[dtype])
    n_vt = -(-V // _vocab_tile(dtype))
    want = -(-slots // tiles)
    if dtype == torch.bfloat16:
        want = max(want, math.isqrt(slots - 1) + 1)
    return max(1, min(MAX_VSPLIT, n_vt, want))


def d_slice_width(D: int, dtype=torch.bfloat16) -> int:
    """Columns per D slice of C1/C2.

    float32: ``ceil(D / DS_MAX)`` slices of equal width rounded up to 32;
    each block recomputes the logits over all of D (the recompute factor is
    the number of slices). bf16 C1 and C2: slices of at most DH_SLICE_MAX
    columns, equal widths rounded up to DH_SLICE_MULTIPLE; the slices of a
    token tile (C1) or of a tile of 64 vocabulary entries (C2) are the CTAs
    of one cluster, each computing the logits over its own columns only.
    Where that takes more than DH_PORTABLE slices and DH_SLICE_WIDE columns
    take no more (3,072 < D <= 3,584), slices of up to DH_SLICE_WIDE: the
    H100 holds 7 clusters of 10 CTAs at once (70 of 132 SMs), 15 of 7."""
    if dtype == torch.bfloat16:
        n = -(-D // DH_SLICE_MAX)
        if n > DH_PORTABLE >= -(-D // DH_SLICE_WIDE):
            n = -(-D // DH_SLICE_WIDE)
        mult = DH_SLICE_MULTIPLE
    else:
        n = -(-D // DS_MAX)
        mult = 32
    return -(-(-(-D // n)) // mult) * mult


def max_active_clusters(which: str, D: int, device=None) -> int:
    """How many clusters of bf16 C1 (``which="dh"``) or C2 (``"dw"``) at
    width ``D`` the card holds at once (``cudaOccupancyMaxActiveClusters``
    for the cluster of ``ceil(D / d_slice_width(D))`` CTAs the wrapper
    launches); 0: such a cluster cannot launch."""
    if which not in ("dh", "dw"):
        raise ValueError(f"which must be 'dh' or 'dw', not {which!r}")
    lib = load_library()
    n = _I(-1)
    with torch.cuda.device(device if device is not None else
                           torch.cuda.current_device()):
        rc = lib.occupancy(D, d_slice_width(D, torch.bfloat16),
                           int(which == "dw"), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with "
                           f"cudaError {rc} (D={D}, {which})")
    return n.value


def _check(hidden, w, targets, *extra) -> Tuple[int, int, int]:
    ts = (hidden, w, targets, *extra)
    if not all(isinstance(t, torch.Tensor) and meta.on_card(t) for t in ts):
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
    """Launch wrapper of one cross-entropy function; ``launches`` counts its
    launches, ``by_kernel`` the same launches by ``__global__`` kernel.

    * ``"fwd"`` (B): ``(hidden, w, targets) -> (lse, tgt_logit)``
      (``ce_fwd_mma_kernel`` for bf16, ``ce_fwd_kernel`` for float32);
    * ``"dh"`` (C1): ``(hidden, w, targets, lse, g) -> dh [T, D]`` in
      hidden's dtype (``ce_bwd_dh_mma_kernel`` / ``ce_bwd_kernel<dh>``);
    * ``"dw"`` (C2): the same inputs ``-> dW [V, D]`` in w's dtype
      (``ce_bwd_dw_mma_kernel`` / ``ce_bwd_kernel<dw>``).

    bf16 C1 and C2 take D <= DH_SLICE_MAX * DH_MAX_SLICES (6,144) and raise
    above it.
    """

    def __init__(self, which: str) -> None:
        if which not in ("fwd", "dh", "dw"):
            raise ValueError(f"unknown cross-entropy kernel {which!r}")
        self.which = which
        self.launches = 0
        self.by_kernel: Counter = Counter()

    def _count(self, kernel: str) -> None:
        self.launches += 1
        self.by_kernel[kernel] += 1

    def __call__(self, hidden, w, targets, *lse_g):
        if self.which == "fwd":
            return self._fwd(hidden, w, targets)
        return self._bwd(hidden, w, targets, *lse_g)

    def _fwd(self, hidden, w, targets):
        T, V, D = _check(hidden, w, targets)
        dev = hidden.device
        n_sm = meta.H100_SMS if meta.is_meta(hidden) else \
            torch.cuda.get_device_properties(dev).multi_processor_count
        n_split = vocab_splits(T, V, n_sm, hidden.dtype)
        lse = torch.empty(T, dtype=torch.float32, device=dev)
        tl = torch.empty(T, dtype=torch.float32, device=dev)
        ws = arrivals = None
        if n_split > 1:
            ws = torch.empty((n_split, T, 3), dtype=torch.float32, device=dev)
            arrivals = torch.zeros(-(-T // FWD_TOKEN_TILE[hidden.dtype]),
                                   dtype=torch.int32, device=dev)
        kernel = KERNELS[self.which][hidden.dtype]
        if meta.is_meta(hidden):
            meta.tally(kernel, 2 * T * V * D)
            return lse, tl
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.fwd(hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
                         lse.data_ptr(), tl.data_ptr(),
                         ws.data_ptr() if ws is not None else None,
                         arrivals.data_ptr() if arrivals is not None else None,
                         T, V, D, _DTYPE_CODE[hidden.dtype], n_split, stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed with cudaError {rc} "
                               f"(T={T}, V={V}, D={D}, {hidden.dtype}, "
                               f"n_split={n_split})")
        self._count(kernel)
        return lse, tl

    def _bwd(self, hidden, w, targets, lse, g):
        T, V, D = _check(hidden, w, targets, lse, g)
        dw = self.which == "dw"
        ds = d_slice_width(D, hidden.dtype)
        if hidden.dtype == torch.bfloat16 and -(-D // ds) > DH_MAX_SLICES:
            raise ValueError(f"D={D}: more than {DH_MAX_SLICES} slices of "
                             f"{ds} columns in one cluster (bf16 C1 and C2 "
                             f"take D <= {DH_SLICE_MAX * DH_MAX_SLICES})")
        out = torch.empty_like(w if dw else hidden)
        kernel = KERNELS[self.which][hidden.dtype]
        if meta.is_meta(hidden):
            meta.tally(kernel, 4 * T * V * D)
            return out
        lib = load_library()
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        with torch.cuda.device(hidden.device):
            rc = lib.bwd(hidden.data_ptr(), w.data_ptr(), targets.data_ptr(),
                         lse.data_ptr(), g.data_ptr(), out.data_ptr(), T, V, D,
                         _DTYPE_CODE[hidden.dtype], int(dw), ds, stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed with cudaError {rc} "
                               f"(T={T}, V={V}, D={D}, {hidden.dtype}, "
                               f"ds={ds})")
        self._count(kernel)
        return out


ce_fwd_cuda = CrossEntropyKernel("fwd")
ce_bwd_dh_cuda = CrossEntropyKernel("dh")
ce_bwd_dw_cuda = CrossEntropyKernel("dw")

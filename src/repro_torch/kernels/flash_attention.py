"""Hopper flash-attention kernels: load and launch wrappers.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention_pallas`` (packed-varlen
causal attention with context rows and sliding windows; the mask rule is
in :mod:`repro_torch.kernels.ref`). The kernel is CUDA C++ for
``sm_90a`` in ``csrc/flash_attention.cu``, compiled by ``nvcc`` at first
use into a shared library with a plain C interface under
``<repo>/build/kernels/`` (:mod:`.build`) and called through ``ctypes`` on
PyTorch's current stream.

What bounds it: operations on the train chunks (two products per live
(query, key, head): Q K^T of 2 Dk flops, P V of 2 Dv), bytes in serving
(a mixed engine step reads a long packed KV buffer for a few queries
each). The key width Dk (q, k) and the value width Dv (v, the output) are
template parameters (:data:`HEAD_DIMS`: MLA's q/k 192, v 128 beside the
equal pairs from the reduced configs' 16 to gemma3-1b's 256). bf16 inputs (the
train and serving paths) run ``flash_fwd_mma_kernel``: both products on
the tensor cores (``mma.sync`` on 64-row tiles, P rounded to bf16 as P V's
operand), the online softmax in registers, and only the KV tiles of each
query tile's exact live range (``flash_bwd_tiles_kernel``'s, which the op
computes once and hands to the backward); the keys are split over blocks
(:func:`kv_splits`, each split a contiguous piece of the range) only
where the grid does not fill the card, as for the serving engine's short
query sets, and the merge pass then combines the pieces. float32 inputs (the verify phases) run ``flash_fwd_kernel``:
float32 FMAs from shared memory on 32-row tiles, every KV tile tested pair
by pair before it is loaded, the tiles dealt round-robin to up to
``MAX_SPLIT`` blocks and merged.

Kernel A's backward runs its products on tensor cores for bf16
(``mma.sync`` on 64-row tiles, ``cp.async`` double buffering) and walks
only the tiles that can hold a live pair (the source note in
``csrc/flash_attention.cu`` says more).

One wrapper per function, each counting its own launches:
:data:`flash_attention_cuda` (the forward, once per attention op;
``by_kernel`` splits its count by kernel, :data:`FWD_KERNELS`; for
training it also writes each row's log-sum-exp), :data:`flash_combine_cuda`
(``flash_combine_kernel``, the merge pass, once per op whose keys are split
over several blocks), the tile ranges :data:`flash_bwd_tiles_cuda`
(``flash_bwd_tiles_kernel``: once per differentiable op, in its forward,
and once per bf16 op without a gradient) and the backward's two passes
:data:`flash_bwd_dkdv_cuda` (``flash_bwd_dkdv_kernel``) and
:data:`flash_bwd_dq_cuda` (``flash_bwd_dq_kernel``), each once per
attention op in a backward (the dq pass first: it writes the rows' Delta
that the dk/dv pass reads). They only launch: they take CUDA tensors,
check them and raise on anything the kernel does not take. Padding to the
tile sizes, the autograd function and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`. On meta tensors each wrapper takes the
same path but books the call in :mod:`.meta` where it would launch.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from . import meta
from .build import load_libraries

__all__ = ["BLOCK_Q", "BLOCK_KV", "HEAD_DIMS", "MAX_SPLIT", "BWD_BLOCK",
           "FWD_BLOCK", "FWD_KERNELS", "SPLIT_FILL",
           "FlashAttentionKernel", "FlashCombineKernel", "FlashBwdKernel",
           "FlashBwdTilesKernel", "BwdTiles", "tile_counts", "kv_splits",
           "flash_attention_cuda", "flash_combine_cuda",
           "flash_bwd_dkdv_cuda", "flash_bwd_dq_cuda",
           "flash_bwd_tiles_cuda", "load_library"]

BLOCK_Q = 32                  # query rows per block (csrc: BQ)
BLOCK_KV = 32                 # KV rows per tile (csrc: BK)
# (key width of q and k, value width of v and the output): the template
# instantiations in the library. (16, 16) and (32, 32) are the reduced
# configs' and the paper figures' (``ArchConfig.reduced``, fig11 and
# fig13), (160, 160) stablelm-12b's, (192, 128) MLA's (deepseek-v2-lite)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (160, 160),
             (256, 256), (192, 128))
MAX_SPLIT = 16                # KV splits per query tile (csrc: MAX_SPLIT)
# rows per tile of the backward passes, both sides (csrc: BB for bf16; the
# float32 passes keep BQ = BK)
BWD_BLOCK = {torch.bfloat16: 64, torch.float32: 32}
# the forward's kernel by dtype, and the rows per tile of the bf16 one
# (both sides; it walks the tile ranges of ``BwdTiles`` for such tiles)
FWD_KERNELS = {torch.float32: "flash_fwd_kernel",
               torch.bfloat16: "flash_fwd_mma_kernel"}
FWD_BLOCK = 64
# blocks per SM the bf16 forward's grid should give (two fit an SM at Dh
# 256) before it splits the keys
SPLIT_FILL = 2
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclass(frozen=True)
class KernelLibrary:
    path: Path
    build_log: str            # nvcc/ptxas output (registers, smem, spills)
    fwd: ctypes._CFuncPtr
    fwd_mma: ctypes._CFuncPtr
    combine: ctypes._CFuncPtr
    bwd_dkdv: ctypes._CFuncPtr
    bwd_dq: ctypes._CFuncPtr
    bwd_tiles: ctypes._CFuncPtr


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """The flash-attention library (built with the others at first use)."""
    built = load_libraries()["flash_attention"]
    lib = built.lib
    checks = [("flash_attention_block_q", (), BLOCK_Q),
              ("flash_attention_block_kv", (), BLOCK_KV),
              ("flash_attention_max_split", (), MAX_SPLIT)]
    checks += [("flash_attention_bwd_block", (_DTYPE_CODE[dt],), rows)
               for dt, rows in BWD_BLOCK.items()]
    for name, args, want in checks:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [_I] * len(args), _I
        if fn(*args) != want:
            raise RuntimeError(f"{built.path.name}: {name}{args} = "
                               f"{fn(*args)} but the wrapper expects {want}")
    fns = {}
    for name, argtypes in (
            ("flash_attention_fwd", [_P] * 11 + [_I] * 9 + [_F, _I, _P]),
            ("flash_attention_fwd_mma", [_P] * 14 + [_I] * 8 + [_F, _I, _P]),
            ("flash_attention_combine", [_P] * 4 + [_I] * 5 + [_P]),
            ("flash_attention_bwd_dkdv", [_P] * 16 + [_I] * 9 + [_F, _P]),
            ("flash_attention_bwd_dq", [_P] * 15 + [_I] * 9 + [_F, _P]),
            ("flash_attention_bwd_tiles", [_P] * 8 + [_I] * 5 + [_P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
        fns[name] = fn
    return KernelLibrary(path=built.path, build_log=built.build_log,
                         fwd=fns["flash_attention_fwd"],
                         fwd_mma=fns["flash_attention_fwd_mma"],
                         combine=fns["flash_attention_combine"],
                         bwd_dkdv=fns["flash_attention_bwd_dkdv"],
                         bwd_dq=fns["flash_attention_bwd_dq"],
                         bwd_tiles=fns["flash_attention_bwd_tiles"])


class FlashAttentionKernel:
    """Launch wrapper of the forward: ``flash_fwd_mma_kernel`` for bf16
    (tensor cores; it walks the metadata's tile ranges, ``tiles``),
    ``flash_fwd_kernel`` for float32. ``launches`` counts its launches (one
    per attention op), ``by_kernel`` the same launches by ``__global__``
    kernel (:data:`FWD_KERNELS`). When the keys are split over several
    blocks per query tile (:func:`kv_splits`), the op's merge pass goes
    through :data:`flash_combine_cuda`."""

    def __init__(self) -> None:
        self.launches = 0
        self.by_kernel: Counter = Counter()

    def __call__(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None, with_lse: bool = False,
                 tiles: Optional["BwdTiles"] = None):
        """``out [T, Hq, Dv]``; with ``with_lse`` also each row's
        log-sum-exp ``lse [Hq, T]`` (float32, ``-inf`` on rows with no
        attended key), which the backward reads. bf16 takes ``tiles``, the
        metadata's :class:`BwdTiles` for tiles of :data:`FWD_BLOCK` rows
        (:data:`flash_bwd_tiles_cuda`); the split workspace is allocated
        only where the keys are split."""
        _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        lse = torch.empty((q.shape[1], q.shape[0]), dtype=torch.float32,
                          device=q.device) if with_lse else None
        n_split = kv_splits(q.shape[0], k.shape[0], q.shape[1],
                            _sm_count(q.device), q.dtype)
        if n_split == 1:
            out = q.new_empty((*q.shape[:2], v.shape[2]))
            self._launch(q, k, v, seg_q, seg_kv, pos_q, pos_kv, out, None,
                         None, lse, 1, causal, window, scale, tiles)
        else:
            ws_ml, ws_acc = self.partials(q, k, v, seg_q, seg_kv, pos_q,
                                          pos_kv, n_split=n_split,
                                          causal=causal, window=window,
                                          scale=scale, tiles=tiles)
            out = flash_combine_cuda(ws_ml, ws_acc, q.dtype, lse=lse)
        return (out, lse) if with_lse else out

    def partials(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                 n_split: int, causal: bool = True, window: int = 0,
                 scale: Optional[float] = None,
                 tiles: Optional["BwdTiles"] = None):
        """The split pass alone, over ``n_split >= 2`` blocks per query
        tile. Returns the float32 partial states ``ws_ml [n_split, T, Hq,
        2]`` (each split's running max and sum) and ``ws_acc [n_split, T,
        Hq, Dv]`` (its unnormalised output, written only where the sum is
        > 0 and uninitialised elsewhere)."""
        if not 2 <= n_split <= MAX_SPLIT:
            raise ValueError(f"n_split={n_split} not in [2, {MAX_SPLIT}]")
        (T, Hq), D = q.shape[:2], v.shape[2]
        ws_ml = torch.empty((n_split, T, Hq, 2), dtype=torch.float32,
                            device=q.device)
        ws_acc = torch.empty((n_split, T, Hq, D), dtype=torch.float32,
                             device=q.device)
        self._launch(q, k, v, seg_q, seg_kv, pos_q, pos_kv, None, ws_ml,
                     ws_acc, None, n_split, causal, window, scale, tiles)
        return ws_ml, ws_acc

    def _launch(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, out, ws_ml,
                ws_acc, lse, n_split, causal, window, scale, tiles) -> None:
        T, Hq, Dk, Dv = _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        S, Hkv = k.shape[0], k.shape[1]
        scale = float(scale if scale is not None else Dk ** -0.5)
        kernel = FWD_KERNELS[q.dtype]
        if q.dtype == torch.bfloat16:
            if tiles is None:
                raise ValueError(f"{kernel} walks the metadata's tile "
                                 f"ranges: pass tiles (ops.bwd_tiles, "
                                 f"block={FWD_BLOCK})")
            tiles.check(T, S, FWD_BLOCK, q.device)
        if meta.is_meta(q):
            meta.tally(kernel, Hq * (2 * Dk + 2 * Dv) * meta.attention_pairs(
                T, S, causal=causal, window=int(window)))
            return
        lib = load_library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
                pos_q.data_ptr(), seg_kv.data_ptr(), pos_kv.data_ptr())
        outs = (ptr(out), ptr(ws_ml), ptr(ws_acc), ptr(lse))
        with torch.cuda.device(q.device):
            if q.dtype == torch.bfloat16:
                rc = lib.fwd_mma(*head, tiles.kv_range.data_ptr(),
                                 tiles.q_summary.data_ptr(),
                                 tiles.kv_summary.data_ptr(), *outs, T, S,
                                 Hq, Hkv, Dk, Dv, int(bool(causal)),
                                 int(window), scale, n_split, stream)
            else:
                rc = lib.fwd(*head, *outs, T, S, Hq, Hkv, Dk, Dv,
                             _DTYPE_CODE[q.dtype], int(bool(causal)),
                             int(window), scale, n_split, stream)
        if rc != 0:
            raise RuntimeError(
                f"{kernel} launch failed with cudaError {rc} (T={T}, S={S}, "
                f"Hq={Hq}, Hkv={Hkv}, Dk={Dk}, Dv={Dv}, {q.dtype}, "
                f"n_split={n_split})")
        self.launches += 1
        self.by_kernel[kernel] += 1


class FlashCombineKernel:
    """Launch wrapper of ``flash_combine_kernel``: merges the partial
    states of :meth:`FlashAttentionKernel.partials` into ``[T, Hq, D]`` of
    ``dtype``. Its plain version is :func:`repro_torch.kernels.ref.
    combine_partials`; ``launches`` counts its launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, ws_ml: torch.Tensor, ws_acc: torch.Tensor,
                 dtype: torch.dtype,
                 lse: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lse``, if given, a float32 ``[Hq, T]`` tensor the merge pass
        fills with each row's log-sum-exp."""
        if not all(isinstance(t, torch.Tensor) and meta.on_card(t)
                   for t in (ws_ml, ws_acc)) or ws_ml.device != ws_acc.device:
            raise ValueError("flash_combine_cuda takes CUDA tensors on one "
                             "device")
        if ws_acc.dim() != 4:
            raise ValueError("ws_acc must be [n_split, T, Hq, D]")
        n_split, T, Hq, D = ws_acc.shape
        if tuple(ws_ml.shape) != (n_split, T, Hq, 2):
            raise ValueError(f"ws_ml {tuple(ws_ml.shape)} does not match "
                             f"ws_acc {tuple(ws_acc.shape)}")
        if ws_ml.dtype != torch.float32 or ws_acc.dtype != torch.float32:
            raise ValueError("the partial states must be float32")
        if not (ws_ml.is_contiguous() and ws_acc.is_contiguous()):
            raise ValueError("flash_combine_cuda takes contiguous tensors")
        if not 2 <= n_split <= MAX_SPLIT:
            raise ValueError(f"n_split={n_split} not in [2, {MAX_SPLIT}]")
        if D not in {dv for _, dv in HEAD_DIMS} or dtype not in _DTYPE_CODE \
                or T == 0:
            raise ValueError(f"value width {D}, dtype {dtype} or T={T} not "
                             f"taken")
        if lse is not None and (lse.dtype != torch.float32
                                or tuple(lse.shape) != (Hq, T)
                                or not lse.is_contiguous()
                                or lse.device != ws_acc.device):
            raise ValueError("lse must be a contiguous float32 [Hq, T] "
                             "tensor on the partial states' device")
        out = torch.empty((T, Hq, D), dtype=dtype, device=ws_acc.device)
        if meta.is_meta(out):
            meta.tally("flash_combine_kernel", 2 * n_split * T * Hq * D)
            return out
        lib = load_library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        with torch.cuda.device(out.device):
            rc = lib.combine(ws_ml.data_ptr(), ws_acc.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if lse is not None else None,
                             T, Hq, D, _DTYPE_CODE[dtype], n_split, stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_combine_kernel launch failed with cudaError {rc} "
                f"(T={T}, Hq={Hq}, D={D}, {dtype}, n_split={n_split})")
        self.launches += 1
        return out


class FlashBwdKernel:
    """Launch wrapper of one backward pass: ``flash_bwd_dq_kernel``
    (``which="dq"``, returns ``dq``) or ``flash_bwd_dkdv_kernel``
    (``which="dkdv"``, returns ``(dk, dv)``). Inputs: the forward's padded
    ``q, k, v``, metadata, output ``out [T, Hq, Dv]``, its ``lse [Hq, T]``
    and the output's gradient ``dout`` (same shape and dtype as ``out``).

    ``delta`` is a float32 ``[Hq, T]`` buffer of the rows' Delta =
    rowsum(dout * out) (in bf16, the exact sum_j P dP, not the one from the
    rounded ``out``): the dq pass, which runs first, writes it, the dk/dv
    pass reads it and so needs the one the dq pass wrote. ``tiles``: the
    metadata's :class:`BwdTiles` (:data:`flash_bwd_tiles_cuda`) for tiles
    of ``BWD_BLOCK[dtype]`` rows. The plain version is
    :func:`repro_torch.kernels.ref.flash_attention_grad`; ``launches``
    counts this pass's launches."""

    def __init__(self, which: str) -> None:
        if which not in ("dkdv", "dq"):
            raise ValueError(f"which must be 'dkdv' or 'dq', not {which!r}")
        self.which = which
        self.launches = 0

    def __call__(self, q, k, v, out, dout, lse, seg_q, seg_kv, pos_q, pos_kv,
                 *, causal: bool = True, window: int = 0,
                 scale: Optional[float] = None, delta: torch.Tensor,
                 tiles: "BwdTiles"):
        T, Hq, Dk, Dv = _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        S, Hkv = k.shape[0], k.shape[1]
        for name, t in (("out", out), ("dout", dout)):
            if (not isinstance(t, torch.Tensor) or not meta.on_card(t)
                    or t.device != q.device or t.dtype != q.dtype
                    or tuple(t.shape) != (T, Hq, Dv)
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous CUDA "
                                 f"{q.dtype} tensor [{T}, {Hq}, {Dv}]")
        for name, t in (("lse", lse), ("delta", delta)):
            if (not isinstance(t, torch.Tensor) or t.device != q.device
                    or t.dtype != torch.float32
                    or tuple(t.shape) != (Hq, T) or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"[{Hq}, {T}] tensor on {q.device}")
        window = int(window)
        tiles.check(T, S, BWD_BLOCK[q.dtype], q.device)
        scale = float(scale if scale is not None else Dk ** -0.5)
        if meta.is_meta(q):
            per = 4 * Dk + (4 if self.which == "dkdv" else 2) * Dv
            meta.tally(f"flash_bwd_{self.which}_kernel",
                       Hq * per * meta.attention_pairs(
                           T, S, causal=causal, window=window))
            return (torch.empty_like(k), torch.empty_like(v)) \
                if self.which == "dkdv" else torch.empty_like(q)
        lib = load_library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                seg_q.data_ptr(), pos_q.data_ptr(), seg_kv.data_ptr(),
                pos_kv.data_ptr())
        summaries = (tiles.q_summary.data_ptr(), tiles.kv_summary.data_ptr())
        tail = (T, S, Hq, Hkv, Dk, Dv, _DTYPE_CODE[q.dtype],
                int(bool(causal)), window, scale, stream)
        with torch.cuda.device(q.device):
            if self.which == "dkdv":
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                rc = lib.bwd_dkdv(*head, tiles.q_range.data_ptr(), *summaries,
                                  dk.data_ptr(), dv.data_ptr(), *tail)
                res = (dk, dv)
            else:
                dq = torch.empty_like(q)
                rc = lib.bwd_dq(*head, tiles.kv_range.data_ptr(), *summaries,
                                dq.data_ptr(), *tail)
                res = dq
        if rc != 0:
            raise RuntimeError(
                f"flash_bwd_{self.which}_kernel launch failed with cudaError "
                f"{rc} (T={T}, S={S}, Hq={Hq}, Hkv={Hkv}, Dk={Dk}, Dv={Dv}, "
                f"{q.dtype})")
        self.launches += 1
        return res


@dataclass(frozen=True)
class BwdTiles:
    """What the backward passes walk, per tile of ``block`` rows (int32,
    contiguous, on the metadata's device): ``kv_range [n_q, 2]``, for each
    query tile the first and last KV tile holding a live pair with it (the
    dq pass); ``q_range [n_kv, 2]``, for each KV tile its first and last
    such query tile (the dk/dv pass); an empty range is ``[n, -1]``.
    ``q_summary [n_q, 4]`` and ``kv_summary [n_kv, 4]``: segment min,
    segment max, position min, position max over the tile's live rows
    (``[2^31 - 1, -1, 2^31 - 1, -2^31]`` for a tile with none). Inside its
    range a pass skips a tile whose summary cannot meet its own
    (:func:`tile_counts` says how)."""
    block: int
    kv_range: torch.Tensor
    q_range: torch.Tensor
    q_summary: torch.Tensor
    kv_summary: torch.Tensor

    def check(self, T: int, S: int, block: int, device) -> None:
        n_q, n_kv = -(-T // block), -(-S // block)
        want = (("kv_range", (n_q, 2)), ("q_range", (n_kv, 2)),
                ("q_summary", (n_q, 4)), ("kv_summary", (n_kv, 4)))
        for name, shape in want:
            t = getattr(self, name)
            if (tuple(t.shape) != shape or t.dtype != torch.int32
                    or not t.is_contiguous() or t.device != device
                    or t.data_ptr() % (4 * shape[1])):
                raise ValueError(f"tiles.{name} must be contiguous int32 "
                                 f"{shape} on {device}, its rows aligned "
                                 f"(the kernels load them whole)")
        if self.block != block:
            raise ValueError(f"tiles of {self.block} rows, the pass takes "
                             f"{block}")


class FlashBwdTilesKernel:
    """Launch wrapper of ``flash_bwd_tiles_kernel``: the :class:`BwdTiles`
    of the padded metadata for tiles of ``block`` rows (one launch per
    attention op in a backward). Its plain version is
    :func:`repro_torch.kernels.ref.flash_attention_tiles`; ``launches``
    counts its launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, seg_q, seg_kv, pos_q, pos_kv, *, causal: bool = True,
                 window: int = 0, block: int = 64) -> BwdTiles:
        ts = (seg_q, seg_kv, pos_q, pos_kv)
        if not all(isinstance(t, torch.Tensor) and meta.on_card(t)
                   and t.dtype == torch.int32 and t.dim() == 1
                   and t.is_contiguous() for t in ts) \
                or len({t.device for t in ts}) != 1:
            raise ValueError("flash_bwd_tiles_cuda takes contiguous int32 "
                             "CUDA vectors on one device")
        T, S = seg_q.shape[0], seg_kv.shape[0]
        if pos_q.shape[0] != T or pos_kv.shape[0] != S or T == 0 or S == 0:
            raise ValueError(f"seg/pos lengths {[t.shape[0] for t in ts]}")
        if block not in set(BWD_BLOCK.values()):
            raise ValueError(f"block={block} not in {set(BWD_BLOCK.values())}")
        n_q, n_kv = -(-T // block), -(-S // block)
        buf = torch.empty(6 * (n_q + n_kv), dtype=torch.int32,
                          device=seg_q.device)
        # the summaries first: the kernel stores them 16 bytes at a time
        q_sum, kv_sum, kv_range, q_range = (
            t.view(-1, w) for t, w in zip(buf.split(
                [4 * n_q, 4 * n_kv, 2 * n_q, 2 * n_kv]), (4, 4, 2, 2)))
        if meta.is_meta(buf):
            meta.tally("flash_bwd_tiles_kernel", 0)
            return BwdTiles(block=block, kv_range=kv_range, q_range=q_range,
                            q_summary=q_sum, kv_summary=kv_sum)
        lib = load_library()
        stream = torch.cuda.current_stream(seg_q.device).cuda_stream
        with torch.cuda.device(seg_q.device):
            rc = lib.bwd_tiles(seg_q.data_ptr(), pos_q.data_ptr(),
                               seg_kv.data_ptr(), pos_kv.data_ptr(),
                               kv_range.data_ptr(), q_range.data_ptr(),
                               q_sum.data_ptr(), kv_sum.data_ptr(), T, S,
                               block, int(bool(causal)), int(window), stream)
        if rc != 0:
            raise RuntimeError(f"flash_bwd_tiles_kernel launch failed with "
                               f"cudaError {rc} (T={T}, S={S}, "
                               f"block={block})")
        self.launches += 1
        return BwdTiles(block=block, kv_range=kv_range, q_range=q_range,
                        q_summary=q_sum, kv_summary=kv_sum)


def tile_counts(tiles: BwdTiles, *, causal: bool = True,
                window: int = 0) -> dict:
    """Tile pairs of each pass (per head): ``in_range``, the pairs inside
    the blocks' ranges, and ``visited``, those whose summaries pass the
    kernels' O(1) test (the tiles a pass computes). The same for both
    passes' counts when the ranges are tight; the dk/dv pass visits each
    pair once per query head of its group, the dq pass once per query
    head."""
    qs, ks = tiles.q_summary.long(), tiles.kv_summary.long()
    out = {}
    for name, rng, own_q in (("dq", tiles.kv_range, True),
                             ("dkdv", tiles.q_range, False)):
        other = ks if own_q else qs
        idx = torch.arange(other.shape[0], device=other.device)
        inside = (idx[None, :] >= rng[:, :1]) & (idx[None, :] <= rng[:, 1:])
        a = (qs[:, None, :] if own_q else qs[None, :, :])
        b = (ks[None, :, :] if own_q else ks[:, None, :])
        ok = (torch.maximum(a[..., 0], b[..., 0])
              <= torch.minimum(a[..., 1], b[..., 1]))
        if causal:
            ok &= b[..., 2] <= a[..., 3]
        if window > 0:
            ok &= a[..., 2] - b[..., 3] < window
        out[name] = {"in_range": int(inside.sum()),
                     "visited": int((inside & ok).sum())}
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    if torch.device(device).type == "meta":
        return meta.H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def kv_splits(T: int, S: int, Hq: int, n_sm: int,
              dtype=torch.bfloat16) -> int:
    """KV splits per query tile of the forward, for ``T`` query rows,
    ``S`` KV rows and ``Hq`` query heads on a card of ``n_sm`` SMs.

    bf16 (``flash_fwd_mma_kernel``): 1 where the grid of query tiles x
    heads gives at least SPLIT_FILL blocks per SM (every training chunk
    of the train phases); else enough splits for that many, at most
    MAX_SPLIT and at most the KV tiles, which bound every query tile's
    live range (the serving engine's short query sets, whose decode rows
    each attend a whole context). Split ``z`` of ``n`` walks KV tiles
    ``[lo + z len // n, lo + (z + 1) len // n)`` of its query tile's range
    ``[lo, hi]``, ``len = hi - lo + 1`` (``csrc/flash_attention.cu``).

    float32 (``flash_fwd_kernel``): one per 16 KV tiles of 32 rows, at
    most MAX_SPLIT, the tiles dealt round-robin."""
    if dtype != torch.bfloat16:
        return max(1, min(MAX_SPLIT, (S // BLOCK_KV) // 16))
    blocks = -(-T // FWD_BLOCK) * Hq
    n_kv = -(-S // FWD_BLOCK)
    want = -(-SPLIT_FILL * n_sm // blocks)
    return max(1, min(MAX_SPLIT, n_kv, want))


def _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv):
    ts = (q, k, v, seg_q, seg_kv, pos_q, pos_kv)
    if not all(isinstance(t, torch.Tensor) and meta.on_card(t) for t in ts):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention_cuda: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [rows, heads, head_dim]")
    T, Hq, Dk = q.shape
    S, Hkv, Dv = v.shape
    if tuple(k.shape) != (S, Hkv, Dk):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if (Dk, Dv) not in HEAD_DIMS:
        raise ValueError(f"(key, value) widths {(Dk, Dv)} not in "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if T % BLOCK_Q or S % BLOCK_KV or T == 0 or S == 0:
        raise ValueError(f"T={T} and S={S} must be positive multiples of "
                         f"{BLOCK_Q} and {BLOCK_KV} (ops.flash_attention "
                         f"pads)")
    for name, t, n in (("seg_q", seg_q, T), ("pos_q", pos_q, T),
                       ("seg_kv", seg_kv, S), ("pos_kv", pos_kv, S)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (the "
                         "kernel loads 16 bytes at a time)")
    return T, Hq, Dk, Dv


flash_attention_cuda = FlashAttentionKernel()
flash_combine_cuda = FlashCombineKernel()
flash_bwd_dkdv_cuda = FlashBwdKernel("dkdv")
flash_bwd_dq_cuda = FlashBwdKernel("dq")
flash_bwd_tiles_cuda = FlashBwdTilesKernel()

"""Hopper flash-attention kernels: load and launch wrappers.

Replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention_pallas`` (packed-varlen
causal attention with context rows and sliding windows; the mask rule is
in :mod:`repro_torch.kernels.ref`). The kernel is CUDA C++ for
``sm_90a`` in ``csrc/flash_attention.cu``, compiled by ``nvcc`` at first
use into a shared library with a plain C interface under
``<repo>/build/kernels/`` (:mod:`.build`) and called through ``ctypes`` on
PyTorch's current stream.

What bounds it: at the serving shapes every K/V row is met by up to
``cap_t`` queries times the GQA group, and the roofline bound of a whole
engine step's attention is a few hundredths of a ms (``PERF.md``). This
kernel computes with float32 FMAs from shared memory: one block per
(32-query tile, query head, KV split), a loop over its share of the
32-row KV tiles with an online softmax, tiles with no live (query, key)
pair skipped before they are loaded, and the splits' partial states
merged by a second kernel (so decode rows, which each attend a whole
context, are spread over up to ``MAX_SPLIT`` blocks). Moving its products
onto tensor cores is the next step.

One wrapper per ``__global__`` kernel, each counting its own launches:
:data:`flash_attention_cuda` (``flash_fwd_kernel``, the split pass, once
per attention op; for training it also writes each row's log-sum-exp),
:data:`flash_combine_cuda` (``flash_combine_kernel``, the merge pass, once
per op whose keys are split over several blocks), and the backward's two
passes :data:`flash_bwd_dkdv_cuda` (``flash_bwd_dkdv_kernel``) and
:data:`flash_bwd_dq_cuda` (``flash_bwd_dq_kernel``), each once per
attention op in a backward. They only launch: they take CUDA tensors,
check them and raise on anything the kernel does not take. Padding to the
tile sizes, the autograd function and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from .build import load_libraries

__all__ = ["BLOCK_Q", "BLOCK_KV", "HEAD_DIMS", "MAX_SPLIT",
           "FlashAttentionKernel", "FlashCombineKernel", "FlashBwdKernel",
           "kv_splits", "flash_attention_cuda", "flash_combine_cuda",
           "flash_bwd_dkdv_cuda", "flash_bwd_dq_cuda", "load_library"]

BLOCK_Q = 32                  # query rows per block (csrc: BQ)
BLOCK_KV = 32                 # KV rows per tile (csrc: BK)
HEAD_DIMS = (64, 128, 256)    # template instantiations in the library
MAX_SPLIT = 16                # KV splits per query tile (csrc: MAX_SPLIT)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclass(frozen=True)
class KernelLibrary:
    path: Path
    build_log: str            # nvcc/ptxas output (registers, smem, spills)
    fwd: ctypes._CFuncPtr
    combine: ctypes._CFuncPtr
    bwd_dkdv: ctypes._CFuncPtr
    bwd_dq: ctypes._CFuncPtr


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """The flash-attention library (built with the others at first use)."""
    built = load_libraries()["flash_attention"]
    lib = built.lib
    for name, want in (("flash_attention_block_q", BLOCK_Q),
                       ("flash_attention_block_kv", BLOCK_KV),
                       ("flash_attention_max_split", MAX_SPLIT)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"{built.path.name}: {name}() = {fn()} but "
                               f"the wrapper expects {want}")
    fns = {}
    for name, argtypes in (
            ("flash_attention_fwd", [_P] * 11 + [_I] * 8 + [_F, _I, _P]),
            ("flash_attention_combine", [_P] * 4 + [_I] * 5 + [_P]),
            ("flash_attention_bwd_dkdv", [_P] * 12 + [_I] * 8 + [_F, _P]),
            ("flash_attention_bwd_dq", [_P] * 11 + [_I] * 8 + [_F, _P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
        fns[name] = fn
    return KernelLibrary(path=built.path, build_log=built.build_log,
                         fwd=fns["flash_attention_fwd"],
                         combine=fns["flash_attention_combine"],
                         bwd_dkdv=fns["flash_attention_bwd_dkdv"],
                         bwd_dq=fns["flash_attention_bwd_dq"])


class FlashAttentionKernel:
    """Launch wrapper of ``flash_fwd_kernel``; ``launches`` counts its
    launches (one per attention op). When the keys are split over several
    blocks per query tile, the op's merge pass goes through
    :data:`flash_combine_cuda`."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                 causal: bool = True, window: int = 0,
                 scale: Optional[float] = None, with_lse: bool = False):
        """``out [T, Hq, D]``; with ``with_lse`` also each row's
        log-sum-exp ``lse [Hq, T]`` (float32, ``-inf`` on rows with no
        attended key), which the backward reads."""
        lse = torch.empty((q.shape[1], q.shape[0]), dtype=torch.float32,
                          device=q.device) if with_lse else None
        n_split = kv_splits(k.shape[0])
        if n_split == 1:
            out = torch.empty_like(q)
            self._launch(q, k, v, seg_q, seg_kv, pos_q, pos_kv, out, None,
                         None, lse, 1, causal, window, scale)
        else:
            ws_ml, ws_acc = self.partials(q, k, v, seg_q, seg_kv, pos_q,
                                          pos_kv, n_split=n_split,
                                          causal=causal, window=window,
                                          scale=scale)
            out = flash_combine_cuda(ws_ml, ws_acc, q.dtype, lse=lse)
        return (out, lse) if with_lse else out

    def partials(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, *,
                 n_split: int, causal: bool = True, window: int = 0,
                 scale: Optional[float] = None):
        """The split pass alone, over ``n_split >= 2`` blocks per query
        tile. Returns the float32 partial states ``ws_ml [n_split, T, Hq,
        2]`` (each split's running max and sum) and ``ws_acc [n_split, T,
        Hq, D]`` (its unnormalised output, written only where the sum is
        > 0 and uninitialised elsewhere)."""
        if not 2 <= n_split <= MAX_SPLIT:
            raise ValueError(f"n_split={n_split} not in [2, {MAX_SPLIT}]")
        T, Hq, D = q.shape
        ws_ml = torch.empty((n_split, T, Hq, 2), dtype=torch.float32,
                            device=q.device)
        ws_acc = torch.empty((n_split, T, Hq, D), dtype=torch.float32,
                             device=q.device)
        self._launch(q, k, v, seg_q, seg_kv, pos_q, pos_kv, None, ws_ml,
                     ws_acc, None, n_split, causal, window, scale)
        return ws_ml, ws_acc

    def _launch(self, q, k, v, seg_q, seg_kv, pos_q, pos_kv, out, ws_ml,
                ws_acc, lse, n_split, causal, window, scale) -> None:
        T, Hq, D = _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        S, Hkv = k.shape[0], k.shape[1]
        scale = float(scale if scale is not None else D ** -0.5)
        lib = load_library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            rc = lib.fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         seg_q.data_ptr(), pos_q.data_ptr(),
                         seg_kv.data_ptr(), pos_kv.data_ptr(),
                         out.data_ptr() if out is not None else None,
                         ws_ml.data_ptr() if ws_ml is not None else None,
                         ws_acc.data_ptr() if ws_acc is not None else None,
                         lse.data_ptr() if lse is not None else None,
                         T, S, Hq, Hkv, D, _DTYPE_CODE[q.dtype],
                         int(bool(causal)), int(window), scale, n_split,
                         stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_fwd_kernel launch failed with cudaError {rc} "
                f"(T={T}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, {q.dtype}, "
                f"n_split={n_split})")
        self.launches += 1


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
        if not all(isinstance(t, torch.Tensor) and t.is_cuda
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
        if D not in HEAD_DIMS or dtype not in _DTYPE_CODE or T == 0:
            raise ValueError(f"head_dim {D}, dtype {dtype} or T={T} not "
                             f"taken")
        if lse is not None and (lse.dtype != torch.float32
                                or tuple(lse.shape) != (Hq, T)
                                or not lse.is_contiguous()
                                or lse.device != ws_acc.device):
            raise ValueError("lse must be a contiguous float32 [Hq, T] "
                             "tensor on the partial states' device")
        out = torch.empty((T, Hq, D), dtype=dtype, device=ws_acc.device)
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
    """Launch wrapper of one backward pass: ``flash_bwd_dkdv_kernel``
    (``which="dkdv"``, returns ``(dk, dv)``) or ``flash_bwd_dq_kernel``
    (``which="dq"``, returns ``dq``). Inputs: the forward's padded
    ``q, k, v``, metadata, output ``out``, its ``lse [Hq, T]`` and the
    output's gradient ``dout`` (same shape and dtype as ``out``). The plain
    version is :func:`repro_torch.kernels.ref.flash_attention_grad`;
    ``launches`` counts this pass's launches."""

    def __init__(self, which: str) -> None:
        if which not in ("dkdv", "dq"):
            raise ValueError(f"which must be 'dkdv' or 'dq', not {which!r}")
        self.which = which
        self.launches = 0

    def __call__(self, q, k, v, out, dout, lse, seg_q, seg_kv, pos_q, pos_kv,
                 *, causal: bool = True, window: int = 0,
                 scale: Optional[float] = None):
        T, Hq, D = _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv)
        S, Hkv = k.shape[0], k.shape[1]
        for name, t in (("out", out), ("dout", dout)):
            if (not isinstance(t, torch.Tensor) or not t.is_cuda
                    or t.device != q.device or t.dtype != q.dtype
                    or t.shape != q.shape or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous CUDA tensor "
                                 f"like q {tuple(q.shape)} {q.dtype}")
        if (not isinstance(lse, torch.Tensor) or lse.device != q.device
                or lse.dtype != torch.float32
                or tuple(lse.shape) != (Hq, T) or not lse.is_contiguous()):
            raise ValueError(f"lse must be a contiguous float32 [{Hq}, {T}] "
                             f"tensor on {q.device}")
        scale = float(scale if scale is not None else D ** -0.5)
        lib = load_library()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), seg_q.data_ptr(),
                  pos_q.data_ptr(), seg_kv.data_ptr(), pos_kv.data_ptr())
        tail = (_DTYPE_CODE[q.dtype], int(bool(causal)), int(window), scale,
                stream)
        with torch.cuda.device(q.device):
            if self.which == "dkdv":
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                rc = lib.bwd_dkdv(*common, dk.data_ptr(), dv.data_ptr(), T, S,
                                  Hq, Hkv, D, *tail)
                res = (dk, dv)
            else:
                dq = torch.empty_like(q)
                rc = lib.bwd_dq(*common, dq.data_ptr(), T, S, Hq, Hkv, D,
                                *tail)
                res = dq
        if rc != 0:
            raise RuntimeError(
                f"flash_bwd_{self.which}_kernel launch failed with cudaError "
                f"{rc} (T={T}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, {q.dtype})")
        self.launches += 1
        return res


def kv_splits(S: int) -> int:
    """KV splits per query tile: one per 16 KV tiles, at most MAX_SPLIT.
    A query tile of decode rows has live tiles in every one of their
    contexts (or windows), so its work is dealt over many blocks even when
    the buffer is short, as on a sliding-window layer."""
    return max(1, min(MAX_SPLIT, (S // BLOCK_KV) // 16))


def _check(q, k, v, seg_q, seg_kv, pos_q, pos_kv):
    ts = (q, k, v, seg_q, seg_kv, pos_q, pos_kv)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in ts):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention_cuda: tensors on different devices")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [rows, heads, head_dim]")
    T, Hq, D = q.shape
    S, Hkv, Dk = k.shape
    if Dk != D or tuple(v.shape) != (S, Hkv, D):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
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
    return T, Hq, D


flash_attention_cuda = FlashAttentionKernel()
flash_combine_cuda = FlashCombineKernel()
flash_bwd_dkdv_cuda = FlashBwdKernel("dkdv")
flash_bwd_dq_cuda = FlashBwdKernel("dq")

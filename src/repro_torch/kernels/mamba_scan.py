"""Hopper selective-scan kernels (mamba-1): load and launch wrappers.

Replace the JAX package's Pallas TPU kernel ``mamba_scan_pallas``
(``kernels/mamba_scan.py``, D) and add its gradient (D'), which the JAX
package takes by differentiating its jnp scan. The kernels are CUDA C++
for ``sm_90a`` in ``csrc/mamba_scan.cu`` (its header sets out the design
and what bounds them), built at first use by :mod:`.build` and called
through ``ctypes`` on PyTorch's current stream.

One wrapper and one launch count per kernel: :data:`mamba_scan_fwd_cuda`
(``mamba_scan_fwd_kernel``), :data:`mamba_scan_bwd_cuda`
(``mamba_scan_bwd_kernel``) and :data:`mamba_scan_reduce_cuda`
(``mamba_scan_reduce_kernel``, the fixed-order sum of the backward's
per-block dB/dC partials). They take CUDA tensors with ``T`` a multiple of
:data:`SCAN_TILE` and ``DS`` in :data:`STATE_SIZES`, and raise on anything
else; padding, the autograd function and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`, the plain versions in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from .build import load_libraries

__all__ = ["SCAN_TILE", "CHANNELS_PER_BLOCK", "STATE_SIZES",
           "mamba_scan_fwd_cuda", "mamba_scan_bwd_cuda",
           "mamba_scan_reduce_cuda", "load_library"]

SCAN_TILE = 64              # time rows per tile and checkpoint (csrc: BT)
CHANNELS_PER_BLOCK = 16     # csrc: CPB
STATE_SIZES = (4, 16)       # the DS the kernels are built for
# xs types built (delta, B and C are float32): float32, and bf16 (the bf16
# mixer's)
_XS_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@dataclass(frozen=True)
class MambaScanLibrary:
    path: Path
    build_log: str
    fwd: ctypes._CFuncPtr
    bwd: ctypes._CFuncPtr
    reduce: ctypes._CFuncPtr


@functools.lru_cache(maxsize=None)
def load_library() -> MambaScanLibrary:
    """The selective-scan library (built with the others at first use)."""
    built = load_libraries()["mamba_scan"]
    lib = built.lib
    for name, want in (("mamba_scan_tile", SCAN_TILE),
                       ("mamba_scan_channels_per_block",
                        CHANNELS_PER_BLOCK)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"{built.path.name}: {name}() = {fn()} but "
                               f"the wrapper expects {want}")
    fwd = lib.mamba_scan_fwd
    fwd.argtypes, fwd.restype = [_P] * 10 + [_I] * 4 + [_P], _I
    bwd = lib.mamba_scan_bwd
    bwd.argtypes, bwd.restype = [_P] * 15 + [_I] * 4 + [_P], _I
    red = lib.mamba_scan_reduce
    red.argtypes, red.restype = [_P] * 3 + [_I] * 3 + [_P], _I
    return MambaScanLibrary(path=built.path, build_log=built.build_log,
                            fwd=fwd, bwd=bwd, reduce=red)


def _check(delta, xs, B, C, A, reset, *f32):
    """(T, DI, DS) after checking what the kernels take."""
    ts = (delta, xs, B, C, A, reset, *f32)
    if not all(isinstance(t, torch.Tensor) and t.is_cuda for t in ts):
        raise ValueError("the selective-scan kernels take CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("selective-scan kernel: tensors on different "
                         "devices")
    if delta.dim() != 2 or xs.shape != delta.shape or B.dim() != 2:
        raise ValueError(f"delta {tuple(delta.shape)} and xs "
                         f"{tuple(xs.shape)} must be [T, DI], B [T, DS]")
    T, DI = delta.shape
    DS = B.shape[1]
    if T == 0 or T % SCAN_TILE or DS not in STATE_SIZES:
        raise ValueError(f"T={T} must be a positive multiple of {SCAN_TILE} "
                         f"(ops pads T) and DS={DS} one of {STATE_SIZES}")
    if tuple(B.shape) != (T, DS) or tuple(C.shape) != (T, DS):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"[{T}, {DS}]")
    if xs.dtype not in _XS_CODE:
        raise ValueError(f"xs must be one of {tuple(_XS_CODE)}: {xs.dtype}")
    if tuple(A.shape) != (DI, DS):
        raise ValueError(f"A must be [{DI}, {DS}]")
    if reset.dtype != torch.int32 or tuple(reset.shape) != (T,):
        raise ValueError(f"reset must be int32 [{T}]")
    if any(t.dtype != torch.float32 for t in (delta, B, C, A, *f32)):
        raise ValueError("delta, B, C, A, h0, ckpt, dy and dh_last must be "
                         "float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the selective-scan kernels take contiguous tensors")
    return T, DI, DS


def _blocks(DI: int) -> int:
    return -(-DI // CHANNELS_PER_BLOCK)


class MambaScanFwd:
    """``(delta, xs, B, C, A, reset, h0) -> (y, h_last, ckpt)``, all float32:
    y ``[T, DI]`` (before the D skip and the gating), h_last ``[DI, DS]``,
    ckpt ``[T / SCAN_TILE, DI, DS]`` (the state entering each time tile,
    for the backward). ``launches`` counts the kernel's launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, delta, xs, B, C, A, reset, h0):
        T, DI, DS = _check(delta, xs, B, C, A, reset, h0)
        if tuple(h0.shape) != (DI, DS):
            raise ValueError(f"h0 must be [{DI}, {DS}]")
        dev = delta.device
        f32 = torch.float32
        y = torch.empty((T, DI), dtype=f32, device=dev)
        h_last = torch.empty((DI, DS), dtype=f32, device=dev)
        ckpt = torch.empty((T // SCAN_TILE, DI, DS), dtype=f32, device=dev)
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.fwd(delta.data_ptr(), xs.data_ptr(), B.data_ptr(),
                         C.data_ptr(), A.data_ptr(), reset.data_ptr(),
                         h0.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                         ckpt.data_ptr(), T, DI, DS, _XS_CODE[xs.dtype],
                         stream)
        if rc != 0:
            raise RuntimeError(f"mamba_scan_fwd_kernel launch failed with "
                               f"cudaError {rc} (T={T}, DI={DI}, DS={DS}, "
                               f"xs {xs.dtype})")
        self.launches += 1
        return y, h_last, ckpt


class MambaScanBwd:
    """``(delta, xs, B, C, A, reset, ckpt, dy, dh_last, want_y) -> (d_delta,
    d_xs, ws, dA, dh0, y)``, float32: the per-block dB/dC partials ``ws``
    go to :data:`mamba_scan_reduce_cuda`; ``y`` (the recomputed forward
    output) is None unless ``want_y``; ``dh_last`` may be None (zero).
    ``launches`` counts the kernel's launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, delta, xs, B, C, A, reset, ckpt, dy, dh_last=None,
                 want_y: bool = False):
        extra = (ckpt, dy) + ((dh_last,) if dh_last is not None else ())
        T, DI, DS = _check(delta, xs, B, C, A, reset, *extra)
        if tuple(ckpt.shape) != (T // SCAN_TILE, DI, DS) or \
                tuple(dy.shape) != (T, DI) or \
                (dh_last is not None and tuple(dh_last.shape) != (DI, DS)):
            raise ValueError(f"ckpt, dy and dh_last must be "
                             f"[{T // SCAN_TILE}, {DI}, {DS}], [{T}, {DI}] "
                             f"and [{DI}, {DS}]")
        dev = delta.device
        f32 = torch.float32
        d_delta = torch.empty((T, DI), dtype=f32, device=dev)
        d_xs = torch.empty((T, DI), dtype=f32, device=dev)
        y = torch.empty((T, DI), dtype=f32, device=dev) if want_y else None
        dA = torch.empty((DI, DS), dtype=f32, device=dev)
        dh0 = torch.empty((DI, DS), dtype=f32, device=dev)
        ws = torch.empty((_blocks(DI), T, 2 * DS), dtype=f32, device=dev)
        lib = load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.bwd(delta.data_ptr(), xs.data_ptr(), B.data_ptr(),
                         C.data_ptr(), A.data_ptr(), reset.data_ptr(),
                         ckpt.data_ptr(), dy.data_ptr(),
                         dh_last.data_ptr() if dh_last is not None else None,
                         d_delta.data_ptr(), d_xs.data_ptr(),
                         y.data_ptr() if y is not None else None,
                         dA.data_ptr(), dh0.data_ptr(), ws.data_ptr(), T, DI,
                         DS, _XS_CODE[xs.dtype], stream)
        if rc != 0:
            raise RuntimeError(f"mamba_scan_bwd_kernel launch failed with "
                               f"cudaError {rc} (T={T}, DI={DI}, DS={DS}, "
                               f"xs {xs.dtype})")
        self.launches += 1
        return d_delta, d_xs, ws, dA, dh0, y


class MambaScanReduce:
    """``ws [n_blocks, T, 2 DS] -> (dB [T, DS], dC [T, DS])`` float32, the
    partials summed in block order. ``launches`` counts the kernel's
    launches."""

    def __init__(self) -> None:
        self.launches = 0

    def __call__(self, ws):
        if not (isinstance(ws, torch.Tensor) and ws.is_cuda
                and ws.dtype == torch.float32 and ws.dim() == 3
                and ws.shape[2] % 2 == 0 and ws.is_contiguous()):
            raise ValueError("ws must be a contiguous float32 CUDA tensor "
                             "[n_blocks, T, 2 DS]")
        n_blocks, T, W = ws.shape
        DS = W // 2
        dB = torch.empty((T, DS), dtype=torch.float32, device=ws.device)
        dC = torch.empty((T, DS), dtype=torch.float32, device=ws.device)
        lib = load_library()
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        with torch.cuda.device(ws.device):
            rc = lib.reduce(ws.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                            n_blocks, T, DS, stream)
        if rc != 0:
            raise RuntimeError(f"mamba_scan_reduce_kernel launch failed with "
                               f"cudaError {rc} (n_blocks={n_blocks}, T={T}, "
                               f"DS={DS})")
        self.launches += 1
        return dB, dC


mamba_scan_fwd_cuda = MambaScanFwd()
mamba_scan_bwd_cuda = MambaScanBwd()
mamba_scan_reduce_cuda = MambaScanReduce()

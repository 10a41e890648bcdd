"""Hopper selective-scan kernels (mamba-1): load and launch wrappers.

Replace the JAX package's Pallas TPU kernel ``mamba_scan_pallas``
(``kernels/mamba_scan.py``, D) and add its gradient (D'), which the JAX
package takes by differentiating its jnp scan. The kernels are CUDA C++
for ``sm_90a`` in ``csrc/mamba_scan.cu`` (its header sets out the design,
a time-parallel chunked scan, and what bounds it), built at first use by
:mod:`.build` and called through ``ctypes`` on PyTorch's current stream.

Two wrappers, each counting its kernels' launches in ``by_kernel``:

* :data:`mamba_scan_fwd_cuda` (D): ``mamba_scan_fwd_summary_kernel``,
  ``mamba_scan_fwd_carry_kernel``, ``mamba_scan_fwd_emit_kernel``;
* :data:`mamba_scan_bwd_cuda` (D'): ``mamba_scan_bwd_summary_kernel``,
  ``mamba_scan_bwd_carry_kernel``, ``mamba_scan_bwd_tile_kernel`` and
  ``mamba_scan_reduce_kernel`` (the fixed-order sums of its partials).

Each takes the ungated scan (float32 delta, B, C; xs float32 or bf16) or,
with ``gate=`` (:class:`Gate`), the mamba mixer's scan with its softplus
prologue and skip-and-gate epilogue (every ``[T, *]`` input in the model's
dtype). Any ``T`` (the last time tile is masked in the kernels) and ``DS``
in :data:`STATE_SIZES`; ``[T, *]`` inputs may be row slices (unit column
stride). They take CUDA tensors only and raise on anything else; the
autograd functions and the CPU dispatch live in
:mod:`repro_torch.kernels.ops`, the plain versions in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import meta
from .build import load_libraries

__all__ = ["SCAN_TILE", "CHANNEL_GROUP", "STATE_SIZES", "Gate",
           "mamba_scan_fwd_cuda", "mamba_scan_bwd_cuda", "load_library"]

SCAN_TILE = 64              # time rows per tile and checkpoint (csrc: BT)
CHANNEL_GROUP = 64          # channels per dB/dC partial of D' (csrc: GROUP)
STATE_SIZES = (4, 16)       # the DS the kernels are built for
_TX_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the C struct ScanArgs, field by field (pointers, then ints)
_PTRS = ("pre", "xs", "B", "C", "A", "reset", "live", "bias", "z", "dskip",
         "h0", "dout", "dh_last", "out", "h_last", "ckpt", "dsum",
         "tile_reset", "uin", "d_pre", "d_x", "dz", "ws_bc",
         "ws_da", "ws_ch", "dB", "dC", "dA", "dh0", "d_bias", "d_dskip")
_INTS = ("T", "DI", "DS", "ld_pre", "ld_x", "ld_b", "ld_c", "ld_z",
         "ld_dout", "tx", "gate")


class ScanArgs(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS])


class Gate(NamedTuple):
    """The mixer's prologue and epilogue: ``bias [DI]`` (dt_bias) and
    ``d_skip [DI]`` float32, ``live [T]`` bool (False: a pad row, delta 0),
    ``z [T, DI]`` in the model's dtype."""
    bias: torch.Tensor
    live: torch.Tensor
    z: torch.Tensor
    d_skip: torch.Tensor


_ENTRY = {"mamba_scan_fwd_summary_kernel": "mamba_scan_fwd_summary",
          "mamba_scan_fwd_carry_kernel": "mamba_scan_fwd_carry",
          "mamba_scan_fwd_emit_kernel": "mamba_scan_fwd_emit",
          "mamba_scan_bwd_summary_kernel": "mamba_scan_bwd_summary",
          "mamba_scan_bwd_carry_kernel": "mamba_scan_bwd_carry",
          "mamba_scan_bwd_tile_kernel": "mamba_scan_bwd_tile",
          "mamba_scan_reduce_kernel": "mamba_scan_reduce"}


@dataclass(frozen=True)
class MambaScanLibrary:
    path: Path
    build_log: str
    entries: dict


@functools.lru_cache(maxsize=None)
def load_library() -> MambaScanLibrary:
    """The selective-scan library (built with the others at first use)."""
    built = load_libraries()["mamba_scan"]
    lib = built.lib
    for name, want in (("mamba_scan_tile", SCAN_TILE),
                       ("mamba_scan_group", CHANNEL_GROUP),
                       ("mamba_scan_args_size", ctypes.sizeof(ScanArgs))):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"{built.path.name}: {name}() = {fn()} but "
                               f"the wrapper expects {want}")
    entries = {}
    for kernel, sym in _ENTRY.items():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.POINTER(ScanArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[kernel] = fn
    return MambaScanLibrary(path=built.path, build_log=built.build_log,
                            entries=entries)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _rows(t, name, T, W, dtypes):
    """Check a ``[T, W]`` input with unit column stride; its row stride."""
    if tuple(t.shape) != (T, W):
        raise ValueError(f"{name} must be [{T}, {W}]: {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}: {t.dtype}")
    if (W > 1 and t.stride(1) != 1) or (T > 1 and t.stride(0) < W):
        raise ValueError(f"{name} must have unit column stride and rows "
                         f"of at least {W}: strides {t.stride()}")
    return t.stride(0)


def _exact(t, name, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} {list(shape)}: "
                         f"{t.dtype} {tuple(t.shape)}")


def _args(pre, xs, B, C, A, reset, gate, h0=None, dout=None):
    """The checked argument block of one call (without outputs) and the
    shapes ``(T, DI, DS, dtype of the [T, *] outputs)``."""
    ts = [t for t in (pre, xs, B, C, A, reset, h0, dout) if t is not None]
    if gate is not None:
        ts += list(gate)
    if not all(isinstance(t, torch.Tensor) and meta.on_card(t) for t in ts):
        raise ValueError("the selective-scan kernels take CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("selective-scan kernel: tensors on different "
                         "devices")
    if pre.dim() != 2 or B.dim() != 2:
        raise ValueError(f"delta {tuple(pre.shape)} must be [T, DI] and B "
                         f"{tuple(B.shape)} [T, DS]")
    T, DI = pre.shape
    DS = B.shape[1]
    if T == 0 or -(-T // SCAN_TILE) > 65535 or DS not in STATE_SIZES:
        raise ValueError(f"T={T} must be in [1, {65535 * SCAN_TILE}] and "
                         f"DS={DS} one of {STATE_SIZES}")
    f32 = torch.float32
    if xs.dtype not in _TX_CODE:
        raise ValueError(f"xs must be one of {tuple(_TX_CODE)}: {xs.dtype}")
    tx = xs.dtype
    row_t = (tx,) if gate is not None else (f32,)
    a = ScanArgs(T=T, DI=DI, DS=DS, tx=_TX_CODE[tx],
                 gate=int(gate is not None))
    a.ld_pre = _rows(pre, "delta (gated: dt_pre)", T, DI, row_t)
    a.ld_x = _rows(xs, "xs", T, DI, (tx,))
    a.ld_b = _rows(B, "B", T, DS, row_t)
    a.ld_c = _rows(C, "C", T, DS, row_t)
    _exact(A, "A", (DI, DS), f32)
    _exact(reset, "reset", (T,), torch.bool)
    a.pre, a.xs, a.B, a.C = (_ptr(t) for t in (pre, xs, B, C))
    a.A, a.reset = _ptr(A), _ptr(reset)
    if h0 is not None:
        _exact(h0, "h0", (DI, DS), f32)
        a.h0 = _ptr(h0)
    if gate is not None:
        _exact(gate.bias, "dt_bias", (DI,), f32)
        _exact(gate.d_skip, "d_skip", (DI,), f32)
        _exact(gate.live, "live", (T,), torch.bool)
        a.ld_z = _rows(gate.z, "z", T, DI, (tx,))
        a.bias, a.dskip = _ptr(gate.bias), _ptr(gate.d_skip)
        a.live, a.z = _ptr(gate.live), _ptr(gate.z)
    if dout is not None:
        a.ld_dout = _rows(dout, "dout (ungated: dy)", T, DI, row_t)
        a.dout = _ptr(dout)
    return a, (T, DI, DS, tx if gate is not None else f32)


# operations per (row, channel, state) of D and D′ (PERF.md §6), booked on
# each function's main pass
_META_OPS = {"mamba_scan_fwd_emit_kernel": 8, "mamba_scan_bwd_tile_kernel": 16}


class _Call:
    """One call's argument block, the tensors it points into (kept alive)
    and the launch of each of its kernels."""

    def __init__(self, owner, args, device, keep):
        self.owner, self.args, self.device, self.keep = owner, args, device, \
            keep

    def launch(self, kernel: str) -> None:
        """Launch ``kernel`` (one of the owner's ``KERNELS``) on the current
        stream; its launch count goes up by one. On meta (:mod:`.meta`) it
        books the call instead: D's operations on its emit pass, D′'s on
        its per-tile pass."""
        if self.device.type == "meta":
            a = self.args
            meta.tally(kernel, _META_OPS.get(kernel, 0) * a.T * a.DI * a.DS)
            return
        lib = load_library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            rc = lib.entries[kernel](ctypes.byref(self.args), stream)
        if rc != 0:
            a = self.args
            raise RuntimeError(f"{kernel} launch failed with cudaError {rc} "
                               f"(T={a.T}, DI={a.DI}, DS={a.DS}, tx={a.tx}, "
                               f"gate={a.gate})")
        self.owner.by_kernel[kernel] += 1

    def run(self):
        for kernel in self.owner.KERNELS:
            self.launch(kernel)


class MambaScanFwd:
    """Kernel D: ``(delta, xs, B, C, A, reset, h0, gate=None) -> (y,
    h_last, ckpt)``. Ungated: delta, B, C float32 and xs float32 or bf16,
    y ``[T, DI]`` float32 before the skip and the gate. Gated (``gate``):
    ``delta`` is the mixer's ``dt_pre`` and every ``[T, *]`` input is in
    xs's dtype; ``y`` is the mixer's output ``(scan + d_skip xs) silu(z)``
    in that dtype. h_last ``[DI, DS]`` and ckpt ``[ceil(T / SCAN_TILE), DI,
    DS]`` (the state entering each time tile, for D') are float32; reset
    is bool ``[T]``, A and h0 float32 ``[DI, DS]``."""

    KERNELS = ("mamba_scan_fwd_summary_kernel", "mamba_scan_fwd_carry_kernel",
               "mamba_scan_fwd_emit_kernel")

    def __init__(self) -> None:
        self.by_kernel = dict.fromkeys(self.KERNELS, 0)

    def prepare(self, delta, xs, B, C, A, reset, h0,
                gate: Optional[Gate] = None):
        """The call's kernels, not launched, and its outputs."""
        a, (T, DI, DS, out_t) = _args(delta, xs, B, C, A, reset, gate,
                                      h0=h0)
        dev, f32 = delta.device, torch.float32
        nT = -(-T // SCAN_TILE)
        y = torch.empty((T, DI), dtype=out_t, device=dev)
        h_last = torch.empty((DI, DS), dtype=f32, device=dev)
        ckpt = torch.empty((nT, DI, DS), dtype=f32, device=dev)
        dsum = torch.empty((nT, DI), dtype=f32, device=dev)
        flags = torch.empty((nT,), dtype=torch.int32, device=dev)
        a.out, a.h_last, a.ckpt = _ptr(y), _ptr(h_last), _ptr(ckpt)
        a.dsum, a.tile_reset = _ptr(dsum), _ptr(flags)
        keep = (delta, xs, B, C, A, reset, h0, gate, y, h_last, ckpt, dsum,
                flags)
        return _Call(self, a, dev, keep), (y, h_last, ckpt)

    def __call__(self, delta, xs, B, C, A, reset, h0,
                 gate: Optional[Gate] = None):
        call, out = self.prepare(delta, xs, B, C, A, reset, h0, gate)
        call.run()
        return out


class MambaScanBwd:
    """Kernel D': ``(delta, xs, B, C, A, reset, ckpt, dy, dh_last=None,
    gate=None)`` with D's inputs and ckpt, the output gradient ``dy``
    (gated: of the mixer's output, in xs's dtype) and ``dh_last`` (None:
    zero). Ungated it returns ``(d_delta, d_xs, dB, dC, dA, dh0)``,
    float32; gated ``(d_pre, d_xs, dz, dB, dC, dA, d_bias, d_dskip,
    dh0)``: the first three in xs's dtype, the rest float32."""

    KERNELS = ("mamba_scan_bwd_summary_kernel", "mamba_scan_bwd_carry_kernel",
               "mamba_scan_bwd_tile_kernel", "mamba_scan_reduce_kernel")

    def __init__(self) -> None:
        self.by_kernel = dict.fromkeys(self.KERNELS, 0)

    def prepare(self, delta, xs, B, C, A, reset, ckpt, dy, dh_last=None,
                gate: Optional[Gate] = None):
        """The call's kernels, not launched, and its outputs."""
        a, (T, DI, DS, out_t) = _args(delta, xs, B, C, A, reset, gate,
                                      dout=dy)
        dev, f32 = delta.device, torch.float32
        nT = -(-T // SCAN_TILE)
        _exact(ckpt, "ckpt", (nT, DI, DS), f32)
        if dh_last is not None:
            _exact(dh_last, "dh_last", (DI, DS), f32)
        n_groups = -(-DI // CHANNEL_GROUP)

        def new(*shape, dtype=f32):
            return torch.empty(shape, dtype=dtype, device=dev)
        d_pre, d_x = new(T, DI, dtype=out_t), new(T, DI, dtype=out_t)
        dz = new(T, DI, dtype=out_t) if gate is not None else None
        dB, dC, dA, dh0 = new(T, DS), new(T, DS), new(DI, DS), new(DI, DS)
        d_bias = new(DI) if gate is not None else None
        d_dskip = new(DI) if gate is not None else None
        uin, dsum = new(nT, DI, DS), new(nT, DI)
        flags = new(nT, dtype=torch.int32)
        ws_bc, ws_da = new(n_groups, T, 2 * DS), new(nT, DI, DS)
        ws_ch = new(2, nT, DI) if gate is not None else None
        a.ckpt, a.dh_last = _ptr(ckpt), _ptr(dh_last)
        a.uin, a.dsum, a.tile_reset = _ptr(uin), _ptr(dsum), _ptr(flags)
        a.d_pre, a.d_x, a.dz = _ptr(d_pre), _ptr(d_x), _ptr(dz)
        a.ws_bc, a.ws_da, a.ws_ch = _ptr(ws_bc), _ptr(ws_da), _ptr(ws_ch)
        a.dB, a.dC, a.dA, a.dh0 = (_ptr(t) for t in (dB, dC, dA, dh0))
        a.d_bias, a.d_dskip = _ptr(d_bias), _ptr(d_dskip)
        keep = (delta, xs, B, C, A, reset, ckpt, dy, dh_last, gate, d_pre,
                d_x, dz, dB, dC, dA, dh0, d_bias, d_dskip, uin, dsum, flags,
                ws_bc, ws_da, ws_ch)
        if gate is not None:
            out = (d_pre, d_x, dz, dB, dC, dA, d_bias, d_dskip, dh0)
        else:
            out = (d_pre, d_x, dB, dC, dA, dh0)
        return _Call(self, a, dev, keep), out

    def __call__(self, delta, xs, B, C, A, reset, ckpt, dy, dh_last=None,
                 gate: Optional[Gate] = None):
        call, out = self.prepare(delta, xs, B, C, A, reset, ckpt, dy,
                                 dh_last, gate)
        call.run()
        return out


mamba_scan_fwd_cuda = MambaScanFwd()
mamba_scan_bwd_cuda = MambaScanBwd()

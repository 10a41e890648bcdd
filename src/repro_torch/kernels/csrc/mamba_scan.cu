// Mamba-1 selective scan for Hopper, sm_90a: forward (D) and its gradient
// (D'), as a time-parallel chunked scan, optionally with the mamba mixer's
// softplus prologue and its skip-and-gate epilogue folded in.
//
// Replaces the Pallas TPU kernel of the JAX package's kernels/mamba_scan.py,
// mamba_scan_pallas (forward only; the JAX package differentiates its jnp
// scan instead):
//   a_t = exp(delta_t * A)   (0 where reset_t: the state restarts),
//   h_t = a_t * h_{t-1} + (delta_t * x_t) B_t,   h_{-1} = h0,
//   y_t = h_t . C_t,
// with delta, xs [T, DI], B, C [T, DS], A, h0 [DI, DS]. DS is 4 (the
// reduced test models) or 16 (hymba-1.5b, falcon-mamba-7b). Every sum is
// float32; the [T, DI, DS] outer products live in registers only.
//
// Two modes, one body each (template flag GATE):
// * ungated: delta, B, C float32, xs float32 or bf16 -> y [T, DI] float32
//   (before the skip and the gate), the function of the JAX package's
//   ops.mamba_scan;
// * gated (the mixer's, models/ssm.py:_ScanGate): pre = dt_in dt_proj^T,
//   xc, B, C, z and dout in the model's dtype TX, and
//     delta = live_t ? softplus(pre + dt_bias) : 0      (prologue)
//     out   = (y + d_skip * xc) * silu(z), rounded to TX (epilogue)
//   and in D' every gradient of those: d pre = d delta * sigmoid(pre +
//   dt_bias) (0 on pad rows), d xc (the scan's and the skip's), dz, the
//   per-channel sums d dt_bias and d d_skip. No float32 [T, DI] tensor
//   reaches device memory in this mode.
// Rows t >= T of the last tile are masked in the kernels (state-neutral):
// the caller pads nothing.
//
// Design. Time is cut into tiles of BT = 64 rows. The recurrence is affine,
// h_out = P h_in + Q per tile, with P = prod_t a_t (0 from a reset on) and
// Q the tile's end state from h = 0; the gradient's reverse recurrence
// u_{t-1} = a_t (u_t + g_t C_t) is affine the same way, with the same P.
// D runs three kernels:
//   (a) mamba_scan_fwd_summary_kernel: parallel over (tile, channel), one
//       thread per channel holding its DS states in registers (B and C of
//       the tile are a shared-memory broadcast): Q [tile, DI, DS] (written
//       into ckpt), the tile's sum of delta per channel (P = exp(A * sum);
//       a flag per tile marks a reset, where P = 0);
//   (b) mamba_scan_fwd_carry_kernel: one thread per (channel, state) walks
//       the T / 64 summaries, h_in[k+1] = P_k h_in[k] + Q_k from h0, turning
//       ckpt in place into the state entering each tile (what D' reads),
//       and writes h_last;
//   (c) mamba_scan_fwd_emit_kernel: parallel over (tile, channel) again,
//       re-expands each tile from its ckpt and writes y (the sum over the
//       states is a register sum) or, gated, out.
// D' runs four:
//   (a') mamba_scan_bwd_summary_kernel: per (tile, channel) the tile's
//        reverse map, R = the u leaving the tile leftwards from u = 0;
//   (b') mamba_scan_bwd_carry_kernel: per (channel, state), from dh_last
//        leftwards, u_in[k-1] = P_k u_in[k] + R_k (in place over R): the
//        gradient entering each tile from the right, and dh0;
//   (c') mamba_scan_bwd_tile_kernel: per (tile, group of 64 channels), two
//        threads per channel, each holding half of its states. The
//        group's per-row inputs (delta, x, the scan's dy) are computed once
//        into shared memory. A first walk keeps the state entering each
//        8-row sub-tile (shared memory); each sub-tile, last first, is
//        recomputed into registers (states and decays) and walked back from
//        the gradient entering the tile, so no thread holds more than 8
//        rows. The walks are branch-free and touch no device memory. Per
//        row, d delta, d x and the recomputed y are register sums and one
//        shuffle between the two halves, kept in shared memory over the
//        row's inputs; dB_t and dC_t are sums over channels: the warp's
//        terms go through shared memory, each lane sums one of the 2 DS
//        values over the warp's channels in a fixed order, the block adds
//        its warps in a fixed order per sub-tile and writes the group's
//        partial per row (not a shuffle reduce-scatter, whose four
//        dependent exchanges a row would chain the few warps an SM holds). The
//        per-row gradients (gated: d pre, d xc, dz with the prologue's and
//        the gate's factors) are written after the walks, coalesced; dA
//        (and, gated, d dt_bias, d d_skip) per tile.
//   (d') mamba_scan_reduce_kernel: dB, dC summed over the groups in group
//        order; dA, d dt_bias and d d_skip over the tiles in tile order.
// No atomics: every sum has a fixed order, so a repeat is bitwise equal.
// No thread walks more than one tile's rows, except the carry passes over
// T / 64 summaries.
//
// Bound: bytes. At hymba-1.5b's shape (T 16,384, DI 3,200, DS 16) the
// forward moves delta and xs in and y out (about 0.52 GB ungated); the
// gated forward reads pre, xc and z in bf16 and writes out in bf16. Against
// them stand about 8 float32 operations, one an exp, per (row, channel,
// state): 6.7 G. The exp (the decay, 2^(d A log2 e) by ex2.approx) runs on
// the special-function units, 16 a clock on an SM: ~0.23 ms per pass over
// the cells at that shape. The summary, emit and reverse summary passes
// take one each, the per-tile backward two (the first walk and the
// recompute, whose decays the walk back reuses): these units, and not the
// bytes, set this design's floor. The channel per thread (or per thread
// pair) layout keeps per-row values and B, C out of the shared-memory and
// shuffle pipe, which a thread per (channel, state) saturated.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// One call's arguments (the wrapper fills a ctypes mirror of this struct:
// all pointers first, then the ints, in this order).
struct ScanArgs {
  const void* pre;        // delta [T, DI] float32, or gated dt_pre [T, DI] TX
  const void* xs;         // [T, DI] TX
  const void* B;          // [T, DS] float32, or gated TX
  const void* C;          // [T, DS] float32, or gated TX
  const float* A;         // [DI, DS]
  const uint8_t* reset;   // [T] bool
  const uint8_t* live;    // [T] bool (gated)
  const float* bias;      // [DI] dt_bias (gated)
  const void* z;          // [T, DI] TX (gated)
  const float* dskip;     // [DI] (gated)
  const float* h0;        // [DI, DS]
  const void* dout;       // D': dy [T, DI] float32, or gated dout TX
  const float* dh_last;   // D': [DI, DS] or null (zero)
  void* out;              // D: y [T, DI] float32, or gated out TX
  float* h_last;          // D: [DI, DS]
  float* ckpt;            // [nT, DI, DS]: D's Q, then the state entering each tile
  float* dsum;            // [nT, DI] workspace: the tile's sum of delta
  int* tile_reset;        // [nT] workspace: 1 where a row of the tile resets
  float* uin;             // D': [nT, DI, DS] R, then the gradient entering each tile
  void* d_pre;            // D': d delta [T, DI] float32, or gated d dt_pre TX
  void* d_x;              // D': d xs [T, DI] float32, or gated d xc TX
  void* dz;               // D': gated dz [T, DI] TX
  float* ws_bc;           // D': [n_groups, T, 2 DS] per-group partials of dB, dC
  float* ws_da;           // D': [nT, DI, DS] per-tile partials of dA
  float* ws_ch;           // D': gated [2, nT, DI] per-tile d dt_bias, d d_skip
  float* dB;              // D': [T, DS]
  float* dC;              // D': [T, DS]
  float* dA;              // D': [DI, DS]
  float* dh0;             // D': [DI, DS]
  float* d_bias;          // D': gated [DI]
  float* d_dskip;         // D': gated [DI]
  int T, DI, DS;
  int ld_pre, ld_x, ld_b, ld_c, ld_z, ld_dout;  // row strides (elements)
  int tx;                 // xs's type (gated: every [T, *] tensor's): 0 float32, 1 bf16
  int gate;               // 0 ungated, 1 gated
};

namespace {

constexpr int BT = 64;            // rows per time tile (and per checkpoint)
constexpr int FWD_THREADS = 128;  // channels per block of (a), (c), (a')
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_BATCH = 16;   // summaries a carry thread loads at once
constexpr int GROUP = 64;         // channels per block of (c') (its dB/dC partial)
constexpr int TILE_THREADS = 2 * GROUP;  // (c'): two threads per channel
constexpr int SUB = 8;            // rows per sub-tile of (c')'s recompute
constexpr int NSUB = BT / SUB;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// 1 / (1 + e^-v), the reciprocal correctly rounded (as 1.f / x, cheaper).
__device__ __forceinline__ float sigmoid_f(float v) { return __frcp_rn(1.f + expf(-v)); }

// An input element as float, through the read-only path (the kernels never
// write what they read, so these loads may run ahead of any store).
__device__ __forceinline__ float ld(const float* q) { return __ldg(q); }
__device__ __forceinline__ float ld(const __nv_bfloat16* q) { return __bfloat162float(__ldg(q)); }

// The decay a = exp(d A) as 2^(d A log2 e) on the special-function unit
// (ex2.approx: relative error ~2^-22; a result below 2^-126 is 0). Every
// pass computes it with this one function from a2 = A log2 e, so the
// forward and the backward's recompute agree bit for bit.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float decay(float d, float a2, bool rst) {
  return rst ? 0.f : ex2(d * a2);
}

// The type of pre, B, C and dout: the model's (TX) gated, float32 ungated.
template <typename TX, bool GATE>
using InT = typename std::conditional<GATE, TX, float>::type;

// The raw [T, DI] inputs of (row t, channel c) a pass reads, as floats:
// pre (delta ungated), x, z (gated), and dout (dy ungated). Loading a row
// apart from the math on it lets a loop issue the next row's loads first.
struct RowRaw {
  float pre, x, z, g;
};

template <typename TX, bool GATE, bool X, bool Z, bool G>
__device__ __forceinline__ RowRaw load_row(const ScanArgs& p, int t, int c) {
  using T = InT<TX, GATE>;
  RowRaw v{0.f, 0.f, 0.f, 0.f};
  v.pre = ld(static_cast<const T*>(p.pre) + (size_t)t * p.ld_pre + c);
  if (X) v.x = ld(static_cast<const TX*>(p.xs) + (size_t)t * p.ld_x + c);
  if (GATE && Z) v.z = ld(static_cast<const TX*>(p.z) + (size_t)t * p.ld_z + c);
  if (G) v.g = ld(static_cast<const T*>(p.dout) + (size_t)t * p.ld_dout + c);
  return v;
}

// delta: ungated the input; gated the prologue, softplus as torch's
// (threshold 20), 0 on a pad row.
template <bool GATE>
__device__ __forceinline__ float row_delta(float pre, float bias, bool live) {
  if (!GATE) return pre;
  if (!live) return 0.f;
  const float q = pre + bias;
  return q > 20.f ? q : log1pf(expf(q));
}

// The output gradient the scan sees: ungated dy; gated dout * silu(z).
template <bool GATE>
__device__ __forceinline__ float row_g(const RowRaw& v) {
  return GATE ? v.g * (v.z * sigmoid_f(v.z)) : v.g;
}

// Stages B and/or C of rows [t0, t0 + BT) (0 beyond T) and the reset / live
// flags.
template <int DS, typename TB, bool GATE>
__device__ __forceinline__ void stage_bc(const ScanArgs& p, int t0, int rows, float (*s_b)[DS],
                                         float (*s_c)[DS], uint8_t* s_r, uint8_t* s_l, int tid,
                                         int nth) {
  for (int i = tid; i < BT * DS; i += nth) {
    const int r = i / DS, s = i % DS;
    float b = 0.f, cv = 0.f;
    if (r < rows) {
      if (s_b) b = ld(static_cast<const TB*>(p.B) + (size_t)(t0 + r) * p.ld_b + s);
      cv = ld(static_cast<const TB*>(p.C) + (size_t)(t0 + r) * p.ld_c + s);
    }
    if (s_b) s_b[r][s] = b;
    s_c[r][s] = cv;
  }
  for (int i = tid; i < BT; i += nth) {
    s_r[i] = i < rows ? p.reset[t0 + i] : 0;
    s_l[i] = i < rows ? (GATE ? p.live[t0 + i] : 1) : 0;
  }
}

// (a) and (c): one thread per channel, its DS states in registers, walks
// the tile's rows from 0 (summary) or from its checkpoint (emit).
template <int DS, typename TX, bool GATE, bool EMIT>
__device__ __forceinline__ void fwd_tile(const ScanArgs& p) {
  __shared__ float s_b[BT][DS], s_c[BT][DS];
  __shared__ uint8_t s_r[BT], s_l[BT];
  const int k = blockIdx.y, t0 = k * BT;
  const int rows = min(BT, p.T - t0);
  const int c = blockIdx.x * FWD_THREADS + threadIdx.x;
  stage_bc<DS, InT<TX, GATE>, GATE>(p, t0, rows, s_b, s_c, s_r, s_l, threadIdx.x,
                                    FWD_THREADS);
  __syncthreads();
  if (!EMIT && blockIdx.x == 0 && threadIdx.x == 0) {
    int any = 0;
    for (int r = 0; r < rows; ++r) any |= s_r[r];
    p.tile_reset[k] = any;
  }
  if (c >= p.DI) return;  // no barrier below
  const size_t hbase = ((size_t)k * p.DI + c) * DS;
  float a_c[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a_c[s] = p.A[(size_t)c * DS + s] * LOG2E;
    h[s] = EMIT ? p.ckpt[hbase + s] : 0.f;
  }
  const float bias = GATE ? p.bias[c] : 0.f;
  const float dsk = (GATE && EMIT) ? p.dskip[c] : 0.f;
  float dsum = 0.f;
  RowRaw next = load_row<TX, GATE, true, EMIT, false>(p, t0, c);
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const int t = t0 + r;
    const RowRaw cur = next;
    if (r + 1 < rows) next = load_row<TX, GATE, true, EMIT, false>(p, t + 1, c);
    const float d = row_delta<GATE>(cur.pre, bias, s_l[r]), x = cur.x;
    const bool rst = s_r[r];
    const float dx = d * x;
    float y = 0.f;
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      const float a = decay(d, a_c[s], rst);
      h[s] = fmaf(a, h[s], dx * s_b[r][s]);
      if (EMIT) y = fmaf(h[s], s_c[r][s], y);
    }
    if (EMIT) {
      const size_t o = (size_t)t * p.DI + c;
      if (GATE) {
        const float v = (y + x * dsk) * (cur.z * sigmoid_f(cur.z));
        static_cast<TX*>(p.out)[o] = from_f<TX>(v);
      } else {
        static_cast<float*>(p.out)[o] = y;
      }
    } else {
      dsum += d;
    }
  }
  if (!EMIT) {
#pragma unroll
    for (int s = 0; s < DS; ++s) p.ckpt[hbase + s] = h[s];
    p.dsum[(size_t)k * p.DI + c] = dsum;
  }
}

template <int DS, typename TX, bool GATE>
__global__ void __launch_bounds__(FWD_THREADS) mamba_scan_fwd_summary_kernel(ScanArgs p) {
  fwd_tile<DS, TX, GATE, false>(p);
}

template <int DS, typename TX, bool GATE>
__global__ void __launch_bounds__(FWD_THREADS) mamba_scan_fwd_emit_kernel(ScanArgs p) {
  fwd_tile<DS, TX, GATE, true>(p);
}

// The decay over a whole tile: 0 where it resets, else exp(A * sum delta).
__device__ __forceinline__ float tile_decay(const ScanArgs& p, int k, int c, float a2) {
  return decay(p.dsum[(size_t)k * p.DI + c], a2, p.tile_reset[k]);
}

// One carry over the tiles, in place: for each tile k in order (last to
// first when REV), io[k] <- x (the value entering it) and x <- P_k x +
// io[k]. Loads run CARRY_BATCH tiles ahead of the dependent chain.
template <bool REV>
__device__ __forceinline__ float carry(const ScanArgs& p, float* io, float x, int i, int c,
                                       float a2) {
  const int n = p.DI * p.DS, nT = (p.T + BT - 1) / BT;
  for (int b0 = 0; b0 < nT; b0 += CARRY_BATCH) {
    float q[CARRY_BATCH], P[CARRY_BATCH];
#pragma unroll
    for (int j = 0; j < CARRY_BATCH; ++j) {
      const int k = REV ? nT - 1 - (b0 + j) : b0 + j;
      if (b0 + j < nT) {
        q[j] = io[(size_t)k * n + i];
        P[j] = tile_decay(p, k, c, a2);
      }
    }
#pragma unroll
    for (int j = 0; j < CARRY_BATCH; ++j) {
      const int k = REV ? nT - 1 - (b0 + j) : b0 + j;
      if (b0 + j < nT) {
        io[(size_t)k * n + i] = x;
        x = fmaf(P[j], x, q[j]);
      }
    }
  }
  return x;
}

// (b): h_in[k+1] = P_k h_in[k] + Q_k from h0; ckpt[k] <- h_in[k] in place
// over Q_k; h_last.
__global__ void __launch_bounds__(CARRY_THREADS) mamba_scan_fwd_carry_kernel(ScanArgs p) {
  const int i = blockIdx.x * CARRY_THREADS + threadIdx.x;  // c * DS + s
  if (i >= p.DI * p.DS) return;
  p.h_last[i] = carry<false>(p, p.ckpt, p.h0[i], i, i / p.DS, p.A[i] * LOG2E);
}

// (a'): per (tile, channel), the tile's reverse map from u = 0: for t from
// the tile's last row down, u <- a_t (u + g_t C_t).
template <int DS, typename TX, bool GATE>
__global__ void __launch_bounds__(FWD_THREADS) mamba_scan_bwd_summary_kernel(ScanArgs p) {
  __shared__ float s_c[BT][DS];
  __shared__ uint8_t s_r[BT], s_l[BT];
  const int k = blockIdx.y, t0 = k * BT;
  const int rows = min(BT, p.T - t0);
  const int c = blockIdx.x * FWD_THREADS + threadIdx.x;
  stage_bc<DS, InT<TX, GATE>, GATE>(p, t0, rows, nullptr, s_c, s_r, s_l, threadIdx.x,
                                    FWD_THREADS);
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int any = 0;
    for (int r = 0; r < rows; ++r) any |= s_r[r];
    p.tile_reset[k] = any;
  }
  if (c >= p.DI) return;
  float a_c[DS], u[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a_c[s] = p.A[(size_t)c * DS + s] * LOG2E;
    u[s] = 0.f;
  }
  const float bias = GATE ? p.bias[c] : 0.f;
  float dsum = 0.f;
  RowRaw next = load_row<TX, GATE, false, true, true>(p, t0 + rows - 1, c);
#pragma unroll 2
  for (int r = rows - 1; r >= 0; --r) {
    const RowRaw cur = next;
    if (r > 0) next = load_row<TX, GATE, false, true, true>(p, t0 + r - 1, c);
    const float d = row_delta<GATE>(cur.pre, bias, s_l[r]), g = row_g<GATE>(cur);
    const bool rst = s_r[r];
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      u[s] = decay(d, a_c[s], rst) * fmaf(g, s_c[r][s], u[s]);
    }
    dsum += d;
  }
  const size_t hbase = ((size_t)k * p.DI + c) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) p.uin[hbase + s] = u[s];
  p.dsum[(size_t)k * p.DI + c] = dsum;
}

// (b'): from dh_last leftwards, u_in[k-1] = P_k u_in[k] + R_k; uin[k] <-
// u_in[k] in place over R_k; dh0 = the gradient leaving tile 0.
__global__ void __launch_bounds__(CARRY_THREADS) mamba_scan_bwd_carry_kernel(ScanArgs p) {
  const int i = blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (i >= p.DI * p.DS) return;
  p.dh0[i] = carry<true>(p, p.uin, p.dh_last ? p.dh_last[i] : 0.f, i, i / p.DS,
                         p.A[i] * LOG2E);
}

// Shared memory of (c') (dynamic: about 101 KB at DS 16, two blocks an SM).
template <int DS>
struct TileSmem {
  static constexpr int NW = TILE_THREADS / 32;
  float hsub[NSUB][DS / 2][TILE_THREADS];  // each thread's state entering each sub-tile
  // per (row, channel): delta, x and the scan's dy, which the walk back
  // replaces row by row with d delta, d x and (gated) the gate's input
  float d[BT][GROUP], x[BT][GROUP], g[BT][GROUP];
  float b[BT][DS], c[BT][DS];
  float pt[NW][DS][34];                    // per-warp dB/dC terms of one row (padded)
  float pw[NW][SUB][2 * DS];               // per-warp dB/dC sums of a sub-tile
  float cs[2][GROUP];                      // gated: the d dt_bias halves of the tile
  uint8_t r[BT], l[BT];
};

// H consecutive floats of shared memory (16-byte aligned when H % 4 == 0).
template <int H>
__device__ __forceinline__ void load_h(const float* src, float* v) {
  if constexpr (H % 4 == 0) {
#pragma unroll
    for (int j = 0; j < H; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] = src[j];
  }
}

// One recurrence step of a thread's H states at row r (rows beyond T are
// staged as zeros: decay 1, no input).
template <int DS, int H>
__device__ __forceinline__ void step_h(const TileSmem<DS>& sm, int r, int cl, int s0,
                                       const float* a2, float* h, float* a_out) {
  const float d = sm.d[r][cl], dx = d * sm.x[r][cl];
  const bool rst = sm.r[r];
  float b[H];
  load_h<H>(&sm.b[r][s0], b);
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float a = decay(d, a2[j], rst);
    if (a_out) a_out[j] = a;
    h[j] = fmaf(a, h[j], dx * b[j]);
  }
}

// (c'): per (tile, group of GROUP channels), two threads per channel, each
// holding half of its states. The walks are branch-free (rows beyond T are
// neutral zeros) and touch no device memory: the group's per-row inputs
// are staged first, the per-row gradients are written after.
template <int DS, typename TX, bool GATE>
__global__ void __launch_bounds__(TILE_THREADS, 2) mamba_scan_bwd_tile_kernel(ScanArgs p) {
  constexpr int H = DS / 2, NW = TileSmem<DS>::NW, PF = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<DS>& sm = *reinterpret_cast<TileSmem<DS>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid >> 1, half = tid & 1, s0 = half * H;
  const int k = blockIdx.y, t0 = k * BT;
  const int rows = min(BT, p.T - t0);
  const int cb = blockIdx.x * GROUP, c = cb + cl;
  const bool own = c < p.DI;
  stage_bc<DS, InT<TX, GATE>, GATE>(p, t0, rows, sm.b, sm.c, sm.r, sm.l, tid, TILE_THREADS);
  __syncthreads();  // the flags are staged
  // the group's per-row inputs, once (0 beyond T and DI): PF elements'
  // loads (clamped into range), then their math
  for (int i0 = tid; i0 < BT * GROUP; i0 += PF * TILE_THREADS) {
    float d[PF], x[PF], g[PF];
    RowRaw raw[PF];
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      const int i = i0 + f * TILE_THREADS;
      raw[f] = load_row<TX, GATE, true, true, true>(p, t0 + min(i / GROUP, rows - 1),
                                                    min(cb + i % GROUP, p.DI - 1));
    }
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      const int i = i0 + f * TILE_THREADS, r = i / GROUP, ch = cb + i % GROUP;
      const bool ok = i < BT * GROUP && r < rows && ch < p.DI;
      d[f] = ok ? row_delta<GATE>(raw[f].pre, GATE ? p.bias[ch] : 0.f, sm.l[r]) : 0.f;
      x[f] = ok ? raw[f].x : 0.f;
      g[f] = ok ? row_g<GATE>(raw[f]) : 0.f;
    }
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      const int i = i0 + f * TILE_THREADS;
      if (i < BT * GROUP) {
        sm.d[i / GROUP][i % GROUP] = d[f];
        sm.x[i / GROUP][i % GROUP] = x[f];
        sm.g[i / GROUP][i % GROUP] = g[f];
      }
    }
  }
  __syncthreads();
  const size_t hbase = ((size_t)k * p.DI + c) * DS + s0;
  float a2[H], h[H], u[H], da[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    a2[j] = own ? p.A[(size_t)c * DS + s0 + j] * LOG2E : 0.f;
    h[j] = own ? p.ckpt[hbase + j] : 0.f;
    u[j] = own ? p.uin[hbase + j] : 0.f;
    da[j] = 0.f;
  }
  const float dsk = (GATE && own) ? p.dskip[c] : 0.f;
  float sk = 0.f;  // gated, half 1: d d_skip over the tile
  // walk 1: the state entering each sub-tile
#pragma unroll 1
  for (int q = 0; q < NSUB; ++q) {
#pragma unroll
    for (int j = 0; j < H; ++j) sm.hsub[q][j][tid] = h[j];
#pragma unroll
    for (int i = 0; i < SUB; ++i) step_h<DS, H>(sm, q * SUB + i, cl, s0, a2, h, nullptr);
  }
  // each sub-tile, last first: recompute its states, then walk it back
#pragma unroll 1
  for (int q = NSUB - 1; q >= 0; --q) {
    float hs[SUB + 1][H], as[SUB][H];  // hs[i + 1]: the state after row i
#pragma unroll
    for (int j = 0; j < H; ++j) hs[0][j] = sm.hsub[q][j][tid];
#pragma unroll
    for (int i = 0; i < SUB; ++i) {
#pragma unroll
      for (int j = 0; j < H; ++j) hs[i + 1][j] = hs[i][j];
      step_h<DS, H>(sm, q * SUB + i, cl, s0, a2, hs[i + 1], as[i]);
    }
#pragma unroll
    for (int i = SUB - 1; i >= 0; --i) {
      const int r = q * SUB + i;
      const float d = sm.d[r][cl], x = sm.x[r][cl], g = sm.g[r][cl];
      float b[H], cv[H];
      load_h<H>(&sm.b[r][s0], b);
      load_h<H>(&sm.c[r][s0], cv);
      float sa = 0.f, sb = 0.f, yv = 0.f, v[2 * H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float a = as[i][j];
        const float dh = fmaf(g, cv[j], u[j]);   // dh_t
        const float dadt = dh * hs[i][j] * a;     // through a_t = exp(d A)
        da[j] = fmaf(dadt, d, da[j]);
        sa = fmaf(dadt, a2[j], sa);
        sb = fmaf(dh, b[j], sb);
        yv = fmaf(hs[i + 1][j], cv[j], yv);
        v[j] = dh * (d * x);                      // dB's term
        v[H + j] = g * hs[i + 1][j];              // dC's term
        u[j] = a * dh;                            // the gradient into h_{t-1}
      }
      // the channel's sums: both halves
      sa += __shfl_xor_sync(FULL, sa, 1);
      sb += __shfl_xor_sync(FULL, sb, 1);
      yv += __shfl_xor_sync(FULL, yv, 1);
      // the row's per-channel results replace its inputs, which both halves
      // have read (__syncwarp orders those reads before these writes)
      __syncwarp();
      if (half == 0) {
        sm.d[r][cl] = fmaf(x, sb, sa * LN2);      // d delta
        if (GATE) sm.g[r][cl] = yv + x * dsk;   // the gate's input
      } else {
        sm.x[r][cl] = GATE ? fmaf(g, dsk, d * sb) : d * sb;  // d x
        if (GATE) sk = fmaf(g, x, sk);
      }
      // dB, dC over the warp's 16 channels, through shared memory: each lane
      // writes its 2H terms (the previous row's sums have read sm.pt before
      // the __syncwarp above), then lane l sums value (l >> 1) & (2H - 1)
      // of its half over the 16 channels in a fixed order
#pragma unroll
      for (int j = 0; j < 2 * H; ++j) sm.pt[warp][j][lane] = v[j];
      __syncwarp();
      if (lane < 4 * H) {
        const int idx = (lane >> 1) & (2 * H - 1);
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          v0 += sm.pt[warp][idx][2 * j + half];
          v1 += sm.pt[warp][idx][2 * j + 2 + half];
        }
        sm.pw[warp][i][idx < H ? s0 + idx : DS + s0 + (idx - H)] = v0 + v1;
      }
    }
    __syncthreads();
    for (int i = tid; i < SUB * 2 * DS; i += TILE_THREADS) {
      const int j = i / (2 * DS), e = i % (2 * DS), r = q * SUB + j;
      if (r < rows) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) v += sm.pw[w][j][e];
        p.ws_bc[((size_t)blockIdx.x * p.T + t0 + r) * 2 * DS + e] = v;
      }
    }
    __syncthreads();
  }
  if (own) {
#pragma unroll
    for (int j = 0; j < H; ++j) p.ws_da[hbase + j] = da[j];
  }
  // per (row, channel): the gradients, two threads per channel, each half
  // of the rows, EB rows' loads at a time (gated: with the prologue's and
  // the gate's factors)
  {
    constexpr int EB = 8;
    const int ch_l = tid % GROUP, r0 = (tid / GROUP) * (BT / 2), ch = cb + ch_l;
    float sb = 0.f;  // gated: d dt_bias over these rows
    if (ch < p.DI) {
      const float bias = GATE ? p.bias[ch] : 0.f;
      for (int e0 = r0; e0 < r0 + BT / 2; e0 += EB) {
        float pre[EB], gr[EB], zv[EB];
        if (GATE) {
#pragma unroll
          for (int e = 0; e < EB; ++e) {
            const int t = t0 + min(e0 + e, rows - 1);
            pre[e] = ld(static_cast<const TX*>(p.pre) + (size_t)t * p.ld_pre + ch);
            gr[e] = ld(static_cast<const TX*>(p.dout) + (size_t)t * p.ld_dout + ch);
            zv[e] = ld(static_cast<const TX*>(p.z) + (size_t)t * p.ld_z + ch);
          }
        }
#pragma unroll
        for (int e = 0; e < EB; ++e) {
          const int r = e0 + e;
          if (r >= rows) break;
          const size_t o = (size_t)(t0 + r) * p.DI + ch;
          if (GATE) {
            const float dp = sm.l[r] ? sm.d[r][ch_l] * sigmoid_f(pre[e] + bias) : 0.f;
            const float sz = sigmoid_f(zv[e]);
            static_cast<TX*>(p.d_pre)[o] = from_f<TX>(dp);
            static_cast<TX*>(p.dz)[o] =
                from_f<TX>(gr[e] * sm.g[r][ch_l] * (sz * (1.f + zv[e] * (1.f - sz))));
            static_cast<TX*>(p.d_x)[o] = from_f<TX>(sm.x[r][ch_l]);
            sb += dp;
          } else {
            static_cast<float*>(p.d_pre)[o] = sm.d[r][ch_l];
            static_cast<float*>(p.d_x)[o] = sm.x[r][ch_l];
          }
        }
      }
    }
    if (GATE) {
      sm.cs[tid / GROUP][ch_l] = sb;
      __syncthreads();
      if (own && half == 1) {  // one thread per channel writes its sums
        const size_t nch = (size_t)((p.T + BT - 1) / BT) * p.DI;
        p.ws_ch[(size_t)k * p.DI + c] = sm.cs[0][cl] + sm.cs[1][cl];
        p.ws_ch[nch + (size_t)k * p.DI + c] = sk;
      }
    }
  }
}

// (d'): dB, dC over the groups in group order; dA, d dt_bias, d d_skip over
// the tiles in tile order.
__global__ void __launch_bounds__(256) mamba_scan_reduce_kernel(ScanArgs p, int n_groups) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int DS = p.DS, nT = (p.T + BT - 1) / BT;
  const int n_bc = p.T * 2 * DS, n_da = p.DI * DS, n_ch = p.gate ? 2 * p.DI : 0;
  if (i < n_bc) {
    float v = 0.f;
    for (int g = 0; g < n_groups; ++g) v += p.ws_bc[(size_t)g * n_bc + i];
    const int t = i / (2 * DS), e = i % (2 * DS);
    if (e < DS)
      p.dB[(size_t)t * DS + e] = v;
    else
      p.dC[(size_t)t * DS + (e - DS)] = v;
  } else if (i < n_bc + n_da) {
    const int j = i - n_bc;
    float v = 0.f;
    for (int k = 0; k < nT; ++k) v += p.ws_da[(size_t)k * n_da + j];
    p.dA[j] = v;
  } else if (i < n_bc + n_da + n_ch) {
    const int j = i - n_bc - n_da, which = j / p.DI, c = j % p.DI;
    const float* src = p.ws_ch + (size_t)which * nT * p.DI;
    float v = 0.f;
    for (int k = 0; k < nT; ++k) v += src[(size_t)k * p.DI + c];
    (which ? p.d_dskip : p.d_bias)[c] = v;
  }
}

int n_tiles(const ScanArgs& p) { return (p.T + BT - 1) / BT; }
int n_groups(const ScanArgs& p) { return (p.DI + GROUP - 1) / GROUP; }

template <int DS, typename TX, bool GATE>
struct Launch {
  static int fwd_summary(const ScanArgs& p, cudaStream_t st) {
    dim3 grid((p.DI + FWD_THREADS - 1) / FWD_THREADS, n_tiles(p));
    mamba_scan_fwd_summary_kernel<DS, TX, GATE><<<grid, FWD_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  static int fwd_emit(const ScanArgs& p, cudaStream_t st) {
    dim3 grid((p.DI + FWD_THREADS - 1) / FWD_THREADS, n_tiles(p));
    mamba_scan_fwd_emit_kernel<DS, TX, GATE><<<grid, FWD_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  static int bwd_summary(const ScanArgs& p, cudaStream_t st) {
    dim3 grid((p.DI + FWD_THREADS - 1) / FWD_THREADS, n_tiles(p));
    mamba_scan_bwd_summary_kernel<DS, TX, GATE><<<grid, FWD_THREADS, 0, st>>>(p);
    return (int)cudaGetLastError();
  }
  static int bwd_tile(const ScanArgs& p, cudaStream_t st) {
    const int smem = (int)sizeof(TileSmem<DS>);
    auto kern = mamba_scan_bwd_tile_kernel<DS, TX, GATE>;
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(n_groups(p), n_tiles(p));
    kern<<<grid, TILE_THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
};

enum Stage { FWD_SUMMARY, FWD_EMIT, BWD_SUMMARY, BWD_TILE };

template <int DS, typename TX, bool GATE>
int run_stage(Stage which, const ScanArgs& p, cudaStream_t st) {
  using L = Launch<DS, TX, GATE>;
  switch (which) {
    case FWD_SUMMARY: return L::fwd_summary(p, st);
    case FWD_EMIT: return L::fwd_emit(p, st);
    case BWD_SUMMARY: return L::bwd_summary(p, st);
    case BWD_TILE: return L::bwd_tile(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool valid(const ScanArgs* p) {
  return p && p->T > 0 && p->DI > 0 && (p->DS == 4 || p->DS == 16) &&
         (p->tx == 0 || p->tx == 1) && (p->gate == 0 || p->gate == 1) &&
         n_tiles(*p) <= 65535;
}

// Dispatch on (DS, the [T, *] inputs' type, gated or not).
int dispatch(Stage which, const ScanArgs* p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define MAMBA_CASE(ds, TX, cx, gt) \
  if (p->DS == ds && p->tx == cx && p->gate == gt) return run_stage<ds, TX, gt>(which, *p, st);
  MAMBA_CASE(4, float, 0, false)
  MAMBA_CASE(4, __nv_bfloat16, 1, false)
  MAMBA_CASE(16, float, 0, false)
  MAMBA_CASE(16, __nv_bfloat16, 1, false)
  MAMBA_CASE(4, float, 0, true)
  MAMBA_CASE(4, __nv_bfloat16, 1, true)
  MAMBA_CASE(16, float, 0, true)
  MAMBA_CASE(16, __nv_bfloat16, 1, true)
#undef MAMBA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Geometry the wrapper checks: the time tile (and checkpoint spacing), the
// channels of one dB/dC partial, and the size of the argument block.
int mamba_scan_tile() { return BT; }
int mamba_scan_group() { return GROUP; }
int mamba_scan_args_size() { return (int)sizeof(ScanArgs); }

// Each entry launches one kernel on `stream` and returns a cudaError_t code.
// D: summary, carry, emit.
int mamba_scan_fwd_summary(const ScanArgs* p, void* stream) {
  return dispatch(FWD_SUMMARY, p, stream);
}
int mamba_scan_fwd_carry(const ScanArgs* p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const int n = p->DI * p->DS;
  mamba_scan_fwd_carry_kernel<<<(n + CARRY_THREADS - 1) / CARRY_THREADS, CARRY_THREADS, 0,
                                (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}
int mamba_scan_fwd_emit(const ScanArgs* p, void* stream) { return dispatch(FWD_EMIT, p, stream); }
// D': summary, carry, per-tile pass, reduction.
int mamba_scan_bwd_summary(const ScanArgs* p, void* stream) {
  return dispatch(BWD_SUMMARY, p, stream);
}
int mamba_scan_bwd_carry(const ScanArgs* p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const int n = p->DI * p->DS;
  mamba_scan_bwd_carry_kernel<<<(n + CARRY_THREADS - 1) / CARRY_THREADS, CARRY_THREADS, 0,
                                (cudaStream_t)stream>>>(*p);
  return (int)cudaGetLastError();
}
int mamba_scan_bwd_tile(const ScanArgs* p, void* stream) { return dispatch(BWD_TILE, p, stream); }
int mamba_scan_reduce(const ScanArgs* p, void* stream) {
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  const int n = p->T * 2 * p->DS + p->DI * p->DS + (p->gate ? 2 * p->DI : 0);
  mamba_scan_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(*p,
                                                                                 n_groups(*p));
  return (int)cudaGetLastError();
}

}  // extern "C"

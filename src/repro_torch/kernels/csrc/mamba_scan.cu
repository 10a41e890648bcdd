// Mamba-1 selective scan for Hopper, sm_90a: forward (D) and its gradient
// (D').
//
// Replaces the Pallas TPU kernel of the JAX package's kernels/mamba_scan.py,
// mamba_scan_pallas (forward only; the JAX package differentiates its jnp
// scan instead):
//   a_t = exp(delta_t * A)   (0 where reset_t: the state restarts),
//   h_t = a_t * h_{t-1} + (delta_t * x_t) B_t,   h_{-1} = h0,
//   y_t = h_t . C_t,
// with delta, xs [T, DI], B, C [T, DS], A, h0 [DI, DS]; outputs y [T, DI]
// (before the D skip and the gating) and h_last [DI, DS], both float32. The
// [T, DI, DS] outer products are formed in registers and never stored. The
// caller pads T to a multiple of BT with state-neutral steps (delta = 0,
// reset = 0: a = 1, no input) and DS is 4 (the reduced test models) or 16
// (hymba-1.5b, falcon-mamba-7b). delta, B and C are float32; xs is float32
// or bf16 (the bf16 mixer's), upcast to float32; every sum is float32.
//
// Design. One thread owns one (channel, state) pair and walks all of time,
// holding its h in a register; a block holds CPB = 16 channels (16 * DS
// threads; the DS lanes of a channel are neighbours in one warp). Time runs
// in tiles of BT = 64 rows: the block stages a tile of delta, xs, B, C and
// reset in shared memory (the TPU kernel stages 256 rows in VMEM), so the
// 64 steps of the tile wait on no global load; y_t = sum_s h_t[s] C_t[s] is
// a shuffle over the channel's lanes, gathered in shared memory and written
// row-wise at the end of the tile. The forward writes the h entering each
// tile (ckpt [T / BT, DI, DS]) for the backward.
//
// * D' (mamba_scan_bwd_kernel) walks the tiles in reverse. Per tile it
//   recomputes the 64 states from the tile's checkpoint into registers
//   (the same arithmetic as the forward, so the same bits), then steps back
//   through them carrying dh. Per step: d delta_t and d x_t are sums over
//   the channel's DS lanes (a shuffle; one lane writes); dA is a sum over
//   time, kept in the owning thread's register; dB_t and dC_t are sums over
//   all channels: the kernel sums them over its warp's channels (shuffle)
//   and then over the block's warps in a fixed order (shared memory) and
//   writes one partial per channel block; mamba_scan_reduce_kernel sums
//   the partials over the blocks in block order. No atomics anywhere, so
//   D' is deterministic. On request it also writes the recomputed y (the
//   gating's gradient needs it; the mixer keeps no float32 y).
//
// Bound: bytes. The forward moves delta and xs in, y out ([T, DI] each;
// 0.52 GB at hymba-1.5b's DI = 3200 over a 16,384-row chunk in float32
// and bf16) against 8 float32 operations, one of them an exp, per (t,
// channel, state): 6.7 G operations. What holds it back is the chain of T
// dependent steps per thread, which this first version does not break (a
// time-parallel chunked scan is the way past it).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;     // time rows per tile (and per h checkpoint)
constexpr int CPB = 16;    // channels per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// One recurrence step; the forward and the backward's recompute share it so
// that both produce the same bits.
__device__ __forceinline__ float scan_step(float h, float d, float x, float b, float a_cs,
                                           int reset, float* a_out) {
  const float a = reset ? 0.f : expf(d * a_cs);
  *a_out = a;
  return fmaf(a, h, (d * x) * b);
}

template <int DS>
__device__ __forceinline__ float sum_lanes(float v) {  // over the channel's DS lanes
#pragma unroll
  for (int off = DS / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DS>
__device__ __forceinline__ float sum_channels(float v) {  // over the warp's channels
#pragma unroll
  for (int off = 16; off >= DS; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stages rows [t0, t0 + BT) of delta and xs (the block's CPB channels), B, C
// and reset in shared memory. Channels beyond DI read 0.
template <int DS, typename TX>
__device__ __forceinline__ void stage_tile(const float* delta, const TX* xs, const float* Bm,
                                           const float* Cm, const int* reset, int t0, int c0,
                                           int DI, float (*s_d)[CPB], float (*s_x)[CPB],
                                           float (*s_b)[DS], float (*s_c)[DS], int* s_r) {
  constexpr int NT = CPB * DS;
  const int tid = threadIdx.x;
  for (int i = tid; i < BT * CPB; i += NT) {
    const int r = i / CPB, cc = i % CPB, ch = c0 + cc;
    float dv = 0.f, xv = 0.f;
    if (ch < DI) {
      const size_t o = (size_t)(t0 + r) * DI + ch;
      dv = delta[o];
      xv = to_f(xs[o]);
    }
    s_d[r][cc] = dv;
    s_x[r][cc] = xv;
  }
  for (int i = tid; i < BT * DS; i += NT) {
    const int r = i / DS, s = i % DS;
    const size_t o = (size_t)(t0 + r) * DS + s;
    s_b[r][s] = Bm[o];
    s_c[r][s] = Cm[o];
  }
  for (int i = tid; i < BT; i += NT) s_r[i] = reset[t0 + i];
}

template <int DS, typename TX>
__global__ void __launch_bounds__(CPB * DS)
    mamba_scan_fwd_kernel(const float* __restrict__ delta, const TX* __restrict__ xs,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ A, const int* __restrict__ reset,
                          const float* __restrict__ h0, float* __restrict__ y,
                          float* __restrict__ h_last, float* __restrict__ ckpt, int T, int DI) {
  constexpr int NT = CPB * DS;
  __shared__ float s_d[BT][CPB];
  __shared__ float s_x[BT][CPB];
  __shared__ float s_y[BT][CPB];
  __shared__ float s_b[BT][DS];
  __shared__ float s_c[BT][DS];
  __shared__ int s_r[BT];
  const int tid = threadIdx.x;
  const int s = tid % DS, cl = tid / DS;
  const int c0 = blockIdx.x * CPB, c = c0 + cl;
  const bool own = c < DI;
  const float a_cs = own ? A[(size_t)c * DS + s] : 0.f;
  float h = own ? h0[(size_t)c * DS + s] : 0.f;
  const int n_tiles = T / BT;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * BT;
    if (own) ckpt[((size_t)tile * DI + c) * DS + s] = h;
    __syncthreads();  // the previous tile's s_y is written out
    stage_tile<DS>(delta, xs, Bm, Cm, reset, t0, c0, DI, s_d, s_x, s_b, s_c, s_r);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float a;
      h = scan_step(h, s_d[r][cl], s_x[r][cl], s_b[r][s], a_cs, s_r[r], &a);
      const float v = sum_lanes<DS>(h * s_c[r][s]);
      if (s == 0) s_y[r][cl] = v;
    }
    __syncthreads();
    for (int i = tid; i < BT * CPB; i += NT) {
      const int r = i / CPB, cc = i % CPB, ch = c0 + cc;
      if (ch < DI) y[(size_t)(t0 + r) * DI + ch] = s_y[r][cc];
    }
  }
  if (own) h_last[(size_t)c * DS + s] = h;
}

// Shared memory of the backward (dynamic: above 48 KB at DS = 16).
template <int DS>
struct BwdSmem {
  static constexpr int NW = CPB * DS / 32;  // warps per block
  float d[BT][CPB], x[BT][CPB], dy[BT][CPB];
  float dd[BT][CPB], dx[BT][CPB], yo[BT][CPB];
  float b[BT][DS], c[BT][DS];
  float pb[BT][NW][DS], pc[BT][NW][DS];  // per-warp partials of dB, dC
  int r[BT];
};

template <int DS, typename TX>
__global__ void __launch_bounds__(CPB * DS)
    mamba_scan_bwd_kernel(const float* __restrict__ delta, const TX* __restrict__ xs,
                          const float* __restrict__ Bm, const float* __restrict__ Cm,
                          const float* __restrict__ A, const int* __restrict__ reset,
                          const float* __restrict__ ckpt, const float* __restrict__ dy,
                          const float* __restrict__ dh_last, float* __restrict__ d_delta,
                          float* __restrict__ d_xs, float* __restrict__ y_out,
                          float* __restrict__ dA, float* __restrict__ dh0,
                          float* __restrict__ ws, int T, int DI) {
  constexpr int NT = CPB * DS;
  constexpr int NW = BwdSmem<DS>::NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DS>& sm = *reinterpret_cast<BwdSmem<DS>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = tid % DS, cl = tid / DS;
  const int c0 = blockIdx.x * CPB, c = c0 + cl;
  const bool own = c < DI;
  const float a_cs = own ? A[(size_t)c * DS + s] : 0.f;
  float dh = (own && dh_last != nullptr) ? dh_last[(size_t)c * DS + s] : 0.f;
  float da_sum = 0.f;
  const int n_tiles = T / BT;
  float* part = ws + (size_t)blockIdx.x * T * (2 * DS);
  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * BT;
    __syncthreads();  // the previous tile's outputs are written out
    stage_tile<DS>(delta, xs, Bm, Cm, reset, t0, c0, DI, sm.d, sm.x, sm.b, sm.c, sm.r);
    for (int i = tid; i < BT * CPB; i += NT) {
      const int r = i / CPB, cc = i % CPB, ch = c0 + cc;
      sm.dy[r][cc] = ch < DI ? dy[(size_t)(t0 + r) * DI + ch] : 0.f;
    }
    const float h_in = own ? ckpt[((size_t)tile * DI + c) * DS + s] : 0.f;
    __syncthreads();
    // recompute the tile's states h_t (registers)
    float hs[BT];
    {
      float h = h_in, a;
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        h = scan_step(h, sm.d[r][cl], sm.x[r][cl], sm.b[r][s], a_cs, sm.r[r], &a);
        hs[r] = h;
      }
    }
    // step back through the tile
#pragma unroll
    for (int r = BT - 1; r >= 0; --r) {
      const float d = sm.d[r][cl], x = sm.x[r][cl], b = sm.b[r][s], cv = sm.c[r][s];
      const float g = sm.dy[r][cl];
      const float h_t = hs[r];
      const float h_p = r > 0 ? hs[r - 1] : h_in;
      const int rs = sm.r[r];
      dh = fmaf(g, cv, dh);                      // dh_t: from y_t and from h_{t+1}
      const float a = rs ? 0.f : expf(d * a_cs);
      const float dadt = rs ? 0.f : dh * h_p * a;  // d(loss)/d(delta_t A) through a_t
      da_sum = fmaf(dadt, d, da_sum);
      const float dx_v = sum_lanes<DS>(dh * d * b);
      const float dd_v = sum_lanes<DS>(fmaf(dh * x, b, dadt * a_cs));
      float pb = sum_channels<DS>(dh * (d * x));
      float pc = sum_channels<DS>(g * h_t);
      if (y_out != nullptr) {
        const float yv = sum_lanes<DS>(h_t * cv);
        if (s == 0) sm.yo[r][cl] = yv;
      }
      if (s == 0) {
        sm.dx[r][cl] = dx_v;
        sm.dd[r][cl] = dd_v;
      }
      if (lane < DS) {
        sm.pb[r][warp][s] = pb;
        sm.pc[r][warp][s] = pc;
      }
      dh *= a;                                    // dh_{t-1}
    }
    __syncthreads();
    for (int i = tid; i < BT * CPB; i += NT) {
      const int r = i / CPB, cc = i % CPB, ch = c0 + cc;
      if (ch < DI) {
        const size_t o = (size_t)(t0 + r) * DI + ch;
        d_delta[o] = sm.dd[r][cc];
        d_xs[o] = sm.dx[r][cc];
        if (y_out != nullptr) y_out[o] = sm.yo[r][cc];
      }
    }
    for (int i = tid; i < BT * DS; i += NT) {
      const int r = i / DS, j = i % DS;
      float vb = 0.f, vc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        vb += sm.pb[r][w][j];
        vc += sm.pc[r][w][j];
      }
      part[(size_t)(t0 + r) * (2 * DS) + j] = vb;
      part[(size_t)(t0 + r) * (2 * DS) + DS + j] = vc;
    }
  }
  if (own) {
    dA[(size_t)c * DS + s] = da_sum;
    dh0[(size_t)c * DS + s] = dh;
  }
}

// dB [T, DS], dC [T, DS] = the channel blocks' partials summed in block
// order.
__global__ void mamba_scan_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dB,
                                         float* __restrict__ dC, int n_blocks, int T, int DS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // over T * 2 DS
  const int W = 2 * DS;
  if (i >= T * W) return;
  float v = 0.f;
  for (int k = 0; k < n_blocks; ++k) v += ws[(size_t)k * T * W + i];
  const int t = i / W, j = i % W;
  if (j < DS)
    dB[(size_t)t * DS + j] = v;
  else
    dC[(size_t)t * DS + (j - DS)] = v;
}

template <int DS, typename TX>
int launch_fwd(const void* delta, const void* xs, const void* B, const void* C,
               const void* A, const void* reset, const void* h0, void* y, void* h_last,
               void* ckpt, int T, int DI, cudaStream_t st) {
  const int grid = (DI + CPB - 1) / CPB;
  mamba_scan_fwd_kernel<DS, TX><<<grid, CPB * DS, 0, st>>>(
      (const float*)delta, (const TX*)xs, (const float*)B, (const float*)C, (const float*)A,
      (const int*)reset, (const float*)h0, (float*)y, (float*)h_last, (float*)ckpt, T, DI);
  return (int)cudaGetLastError();
}

template <int DS, typename TX>
int launch_bwd(const void* delta, const void* xs, const void* B, const void* C,
               const void* A, const void* reset, const void* ckpt, const void* dy,
               const void* dh_last, void* d_delta, void* d_xs, void* y_out, void* dA,
               void* dh0, void* ws, int T, int DI, cudaStream_t st) {
  const int grid = (DI + CPB - 1) / CPB;
  const int smem = (int)sizeof(BwdSmem<DS>);
  auto kern = mamba_scan_bwd_kernel<DS, TX>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, CPB * DS, smem, st>>>(
      (const float*)delta, (const TX*)xs, (const float*)B, (const float*)C, (const float*)A,
      (const int*)reset, (const float*)ckpt, (const float*)dy, (const float*)dh_last,
      (float*)d_delta, (float*)d_xs, (float*)y_out, (float*)dA, (float*)dh0, (float*)ws, T,
      DI);
  return (int)cudaGetLastError();
}

// Dispatch on (DS, xs type); dtype 0 = float32, 1 = bf16.
template <template <int, typename> class F, typename... Args>
int dispatch(int DS, int tx, Args... args) {
#define MAMBA_CASE(ds, TX, cx) \
  if (DS == ds && tx == cx) return F<ds, TX>::run(args...);
  MAMBA_CASE(4, float, 0)
  MAMBA_CASE(4, __nv_bfloat16, 1)
  MAMBA_CASE(16, float, 0)
  MAMBA_CASE(16, __nv_bfloat16, 1)
#undef MAMBA_CASE
  return (int)cudaErrorInvalidValue;
}

template <int DS, typename TX>
struct Fwd {
  template <typename... Args>
  static int run(Args... args) { return launch_fwd<DS, TX>(args...); }
};

template <int DS, typename TX>
struct Bwd {
  template <typename... Args>
  static int run(Args... args) { return launch_bwd<DS, TX>(args...); }
};

}  // namespace

extern "C" {

// The time tile the caller pads T to, and the channels of one block (the
// backward's workspace holds one [T, 2 DS] partial per block of channels).
int mamba_scan_tile() { return BT; }
int mamba_scan_channels_per_block() { return CPB; }

// D. delta [T, DI], B, C [T, DS] float32, xs [T, DI] (dtype tx) -> y [T, DI],
// h_last [DI, DS], ckpt [T / BT, DI, DS] (float32); A, h0 [DI, DS] float32,
// reset [T] int32.
// Returns a cudaError_t code.
int mamba_scan_fwd(const void* delta, const void* xs, const void* B, const void* C,
                   const void* A, const void* reset, const void* h0, void* y, void* h_last,
                   void* ckpt, int T, int DI, int DS, int tx, void* stream) {
  if (T <= 0 || T % BT || DI <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<Fwd>(DS, tx, delta, xs, B, C, A, reset, h0, y, h_last, ckpt, T, DI,
                       (cudaStream_t)stream);
}

// D'. The forward's inputs and ckpt, dy [T, DI] and dh_last [DI, DS] (may be
// null: zero) float32 -> d_delta, d_xs [T, DI], y_out [T, DI] (may be null),
// dA, dh0 [DI, DS], float32, and the dB/dC partials ws [ceil(DI / CPB), T,
// 2 DS] for mamba_scan_reduce. Returns a cudaError_t code.
int mamba_scan_bwd(const void* delta, const void* xs, const void* B, const void* C,
                   const void* A, const void* reset, const void* ckpt, const void* dy,
                   const void* dh_last, void* d_delta, void* d_xs, void* y_out, void* dA,
                   void* dh0, void* ws, int T, int DI, int DS, int tx, void* stream) {
  if (T <= 0 || T % BT || DI <= 0) return (int)cudaErrorInvalidValue;
  return dispatch<Bwd>(DS, tx, delta, xs, B, C, A, reset, ckpt, dy, dh_last, d_delta,
                       d_xs, y_out, dA, dh0, ws, T, DI, (cudaStream_t)stream);
}

// dB, dC [T, DS] float32 from the partials of mamba_scan_bwd.
int mamba_scan_reduce(const void* ws, void* dB, void* dC, int n_blocks, int T, int DS,
                      void* stream) {
  if (T <= 0 || n_blocks <= 0 || DS <= 0) return (int)cudaErrorInvalidValue;
  const int n = T * 2 * DS, nt = 256;
  mamba_scan_reduce_kernel<<<(n + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>(
      (const float*)ws, (float*)dB, (float*)dC, n_blocks, T, DS);
  return (int)cudaGetLastError();
}

}  // extern "C"

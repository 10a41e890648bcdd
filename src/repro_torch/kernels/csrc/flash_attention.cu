// Packed-varlen causal flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel kernels/flash_attention.py::
// flash_attention_pallas (body ``_kernel``) of the JAX package. Same
// function: q [T,Hq,D], k [S,Hkv,D], v [S,Hkv,D] token-major, int32
// seg/pos per row; query head h reads kv head h / (Hq/Hkv);
//   attend(i, j) iff seg_q[i] == seg_kv[j] && seg_q[i] >= 0
//                 && (!causal || pos_kv[j] <= pos_q[i])
//                 && (window <= 0 || pos_q[i] - pos_kv[j] < window)
// online softmax in float32; a row with no attended key is written as 0.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential grid
// axis over KV tiles; blocks on the card run in no order, so here a block
// owns one (query tile of BQ rows, query head, KV split) triple and loops
// over its share of the KV tiles itself, with the running state in
// registers and shared memory:
//
// * Tile skipping. Before loading a KV tile the block tests every key row
//   of it against every query row of its tile (segment, causal, window)
//   and skips tiles with no live pair. The serving engine's packed KV
//   buffer is mostly other requests' context rows, and local layers see a
//   512-row window of contexts up to 4k, so most tiles are skipped.
// * Split KV. Decode tokens (one per request) share query tiles and each
//   attends its whole context, so one block per query tile would walk
//   thousands of tiles in series. The KV tiles are dealt round-robin to
//   ``n_split`` blocks per query tile; each writes its partial
//   (m, l, unnormalised acc) to a float32 workspace and a second kernel,
//   launched through its own entry point, merges them (flash-decoding).
//   ``n_split == 1`` writes the output directly.
//
// Bound. At the serving shapes (gemma3-1b: Hq=4, Hkv=1, D=256) the work
// per byte is high (a K/V row meets up to 512 queries x 4 heads), and the
// roofline bound of a mixed engine step is a few hundredths of a ms. This
// version does its products with plain float32 FMAs from shared memory
// (register-blocked 4x2 score and 4x(D/16) output tiles per thread), which
// keeps it well above that bound; mma/wgmma tiles are the next step.
// Inputs are converted to float32 once, when a tile lands in shared
// memory, with 16-byte global loads issued in batches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 32;        // KV rows per tile
constexpr int NT = 128;       // threads: 8 row groups (ty) x 16 columns (tx)
constexpr int MAX_SPLIT = 16;
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> float32 values into dst[0 .. 16/sizeof(T))
__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* dst, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);            // low half first
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copy ``rows`` rows of D elements (row r at src + r * stride elements)
// into shared memory as float32 with row stride LD. Lane-consecutive
// threads take consecutive rows, so the shared-memory stores (odd LD)
// hit distinct banks; each thread keeps up to 8 16-byte loads in flight.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, size_t stride,
                                          int rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = D / VEC;                 // 16-byte chunks per row
  const int total = rows * CH;
  for (int base = 0; base < total; base += 8 * NT) {
    uint4 buf[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = base + i * NT + tid;
      if (c < total) {
        const int r = c % rows, ch = c / rows;
        buf[i] = __ldg(reinterpret_cast<const uint4*>(src + r * stride + ch * VEC));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = base + i * NT + tid;
      if (c < total) {
        const int r = c % rows, ch = c / rows;
        float f[VEC];
        unpack(buf[i], f, T());
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[r * LD + ch * VEC + e] = f[e];
      }
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sK, sV: [BQ|BK][D + 1] floats; sP: [BQ][BK + 1] floats
  return sizeof(float) * (size_t)(3 * BQ * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg_q,
                 const int* __restrict__ pos_q, const int* __restrict__ seg_kv,
                 const int* __restrict__ pos_kv, T* __restrict__ out,
                 float2* __restrict__ ws_ml, float* __restrict__ ws_acc,
                 int T_, int S, int Hq, int Hkv, int causal, int window,
                 float scale, int n_split) {
  static_assert(BQ == 32 && BK == 32 && NT == 128, "thread map assumes 32x32 tiles");
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + 1;         // odd row stride: conflict-free column reads
  constexpr int LP = BK + 1;
  constexpr int DJ = D / 16;        // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  __shared__ int s_segq[BQ], s_posq[BQ], s_segk[BK], s_posk[BK];
  __shared__ float s_m[BQ], s_l[BQ], s_alpha[BQ];
  __shared__ int s_rng[2];          // live query rows: segment min / max

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.y, z = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const size_t q0 = (size_t)blockIdx.x * BQ;
  const size_t kv_stride = (size_t)Hkv * D;

  load_tile<T, D, LD>(sQ, q + (q0 * Hq + h) * D, (size_t)Hq * D, BQ, tid);
  if (tid < BQ) {
    const int sg = seg_q[q0 + tid];
    s_segq[tid] = sg;
    s_posq[tid] = pos_q[q0 + tid];
    s_m[tid] = NEG;
    s_l[tid] = 0.f;
    // warp 0 reduces the live rows' segment range (BQ == warp size)
    int smin = sg >= 0 ? sg : INT_MAX, smax = sg >= 0 ? sg : INT_MIN;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    }
    if (tid == 0) { s_rng[0] = smin; s_rng[1] = smax; }
  }
  __syncthreads();
  const int qsmin = s_rng[0], qsmax = s_rng[1];

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int n_kv = S / BK;
  if (qsmax >= 0 && z < n_kv) {     // else: no live query row / no tiles
    // this tile's key metadata is prefetched one iteration ahead
    int nsg = 0, nps = 0;
    if (tid < BK) { nsg = seg_kv[z * BK + tid]; nps = pos_kv[z * BK + tid]; }
    for (int kt = z; kt < n_kv; kt += n_split) {
      const int sg = nsg, ps = nps;
      if (tid < BK && kt + n_split < n_kv) {
        nsg = seg_kv[(kt + n_split) * BK + tid];
        nps = pos_kv[(kt + n_split) * BK + tid];
      }
      int live = 0;
      if (tid < BK) {
        s_segk[tid] = sg;
        s_posk[tid] = ps;
        if (sg >= qsmin && sg <= qsmax) {
          for (int r = 0; r < BQ && !live; ++r) {
            const int pq = s_posq[r];
            live = s_segq[r] == sg && (!causal || ps <= pq) &&
                   (window <= 0 || pq - ps < window);
          }
        }
      }
      if (!__syncthreads_or(live)) continue;   // no live pair: skip the tile

      const size_t k0 = (size_t)kt * BK;
      load_tile<T, D, LD>(sK, k + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      load_tile<T, D, LD>(sV, v + k0 * kv_stride + (size_t)hk * D, kv_stride, BK, tid);
      __syncthreads();

      // scores: rows ty + 8i, columns tx + 16j
      float sc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 8 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 8 * i;
        const int sq = s_segq[r], pq = s_posq[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = tx + 16 * j;
          const bool ok = sq >= 0 && s_segk[c] == sq &&
                          (!causal || s_posk[c] <= pq) &&
                          (window <= 0 || pq - s_posk[c] < window);
          sP[r * LP + c] = ok ? sc[i][j] * scale : -INFINITY;
        }
      }
      __syncthreads();

      // online softmax, one thread per query row
      if (tid < BQ) {
        float* row = sP + tid * LP;
        float mx = -INFINITY;
        for (int c = 0; c < BK; ++c) mx = fmaxf(mx, row[c]);
        const float m_prev = s_m[tid];
        const float m_new = fmaxf(m_prev, mx);
        const float alpha = expf(m_prev - m_new);
        float lsum = 0.f;
        for (int c = 0; c < BK; ++c) {
          const float s = row[c];
          const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
          row[c] = p;
          lsum += p;
        }
        s_l[tid] = s_l[tid] * alpha + lsum;
        s_m[tid] = m_new;
        s_alpha[tid] = alpha;
      }
      __syncthreads();

      // acc = acc * alpha + P @ V; rows ty + 8i, columns tx + 16j
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s_alpha[ty + 8 * i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
      }
      for (int c = 0; c < BK; ++c) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 8 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
      __syncthreads();              // sK/sV/sP/s_segk are rewritten next tile
    }
  }

  const size_t TH = (size_t)T_ * Hq;
  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      const float l = s_l[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float o = l > 0.f ? acc[i][j] / l : 0.f;
        out[((q0 + r) * Hq + h) * D + tx + 16 * j] = from_f<T>(o);
      }
    }
    return;
  }
  // partial state of split z; acc only where the row met a live key
  if (tid < BQ)
    ws_ml[z * TH + (q0 + tid) * Hq + h] = make_float2(s_m[tid], s_l[tid]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 8 * i;
    if (s_l[r] > 0.f) {
      float* dst = ws_acc + (z * TH + (q0 + r) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j];
    }
  }
}

// Merge the n_split partial states of each (row, head): one block per pair.
template <typename T, int D>
__global__ void flash_combine_kernel(const float2* __restrict__ ws_ml,
                                     const float* __restrict__ ws_acc,
                                     T* __restrict__ out, int TH, int n_split) {
  const size_t row = blockIdx.x;
  float w[MAX_SPLIT];
  float M = NEG, L = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float2 ml = ws_ml[z * (size_t)TH + row];
    if (ml.y > 0.f) M = fmaxf(M, ml.x);
  }
#pragma unroll
  for (int z = 0; z < MAX_SPLIT; ++z) {
    w[z] = 0.f;
    if (z < n_split) {
      const float2 ml = ws_ml[z * (size_t)TH + row];
      if (ml.y > 0.f) {
        w[z] = expf(ml.x - M);
        L += ml.y * w[z];
      }
    }
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int z = 0; z < MAX_SPLIT; ++z)
      if (w[z] > 0.f) a += ws_acc[(z * (size_t)TH + row) * D + d] * w[z];
    out[row * D + d] = from_f<T>(L > 0.f ? a / L : 0.f);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg_q,
               const void* pos_q, const void* seg_kv, const void* pos_kv, void* out,
               void* ws_ml, void* ws_acc, int T_, int S, int Hq, int Hkv, int causal,
               int window, float scale, int n_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(T_ / BQ, Hq, n_split);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q, (const int*)pos_q,
      (const int*)seg_kv, (const int*)pos_kv, (T*)out, (float2*)ws_ml,
      (float*)ws_acc, T_, S, Hq, Hkv, causal, window, scale, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_combine(const void* ws_ml, const void* ws_acc, void* out, int T_, int Hq,
                   int n_split, cudaStream_t stream) {
  flash_combine_kernel<T, D><<<T_ * Hq, 64, 0, stream>>>(
      (const float2*)ws_ml, (const float*)ws_acc, (T*)out, T_ * Hq, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tile sizes the caller must pad T and S to (seg = -2 on pad rows),
// and the largest KV split.
int flash_attention_block_q() { return BQ; }
int flash_attention_block_kv() { return BK; }
int flash_attention_max_split() { return MAX_SPLIT; }

// The split pass. dtype: 0 = float32, 1 = bfloat16. With n_split == 1 it
// writes ``out``; with n_split > 1 it writes only the partial states: ws_ml
// must hold n_split * T * Hq float2 (m, l) and ws_acc n_split * T * Hq * D
// floats (uninitialised is fine; acc is written only where l > 0), and
// flash_attention_combine merges them into ``out``. Returns a cudaError_t
// code (0 = ok); cudaErrorInvalidValue for a shape or dtype this library
// does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* seg_q, const void* pos_q, const void* seg_kv,
                        const void* pos_kv, void* out, void* ws_ml, void* ws_acc,
                        int T, int S, int Hq, int Hkv, int D, int dtype,
                        int causal, int window, float scale, int n_split,
                        void* stream) {
  if (T <= 0 || S <= 0 || T % BQ || S % BK || Hkv <= 0 || Hq % Hkv ||
      n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && (ws_ml == nullptr || ws_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_CASE(TYPE, DIM)                                                          \
  return launch_fwd<TYPE, DIM>(q, k, v, seg_q, pos_q, seg_kv, pos_kv, out, ws_ml,    \
                               ws_acc, T, S, Hq, Hkv, causal, window, scale, n_split, \
                               st)
  if (dtype == 0) {
    if (D == 64) FA_CASE(float, 64);
    if (D == 128) FA_CASE(float, 128);
    if (D == 256) FA_CASE(float, 256);
  } else if (dtype == 1) {
    if (D == 64) FA_CASE(__nv_bfloat16, 64);
    if (D == 128) FA_CASE(__nv_bfloat16, 128);
    if (D == 256) FA_CASE(__nv_bfloat16, 256);
  }
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// The merge pass: out [T, Hq, D] (dtype as above) from the n_split partial
// states that flash_attention_fwd wrote. Returns a cudaError_t code.
int flash_attention_combine(const void* ws_ml, const void* ws_acc, void* out, int T,
                            int Hq, int D, int dtype, int n_split, void* stream) {
  if (T <= 0 || Hq <= 0 || n_split < 2 || n_split > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FC_CASE(TYPE, DIM) \
  return launch_combine<TYPE, DIM>(ws_ml, ws_acc, out, T, Hq, n_split, st)
  if (dtype == 0) {
    if (D == 64) FC_CASE(float, 64);
    if (D == 128) FC_CASE(float, 128);
    if (D == 256) FC_CASE(float, 256);
  } else if (dtype == 1) {
    if (D == 64) FC_CASE(__nv_bfloat16, 64);
    if (D == 128) FC_CASE(__nv_bfloat16, 128);
    if (D == 256) FC_CASE(__nv_bfloat16, 256);
  }
#undef FC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Vocab-tiled decode readout with top-k and logsumexp, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::topk_lse_readout_pallas
// (_topk_readout_kernel + _topk_lse_update), the readout of every decode
// step through ops/decode.py::LinearReadout.
//
// Computes, per row n of states [N, D] against w [D, V] and bias b [V]:
//     l      = states[n] @ w + b                  (never written to memory)
//     lse[n] = logsumexp(max(l, -FLT_MAX))        (finite-min clamp: an
//              all -inf vocab tile cannot poison the statistics with nan)
//     vals[n], idx[n] = the k largest l, ties to the LOWEST vocab id
//              (lax.top_k order); a real -inf logit stays selectable by id
// Operands are in the compute type (float or bfloat16), products accumulate
// in float32.  k <= 16.
//
// What bounds it on this card: at the serving shape (N = 64 slots x 3 beams
// = 192, D = 512, V = 30000) one call reads w once, 30.7 MB in bf16, and
// does 5.9 GFLOP: 9.2 us of memory time against 6.0 us of tensor-core time,
// so the call is memory-bound and the logits (23 MB in f32) must never
// reach device memory.
//
// Design: the TPU kernel carries a running top-k and a running logsumexp
// in VMEM scratch across a sequential grid over vocab tiles; Hopper's
// blocks run in no order, so the state is split into two passes.
//   pass 1 (topk_lse_tile_kernel): blocks over (row tile, vocab tile) in
//     parallel.  Each computes its [32 x 128] logits tile with a
//     shared-memory tiled product (fixed k order), adds the bias, and
//     reduces each row in one warp to the tile's max, sum-exp and top-k.
//     The ragged last vocab tile is masked here: w is never padded.
//     Blocks of one vocab tile are adjacent in launch order (row tile is
//     blockIdx.x), so the row tiles re-read that w tile from L2.
//   pass 2 (topk_lse_merge_kernel): one warp per row merges the per-tile
//     lists (k picks in the same total order) and the per-tile (max, sum).
// Tile shapes are fixed, never chosen from N, and no sum is split across
// blocks by row count: a row's result does not depend on N, so a slot
// table's rows match a solo decode bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int RB = 32;        // rows per block (pass 1)
constexpr int VT = 128;       // vocab columns per block (pass 1)
constexpr int BKD = 32;       // depth of one shared-memory stage
constexpr int THREADS = 256;  // 8 warps
constexpr int MAXK = 16;
constexpr int SENTINEL = 1 << 30;  // "no candidate" id, above any vocab id

template <typename CT>
__device__ __forceinline__ float to_f(CT x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the total order of the top-k: larger value first, then lower id; a
// sentinel id is no candidate and loses to every real one
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  if (ai == SENTINEL) return false;
  if (bi == SENTINEL) return true;
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// pass 1.  grid (ceil(N / RB), nV).  Partials: pv/pi [N, nV, k],
// pm/ps [N, nV].
template <typename CT>
__global__ void __launch_bounds__(THREADS) topk_lse_tile_kernel(
    const CT* __restrict__ states, const CT* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ pv,
    int* __restrict__ pi, float* __restrict__ pm, float* __restrict__ ps,
    int N, int D, int V, int k, int nV) {
  __shared__ float As[RB][BKD + 1];
  __shared__ float Ws[BKD][VT];
  __shared__ float L[RB][VT + 1];
  const int row0 = blockIdx.x * RB, vt = blockIdx.y, col0 = vt * VT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // --- the [RB, VT] logits tile: thread (warp, lane) owns rows
  // warp*4 .. warp*4+3 and columns lane + 32 j ---
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += BKD) {
    for (int e = threadIdx.x; e < RB * BKD; e += THREADS) {
      const int r = e / BKD, c = e % BKD;
      const int gr = row0 + r, gd = d0 + c;
      As[r][c] = (gr < N && gd < D) ? to_f<CT>(states[(size_t)gr * D + gd])
                                    : 0.0f;
    }
    for (int e = threadIdx.x; e < BKD * VT; e += THREADS) {
      const int r = e / VT, c = e % VT;
      const int gd = d0 + r, gv = col0 + c;
      Ws[r][c] = (gd < D && gv < V) ? to_f<CT>(w[(size_t)gd * V + gv])
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKD; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[warp * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gv = col0 + lane + 32 * j;
      L[warp * 4 + i][lane + 32 * j] = acc[i][j] + (gv < V ? bias[gv] : 0.0f);
    }
  __syncthreads();

  // --- per-row tile statistics: warp `warp` reduces rows warp*4 .. +3 ---
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, gr = row0 + r;
    if (gr >= N) break;  // warp-uniform
    float v[4];
    int id[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gv = col0 + lane + 32 * j;
      v[j] = L[r][lane + 32 * j];
      id[j] = gv < V ? gv : SENTINEL;  // ragged tail: no candidate
    }
    float mx = -FLT_MAX;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (id[j] != SENTINEL) mx = fmaxf(mx, fmaxf(v[j], -FLT_MAX));
    mx = warp_max(mx);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (id[j] != SENTINEL) s += expf(fmaxf(v[j], -FLT_MAX) - mx);
    s = warp_sum(s);
    const size_t base = (size_t)gr * nV + vt;
    if (lane == 0) {
      pm[base] = mx;
      ps[base] = s;
    }
    for (int q = 0; q < k; ++q) {
      float bv = -CUDART_INF_F;
      int bi = SENTINEL;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (better(v[j], id[j], bv, bi)) {
          bv = v[j];
          bi = id[j];
        }
      warp_best(bv, bi);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (id[j] == bi) id[j] = SENTINEL;  // ids are unique: remove winner
      if (lane == 0) {
        pv[base * k + q] = bv;
        pi[base * k + q] = bi;
      }
    }
  }
}

// pass 2.  One warp per row; grid ceil(N / 8).
__global__ void __launch_bounds__(THREADS) topk_lse_merge_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ pm, const float* __restrict__ ps,
    float* __restrict__ out_v, int64_t* __restrict__ out_i,
    float* __restrict__ out_lse, int N, int nV, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= N) return;  // warp-uniform
  const float* rm = pm + (size_t)row * nV;
  const float* rs = ps + (size_t)row * nV;
  float mx = -FLT_MAX;
  for (int t = lane; t < nV; t += 32) mx = fmaxf(mx, rm[t]);
  mx = warp_max(mx);
  float s = 0.0f;
  for (int t = lane; t < nV; t += 32) s += rs[t] * expf(rm[t] - mx);
  s = warp_sum(s);
  if (lane == 0) out_lse[row] = mx + logf(s);

  // pick q takes the best candidate strictly after pick q-1 in the order
  const int C = nV * k;
  const float* cv = pv + (size_t)row * C;
  const int* ci = pi + (size_t)row * C;
  float prev_v = 0.0f;
  int prev_i = -1;
  for (int q = 0; q < k; ++q) {
    float bv = -CUDART_INF_F;
    int bi = SENTINEL;
    for (int c = lane; c < C; c += 32) {
      const float v = cv[c];
      const int i = ci[c];
      if (i == SENTINEL) continue;
      if (q > 0 && !better(prev_v, prev_i, v, i)) continue;
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      out_v[(size_t)row * k + q] = bv;
      out_i[(size_t)row * k + q] = bi;
    }
    prev_v = bv;
    prev_i = bi;
  }
}

template <typename CT>
int topk_lse_impl(const CT* states, const CT* w, const float* bias,
                  float* pv, int* pi, float* pm, float* ps, float* out_v,
                  int64_t* out_i, float* out_lse, int N, int D, int V, int k,
                  cudaStream_t stream) {
  if (k < 1 || k > MAXK || V < k || N < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int nV = (V + VT - 1) / VT;
  topk_lse_tile_kernel<CT><<<dim3((N + RB - 1) / RB, nV), THREADS, 0,
                             stream>>>(states, w, bias, pv, pi, pm, ps, N, D,
                                       V, k, nV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = THREADS / 32;
  topk_lse_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block, THREADS,
                          0, stream>>>(pv, pi, pm, ps, out_v, out_i, out_lse,
                                       N, nV, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Number of vocab tiles of pass 1 (sizes the partials the caller allocates).
extern "C" int topk_lse_num_tiles(int V) { return (V + VT - 1) / VT; }

// states [N, D], w [D, V] (both the compute type), bias [V] f32;
// partials pv [N, nV, k] f32, pi [N, nV, k] i32, pm / ps [N, nV] f32;
// outputs vals [N, k] f32, idx [N, k] i64, lse [N] f32.
#define TOPK_LSE_ENTRY(NAME, CT)                                            \
  extern "C" int NAME(const void* states, const void* w, const void* bias,  \
                      void* pv, void* pi, void* pm, void* ps, void* out_v,  \
                      void* out_i, void* out_lse, int N, int D, int V,      \
                      int k, void* stream) {                                \
    return topk_lse_impl<CT>((const CT*)states, (const CT*)w,               \
                             (const float*)bias, (float*)pv, (int*)pi,      \
                             (float*)pm, (float*)ps, (float*)out_v,         \
                             (int64_t*)out_i, (float*)out_lse, N, D, V, k,  \
                             (cudaStream_t)stream);                         \
  }

TOPK_LSE_ENTRY(topk_lse_readout_f32, float)
TOPK_LSE_ENTRY(topk_lse_readout_bf16, __nv_bfloat16)

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

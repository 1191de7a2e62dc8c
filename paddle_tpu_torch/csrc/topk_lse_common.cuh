// Shared by the two top-k + logsumexp kernels: topk_lse_readout.cu (K7,
// logits built from states @ w + b inside the kernel) and
// topk_lse_logits.cu (K8, logits read from memory).
//
// The order is larger value first, then lower vocab id (lax.top_k's); the
// logsumexp runs over finite-min-clamped values, so an all -inf stretch
// contributes exp(-FLT_MAX - m) == 0 and never a nan.  Sums are taken in a
// fixed order that depends on the vocabulary only, never on the number of
// rows.
//
// - better / warp_best / consider_after: the total order, a warp's best
//   candidate, and a candidate taken only strictly after the previous
//   pick (selection rounds over lists: K7's merge pass, K8's block and
//   cluster merges);
// - fold_stats: two (max, sum-exp) pairs folded into one, with the same
//   bits whichever side is which (K7's epilogue, K8's merges);
// - row_tile_stats and topk_lse_merge_kernel (launch_merge): K7's two
//   passes.  Pass 1 reduces one row's slice of one vocab tile in one warp
//   (row_tile_stats) to the tile's max, sum-exp and top-k; pass 2 merges
//   the per-tile lists and statistics of each row in one warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>

namespace topk_lse {

constexpr int MAXK = 16;
constexpr int SENTINEL = 1 << 30;  // "no candidate" id, above any vocab id
constexpr int MERGE_THREADS = 256;  // 8 rows per merge block

template <typename T>
__device__ __forceinline__ float to_f(T x);
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

// (bv, bi) <- (v, i) if i is a candidate, lies strictly after the previous
// pick (pv, pi) in the order (any candidate when pi < 0) and beats (bv, bi)
__device__ __forceinline__ void consider_after(float v, int i, float pv,
                                               int pi, float& bv, int& bi) {
  if (i == SENTINEL) return;
  if (pi >= 0 && !better(pv, pi, v, i)) return;
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// (m, s) <- the (max, sum-exp) of the union of (m, s) and (om, os).  The
// products are rounded before the sum (no FMA contraction), so both sides
// of a pair compute the same bits whichever of them is (m, s).
__device__ __forceinline__ void fold_stats(float& m, float& s, float om,
                                           float os) {
  const float nm = fmaxf(m, om);
  s = __fadd_rn(__fmul_rn(s, expf(m - nm)), __fmul_rn(os, expf(om - nm)));
  m = nm;
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

// Pass 1's per-row reduction, called by all 32 lanes of one warp: lane
// `lane` holds J values v[j] of one row's vocab tile with their ids id[j]
// (SENTINEL for the ragged tail, whose value is never read).  Writes the
// tile's max and sum-exp to pm/ps[base] and its top-k to pv/pi[base*k ...].
// id[] is consumed (winners are removed by id).
template <int J>
__device__ __forceinline__ void row_tile_stats(const float (&v)[J],
                                               int (&id)[J], int k,
                                               size_t base, int lane,
                                               float* pm, float* ps,
                                               float* pv, int* pi) {
  float mx = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (id[j] != SENTINEL) mx = fmaxf(mx, fmaxf(v[j], -FLT_MAX));
  mx = warp_max(mx);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (id[j] != SENTINEL) s += expf(fmaxf(v[j], -FLT_MAX) - mx);
  s = warp_sum(s);
  if (lane == 0) {
    pm[base] = mx;
    ps[base] = s;
  }
  for (int q = 0; q < k; ++q) {
    float bv = -CUDART_INF_F;
    int bi = SENTINEL;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (better(v[j], id[j], bv, bi)) {
        bv = v[j];
        bi = id[j];
      }
    warp_best(bv, bi);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (id[j] == bi) id[j] = SENTINEL;  // ids are unique: remove winner
    if (lane == 0) {
      pv[base * k + q] = bv;
      pi[base * k + q] = bi;
    }
  }
}

// Pass 2.  One warp per row; grid ceil(N / 8) blocks of MERGE_THREADS.
// Partials pv/pi [N, nV, k], pm/ps [N, nV]; outputs vals [N, k] f32,
// idx [N, k] i64, lse [N] f32.
__global__ void __launch_bounds__(MERGE_THREADS) topk_lse_merge_kernel(
    const float* __restrict__ pv, const int* __restrict__ pi,
    const float* __restrict__ pm, const float* __restrict__ ps,
    float* __restrict__ out_v, int64_t* __restrict__ out_i,
    float* __restrict__ out_lse, int N, int nV, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (MERGE_THREADS / 32) + threadIdx.x / 32;
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
    for (int c = lane; c < C; c += 32)
      consider_after(cv[c], ci[c], prev_v, prev_i, bv, bi);
    warp_best(bv, bi);
    if (lane == 0) {
      out_v[(size_t)row * k + q] = bv;
      out_i[(size_t)row * k + q] = bi;
    }
    prev_v = bv;
    prev_i = bi;
  }
}

inline int launch_merge(const float* pv, const int* pi, const float* pm,
                        const float* ps, float* out_v, int64_t* out_i,
                        float* out_lse, int N, int nV, int k,
                        cudaStream_t stream) {
  const int rows_per_block = MERGE_THREADS / 32;
  topk_lse_merge_kernel<<<(N + rows_per_block - 1) / rows_per_block,
                          MERGE_THREADS, 0, stream>>>(
      pv, pi, pm, ps, out_v, out_i, out_lse, N, nV, k);
  return (int)cudaGetLastError();
}

}  // namespace topk_lse

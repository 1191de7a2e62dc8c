// Top-k and logsumexp over pre-built logits, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::topk_lse_logits_pallas
// (_topk_logits_kernel + _topk_lse_update), the readout of every decode
// step through ops/decode.py::LogitsReadout: generation through the nn
// DSL's beam_search layer, whose step net ends in a vocab-size logits
// layer the engine cannot tile.
//
// Computes, per row n of logits [N, V] (float or bfloat16):
//     lse[n] = logsumexp(max(l, -FLT_MAX))        (finite-min clamp: a row
//              that is all -inf gives about -FLT_MAX, never nan)
//     vals[n], idx[n] = the k largest l, ties to the LOWEST vocab id
//              (lax.top_k order); a real -inf logit stays selectable by id
// in float32.  k <= 16.
//
// What bounds it on this card: it reads each logit once and does a few
// operations per logit.  At the generation shape (N = 64 sources x 3 beams
// = 192, V = 30000, f32) that is 23.0 MB, 6.9 us at 3.35 TB/s; the
// operations (a max, an exp and a sum per logit, k compares) are far
// below that on the CUDA cores.  So the design aims at one coalesced read
// of the logits and nothing else of size N x V.
//
// Design: K7's two passes without the product (the per-row reduction and
// pass 2 are shared with K7 in topk_lse_common.cuh).
//   pass 1 (topk_logits_tile_kernel): one warp per (row, vocab tile of 512
//     columns); lane l reads columns l + 32 j (j < 16), so every load of the
//     warp is one contiguous 128-byte (f32) or 64-byte (bf16) segment, and a
//     lane has 16 independent loads in flight.  The warp reduces its tile to
//     max, sum-exp and top-k.  The ragged last tile is masked here: the
//     logits are never padded or copied.
//   pass 2 (topk_lse_merge_kernel): one warp per row merges the per-tile
//     lists and statistics.
// Tile shapes are fixed and every row is reduced by its own warps, so a
// row's result does not depend on N.

#include "topk_lse_common.cuh"

namespace {

using topk_lse::MAXK;
using topk_lse::SENTINEL;
using topk_lse::to_f;

constexpr int J = 16;            // logits per lane of one tile
constexpr int VT = 32 * J;       // vocab columns per tile (pass 1)
constexpr int WARPS = 8;         // rows per block (pass 1)
constexpr int THREADS = 32 * WARPS;

// pass 1.  grid (ceil(N / WARPS), nV).  Partials: pv/pi [N, nV, k],
// pm/ps [N, nV].
template <typename LT>
__global__ void __launch_bounds__(THREADS) topk_logits_tile_kernel(
    const LT* __restrict__ logits, float* __restrict__ pv,
    int* __restrict__ pi, float* __restrict__ pm, float* __restrict__ ps,
    int N, int V, int k, int nV) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;  // warp-uniform
  const int vt = blockIdx.y, col0 = vt * VT;
  const LT* lr = logits + (size_t)row * V;
  float v[J];
  int id[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int gv = col0 + lane + 32 * j;
    if (gv < V) {
      v[j] = to_f<LT>(lr[gv]);
      id[j] = gv;
    } else {  // ragged tail: no candidate, never read
      v[j] = -CUDART_INF_F;
      id[j] = SENTINEL;
    }
  }
  topk_lse::row_tile_stats<J>(v, id, k, (size_t)row * nV + vt, lane, pm, ps,
                              pv, pi);
}

template <typename LT>
int topk_logits_impl(const LT* logits, float* pv, int* pi, float* pm,
                     float* ps, float* out_v, int64_t* out_i, float* out_lse,
                     int N, int V, int k, cudaStream_t stream) {
  if (k < 1 || k > MAXK || V < k || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int nV = (V + VT - 1) / VT;
  topk_logits_tile_kernel<LT><<<dim3((N + WARPS - 1) / WARPS, nV), THREADS,
                                0, stream>>>(logits, pv, pi, pm, ps, N, V, k,
                                             nV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return topk_lse::launch_merge(pv, pi, pm, ps, out_v, out_i, out_lse, N,
                                nV, k, stream);
}

}  // namespace

// Number of vocab tiles of pass 1 (sizes the partials the caller allocates).
extern "C" int topk_logits_num_tiles(int V) { return (V + VT - 1) / VT; }

// logits [N, V] (f32 or bf16, rows contiguous); partials pv [N, nV, k] f32,
// pi [N, nV, k] i32, pm / ps [N, nV] f32; outputs vals [N, k] f32,
// idx [N, k] i64, lse [N] f32.
#define TOPK_LOGITS_ENTRY(NAME, LT)                                         \
  extern "C" int NAME(const void* logits, void* pv, void* pi, void* pm,     \
                      void* ps, void* out_v, void* out_i, void* out_lse,    \
                      int N, int V, int k, void* stream) {                  \
    return topk_logits_impl<LT>((const LT*)logits, (float*)pv, (int*)pi,    \
                                (float*)pm, (float*)ps, (float*)out_v,      \
                                (int64_t*)out_i, (float*)out_lse, N, V, k,  \
                                (cudaStream_t)stream);                      \
  }

TOPK_LOGITS_ENTRY(topk_lse_logits_f32, float)
TOPK_LOGITS_ENTRY(topk_lse_logits_bf16, __nv_bfloat16)

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

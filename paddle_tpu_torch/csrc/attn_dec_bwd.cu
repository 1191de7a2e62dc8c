// Attention GRU decoder, reverse time loop, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::attn_dec_bwd_pallas (the
// _attn_dec_bwd_kernel body), which the flagship's training decoder reaches
// through ops/attention_decoder.py::_agd_bwd (its Pallas branch).
//
// Computes, for t = T-1 .. 0 over a time-major batch, from the forward's
// saved carry s_prev[t], the gates r, u, cand and the query q recomputed
// outside (all float32), and the carry cotangent d_s (zero at t = T-1):
//     m      = mask[t] > 0 ? 1 : 0
//     d_snew = m * (d_out[t] + d_s)
//     d_zc   = d_snew * (1 - u) * (1 - cand^2)
//     d_rh   = d_zc @ wh[:, 2D:]^T
//     d_zr   = [d_rh * s_prev * r * (1 - r),  d_snew * (s_prev - cand) * u * (1 - u)]
//     d_xp[t] = [d_zr, d_zc];   d_h = d_snew * u + d_rh * r + d_zr @ wh[:, :2D]^T
//     d_ctx  = d_xp[t] @ wx_c^T                                     [B, 2H]
//   and per batch row b, with pre, the masked softmax w0, w1 = w0 * mask and
//   n = max(sum w1, 1e-9) recomputed from q[t] as the forward has them:
//     d_w    = round(d_ctx[b]) @ enc[b]^T                           [S]
//     d_w1   = d_w / n - [sum w1 > 1e-9] * sum(d_w * w1) / n^2
//     d_z    = w0 * (d_w1 * mask - sum(w0 * d_w1 * mask))
//     d_score = mask > 0 ? d_z : 0
//     d_pre  = (1 - pre^2) * d_score * att_v                        [S, A]
//     d_enc_proj[b] += d_pre;  sum_dpre[t, b] = sum_s d_pre;  d_v += d_score @ pre
//   then d_h += sum_dpre[t] @ att_w^T and d_s = (1 - m) * d_s + d_h.
// Returns d_xp [T, B, 3D], sum_dpre [T, B, A], d_enc_proj [B, S, A],
// d_v [A] and d_s0 = d_s after step 0, as the reference's reverse scan
// (ops/attention_decoder.py::_agd_bwd.rev_step) has them; every weight
// gradient is one batched product outside.  All arithmetic is float32:
// float32 weights and products (ops/numerics.py::bwd_mm, full float32, no
// TF32), with compute-type (CT) reads of enc and enc_proj and the scan
// path's rounding of q, pre and d_ctx to CT.
//
// What bounds it on this card: at the training shape (T = 32, B = 384,
// S = 32, D = A = 512, 2H = 1024) the call does ~66 GFLOP of float32
// products, 0.99 ms at the 67 TFLOP/s float32 peak, against ~0.33 GB of
// unavoidable traffic (0.1 ms): operations bound it.  Each step's products
// need whole rows of the previous results, so the loop is a chain of 4T
// dependent launches.
//
// Design: the reverse loop runs on the host in this file, four kernels a
// step (the launch boundary is the grid-wide barrier each needs; the gaps
// between them are ~5% of the call at the training shape, so they are not
// merged into one cooperative launch):
//   bwd_cand_kernel      d_rh = d_zc @ wh_c^T; writes d_xp[t][:, :D] and
//                        part = d_snew * u + d_rh * r
//   bwd_h_ctx_kernel     d_h = part + d_zr @ wh_zr^T and d_ctx = d_xp @
//                        wx_c^T, two jobs of one launch (blockIdx.z)
//   attention_bwd_kernel one block per batch row: the scores and d_w (a
//                        warp per source position, each lane 8 columns
//                        of enc_proj and enc from one 16-byte load, the
//                        row's q, att_v and d_ctx staged in shared memory
//                        once, lane-major so that those reads are free of
//                        bank conflicts), the softmax chain (one warp), then
//                        sum_dpre with the warps over source positions
//                        and lanes over attention columns, their partials
//                        added in warp order; stores d_score[t] [B, S]
//   bwd_carry_kernel     d_h += sum_dpre @ att_w^T; the carry update; and,
//                        for step t - 1, d_snew and the gate cotangents
//                        d_zc and d_zu (d_xp[t - 1][:, D:]), the next
//                        step's product operand
// Every product is the same register-tiled f32 block (tile_product): a
// 32 WM x 32 WN output tile, KG k-groups over interleaved 16-deep k chunks
// (the chunk -> group map depends on K alone), each thread a 4 x 8 patch
// from 16-byte shared loads (4 rows of A at one k, 8 columns of W), each
// k-group streaming its chunks through its own cp.async double buffer; the
// KG partial tiles meet in shared memory and are added in group order, so
// a row's result does not depend on B.  At B = 384 the K = D products are
// 192 blocks of 32 x 32 (8 k-groups of a warp), the h / ctx launch 144
// blocks of 64 x 64 (2 k-groups of 4 warps).  Products stay full float32
// (no TF32), the port's policy.
//
// d_enc_proj and d_v leave the loop: the TPU kernel keeps a batch block's
// float32 d_enc_proj accumulator resident in VMEM for all T steps; here it
// would be read, added and written in device memory every step (50 MB a
// step at the training shape).  The loop keeps d_score [T, B, S] (1.5 MB),
// and one pass after it (denc_dv_kernel) recomputes pre from q[t] and sums,
// for each (b, s, a), d_enc_proj over t from T-1 down to 0 as the loop
// did, and each row's d_v partial; dv_reduce_kernel adds the rows' d_v
// partials in row order.  No atomics: the same bits on every run.  The
// weights (10 MB, transposed by the caller) stay in L2 across steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <initializer_list>
#include <math_constants.h>

#include "persistent.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ATT_THREADS = 256;  // attention block: 8 warps
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int ATT_CHUNK = 256;    // attention columns a sum_dpre round
constexpr int MAX_S = 4096;       // source positions (shared memory: 8 S B
                                  // beside the row's vectors)
// the attention block's dynamic shared memory, beside its 8 KB of partials
constexpr size_t ATT_SMEM_LIMIT = 232448 - ATT_WARPS * ATT_CHUNK * 4;
constexpr int DV_THREADS = 128;   // denc_dv_kernel: attention columns a block

namespace k6 {

// A product block: a BM x BN output tile, KG k-groups (one warp each) over
// interleaved BK-deep chunks of K, each thread a 4 x 8 patch of the tile.
// On the card eight k-groups ran all three launches fastest: 4 or 16
// k-groups, and 64 x 64 tiles of 2 k-groups of 4 warps, were slower.
constexpr int BM = 32;            // rows of an output tile
constexpr int BN = 32;            // columns of an output tile
constexpr int BK = 16;            // depth of one k chunk
constexpr int KG = 8;             // k-groups
constexpr int THREADS = 32 * KG;  // 256
constexpr int PA = BK + 4;        // A stage pitch: 80-byte rows, so a
                                  // quarter warp's 16-byte reads of two rows
                                  // hit distinct banks
constexpr int STAGE = BM * PA + BK * BN;   // floats of one (A, W) stage
// shared bytes of a block: each warp's double buffer (then, reused, the KG
// partial tiles)
constexpr size_t SMEM = (size_t)KG * 2 * STAGE * sizeof(float);

// one warp's stage of A [BM x BK] (rows row0.., k from k0) and W [BK x BN]
// (k from k0, columns col0..); zeros past M, N or K
__device__ __forceinline__ void load_stage(
    float* st, const float* __restrict__ A, int lda,
    const float* __restrict__ W, int ldw, int M, int N, int K, int row0,
    int col0, int k0, int lane, bool vec) {
  float* as = st;
  float* ws = st + BM * PA;
  if (vec) {                      // 16-byte pieces; K % 4 == N % 4 == 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = lane + 32 * i;
      const int r = p / 4, q = p % 4;
      const bool ok = row0 + r < M && k0 + 4 * q < K;
      pk::cp_async16(as + r * PA + 4 * q,
                     ok ? A + (size_t)(row0 + r) * lda + k0 + 4 * q : A,
                     ok ? 16 : 0);
      const int kk = p / 8, q2 = p % 8;
      const bool okw = k0 + kk < K && col0 + 4 * q2 < N;
      pk::cp_async16(ws + kk * BN + 4 * q2,
                     okw ? W + (size_t)(k0 + kk) * ldw + col0 + 4 * q2 : W,
                     okw ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int e = lane + 32 * i;
      const int r = e / BK, kk = e % BK;
      const bool ok = row0 + r < M && k0 + kk < K;
      pk::cp_async4(as + r * PA + kk,
                    ok ? A + (size_t)(row0 + r) * lda + k0 + kk : A,
                    ok ? 4 : 0);
      const int kw = e / BN, c = e % BN;
      const bool okw = k0 + kw < K && col0 + c < N;
      pk::cp_async4(ws + kw * BN + c,
                    okw ? W + (size_t)(k0 + kw) * ldw + col0 + c : W,
                    okw ? 4 : 0);
    }
  }
}

}  // namespace k6

// The BM x BN tile at (row0, col0) of A [M, K] (row stride lda) @ W [K, N]
// (row stride ldw), float32; epi(row, col, value) for each element inside
// [M, N], called once per element after the k-groups' partials are added
// in group order.  A block of k6::THREADS threads; sm: k6::SMEM bytes of
// dynamic shared memory.
template <typename Epi>
__device__ __forceinline__ void tile_product(float* sm,
                                             const float* __restrict__ A,
                                             int lda,
                                             const float* __restrict__ W,
                                             int ldw, int M, int N, int K,
                                             int row0, int col0, Epi epi) {
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int tx = lane % 4, ty = lane / 4;   // rows 4 ty.., columns 8 tx..
  const bool vec = lda % 4 == 0 && ldw % 4 == 0 && K % 4 == 0 &&
                   N % 4 == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  float* mine = sm + g * 2 * k6::STAGE;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // this warp's chunks: its n-th is chunk g + n KG, in stage n % 2
  const int nck = (K + k6::BK - 1) / k6::BK;
  const int nmine = nck > g ? (nck - g + k6::KG - 1) / k6::KG : 0;
  auto issue = [&](int n) {
    if (n < nmine)
      k6::load_stage(mine + n % 2 * k6::STAGE, A, lda, W, ldw, M, N, K,
                     row0, col0, (g + n * k6::KG) * k6::BK, lane, vec);
    pk::cp_async_commit();          // an empty group past the end
  };
  issue(0);
  for (int n = 0; n < nmine; ++n) {
    pk::cp_async_wait<0>();         // chunk n has landed (this lane's)
    __syncwarp();                   // ... every lane's; stage n - 1 is free
    issue(n + 1);
    const float* as = mine + n % 2 * k6::STAGE;
    const float* ws = as + k6::BM * k6::PA;
#pragma unroll
    for (int kq = 0; kq < k6::BK / 4; ++kq) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (4 * ty + i) * k6::PA +
                                                 4 * kq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wk = ws + (4 * kq + e) * k6::BN + 8 * tx;
        const float4 w0 = *reinterpret_cast<const float4*>(wk);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = e == 0 ? av[i].x : e == 1 ? av[i].y
                        : e == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a * wv[j];
        }
      }
    }
  }
  pk::cp_async_wait<0>();
  __syncthreads();                  // every warp done with its stages
  float* red = sm;                  // [KG][BM][BN] partial tiles
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* row = red + (g * k6::BM + 4 * ty + i) * k6::BN + 8 * tx;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < k6::BM * k6::BN; o += k6::THREADS) {
    const int b = row0 + o / k6::BN, col = col0 + o % k6::BN;
    if (b >= M || col >= N) continue;
    float v = red[o];
#pragma unroll
    for (int gg = 1; gg < k6::KG; ++gg) v += red[gg * k6::BM * k6::BN + o];
    epi(b, col, v);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename CT>
__device__ __forceinline__ float round_ct(float x);
template <>
__device__ __forceinline__ float round_ct<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_ct<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// d_snew of carry element (b, k) at step t
__device__ __forceinline__ float d_snew_of(const float* __restrict__ dout_t,
                                           const float* __restrict__ mask_t,
                                           const float* __restrict__ ds,
                                           int b, int k, int D) {
  const size_t o = (size_t)b * D + k;
  const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
  return mcol * (dout_t[o] + ds[o]);
}

// the gate cotangents of step t that need no product, from d_s after step
// t + 1: d_xp[t][:, D + k] = d_zu and d_xp[t][:, 2D + k] = d_zc
__device__ __forceinline__ void gate_grads(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const float* __restrict__ sp_t, const float* __restrict__ u_t,
    const float* __restrict__ cand_t, const float* __restrict__ ds,
    float* __restrict__ dxp_t, int b, int k, int D) {
  const size_t o = (size_t)b * D + k;
  const float d_snew = d_snew_of(dout_t, mask_t, ds, b, k, D);
  const float u = u_t[o], cand = cand_t[o];
  float* dz = dxp_t + (size_t)b * 3 * D;
  dz[D + k] = d_snew * (sp_t[o] - cand) * u * (1.0f - u);
  dz[2 * D + k] = d_snew * (1.0f - u) * (1.0f - cand * cand);
}

// step T - 1's gate cotangents (d_s = 0)
__global__ void gate_init_kernel(const float* __restrict__ dout_t,
                                 const float* __restrict__ mask_t,
                                 const float* __restrict__ sp_t,
                                 const float* __restrict__ u_t,
                                 const float* __restrict__ cand_t,
                                 const float* __restrict__ ds,
                                 float* __restrict__ dxp_t, int B, int D) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * D) return;
  gate_grads(dout_t, mask_t, sp_t, u_t, cand_t, ds, dxp_t, e / D, e % D, D);
}

// step part 1: d_rh = d_zc @ wh_c^T (whc_t = wh[:, 2D:]^T, [D, D]; d_zc =
// d_xp[t][:, 2D:]); writes d_xp[t][:, :D] and part = d_snew u + d_rh r
__global__ void __launch_bounds__(k6::THREADS) bwd_cand_kernel(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const float* __restrict__ sp_t, const float* __restrict__ r_t,
    const float* __restrict__ u_t, const float* __restrict__ whc_t,
    const float* __restrict__ ds, float* __restrict__ dxp_t,
    float* __restrict__ part, int B, int D) {
  extern __shared__ float4 dyn4[];
  float* sm = reinterpret_cast<float*>(dyn4);
  tile_product(
      sm, dxp_t + 2 * D, 3 * D, whc_t, D, B, D, D, blockIdx.y * k6::BM,
      blockIdx.x * k6::BN, [&](int b, int c, float d_rh) {
        const size_t o = (size_t)b * D + c;
        const float sp = sp_t[o], r = r_t[o];
        dxp_t[(size_t)b * 3 * D + c] = d_rh * sp * r * (1.0f - r);
        part[o] =
            d_snew_of(dout_t, mask_t, ds, b, c, D) * u_t[o] + d_rh * r;
      });
}

// step part 2: d_ctx = d_xp @ wx_c^T (blockIdx.z == 0, the longer job,
// dispatched first; wxc_t = wx_c^T, [3D, 2H]) and d_h = part + d_zr @
// wh_zr^T (blockIdx.z == 1; whg_t = wh[:, :2D]^T, [2D, D])
__global__ void __launch_bounds__(k6::THREADS) bwd_h_ctx_kernel(
    const float* __restrict__ dxp_t, const float* __restrict__ whg_t,
    const float* __restrict__ wxc_t, const float* __restrict__ part,
    float* __restrict__ dh, float* __restrict__ dctx, int B, int D, int H2) {
  extern __shared__ float4 dyn4[];
  float* sm = reinterpret_cast<float*>(dyn4);
  const int row0 = blockIdx.y * k6::BM, col0 = blockIdx.x * k6::BN;
  if (blockIdx.z == 0) {
    if (col0 >= H2) return;                  // the whole block leaves
    tile_product(sm, dxp_t, 3 * D, wxc_t, H2, B, H2, 3 * D, row0, col0,
                 [&](int b, int c, float v) { dctx[(size_t)b * H2 + c] = v; });
  } else {
    if (col0 >= D) return;
    tile_product(sm, dxp_t, 3 * D, whg_t, D, B, D, 2 * D, row0, col0,
                 [&](int b, int c, float v) {
                   const size_t o = (size_t)b * D + c;
                   dh[o] = part[o] + v;
                 });
  }
}

// 8 consecutive values of a row from p as float32: one 16-byte load (two
// for float32) where vec (p 16-byte aligned, the row a multiple of 8
// long) and all 8 lie inside the row (n >= 8), else the first n, zeros
// after
template <typename CT>
__device__ __forceinline__ void load8(const CT* __restrict__ p, int n,
                                      bool vec, float (&v)[8]) {
  if (vec && n >= 8) {
    if constexpr (sizeof(CT) == 2) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    } else {
      const float4 x = *reinterpret_cast<const float4*>(p);
      const float4 y = *reinterpret_cast<const float4*>(p + 4);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? to_f(p[j]) : 0.0f;
  }
}

// Where column i of a row vector lies in shared memory, lane-major: a
// lane reads the 8 columns 256 c + 8 lane + j (j < 8) of chunk c, and they
// lie at 256 c + 32 j + lane, so the warp's 32 reads of one j hit 32 banks
__device__ __forceinline__ int lane_major(int i) {
  return (i & ~255) | ((i & 7) << 5) | ((i >> 3) & 31);
}

// a vector's length padded to whole 256-column chunks (its lane-major room)
__host__ __device__ __forceinline__ int padded_chunks(int n) {
  return (n + 255) / 256 * 256;
}

// pre = round(tanh(round(enc_proj + round(q)))), as the forward has it,
// from enc_proj widened exactly to float32 and the rounded query
template <typename CT>
__device__ __forceinline__ float pre_of(float ep, float q_rounded) {
  return round_ct<CT>(tanhf(round_ct<CT>(ep + q_rounded)));
}

// step part 3: the attention backward of batch row blockIdx.x: d_score[t]
// [B, S] and sum_dpre[t] [B, A].  The row's enc and enc_proj come in
// 16-byte pieces, 8 values a lane; its q, att_v and d_ctx (rounded as the
// products take them) are staged in shared memory once, lane-major
// (lane_major), so that a lane's 8 columns are read without bank
// conflicts.  sum_dpre reads enc_proj again (from L2) and recomputes pre.
template <typename CT>
__global__ void __launch_bounds__(ATT_THREADS) attention_bwd_kernel(
    const float* __restrict__ q_t, const CT* __restrict__ enc_proj,
    const CT* __restrict__ enc, const float* __restrict__ src_mask,
    const float* __restrict__ att_v, const float* __restrict__ dctx,
    float* __restrict__ dsc_t, float* __restrict__ sdp_t, int S, int A,
    int H2) {
  extern __shared__ float4 att4[];
  float* sm = reinterpret_cast<float*>(att4);
  const int Ap = padded_chunks(A), H2p = padded_chunks(H2);
  float* w0 = sm;                      // [S]: scores, then softmax w0
  float* dsc = w0 + S;                 // [S]: d_w, then d_score
  float* qs = dsc + S;                 // [Ap]: round(q), lane-major
  float* vs = qs + Ap;                 // [Ap]: round(att_v), lane-major
  float* vf = vs + Ap;                 // [Ap]: att_v, lane-major
  float* dcs = vf + Ap;                // [H2p]: round(d_ctx), lane-major
  __shared__ float red[ATT_WARPS][ATT_CHUNK];   // lane-major too
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const CT* ep = enc_proj + (size_t)b * S * A;
  const CT* eb = enc + (size_t)b * S * H2;
  const bool vec = A % 8 == 0 && H2 % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(enc_proj) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(enc) & 15) == 0;
  for (int i = threadIdx.x; i < A; i += ATT_THREADS) {
    qs[lane_major(i)] = round_ct<CT>(q_t[(size_t)b * A + i]);
    vs[lane_major(i)] = round_ct<CT>(att_v[i]);
    vf[lane_major(i)] = att_v[i];
  }
  for (int i = threadIdx.x; i < H2; i += ATT_THREADS)
    dcs[lane_major(i)] = round_ct<CT>(dctx[(size_t)b * H2 + i]);
  __syncthreads();
  // a lane's columns a0 .. a0 + 7 (a0 = 256 c + 8 lane) lie at 256 c +
  // lane + 32 j in the lane-major vectors
  for (int s = warp; s < S; s += ATT_WARPS) {
    const CT* er = ep + (size_t)s * A;
    const CT* hr = eb + (size_t)s * H2;
    float sc = 0.0f, dw = 0.0f;
    for (int a0 = 8 * lane; a0 < A; a0 += 256) {
      float e[8];
      load8<CT>(er + a0, A - a0, vec, e);
      const int am = a0 - 7 * lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (a0 + j < A)
          sc += pre_of<CT>(e[j], qs[am + 32 * j]) * vs[am + 32 * j];
    }
    for (int h0 = 8 * lane; h0 < H2; h0 += 256) {
      float e[8];
      load8<CT>(hr + h0, H2 - h0, vec, e);
      const int hm = h0 - 7 * lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (h0 + j < H2) dw += dcs[hm + 32 * j] * e[j];
    }
    sc = warp_sum(sc);
    dw = warp_sum(dw);
    if (lane == 0) {
      w0[s] = sc;
      dsc[s] = dw;
    }
  }
  __syncthreads();
  if (warp == 0) {        // the softmax chain; each lane owns its positions
    const float* mk = src_mask + (size_t)b * S;
    float mx = -CUDART_INF_F;
    for (int s = lane; s < S; s += 32) {
      const float z = mk[s] > 0.0f ? w0[s] : -FLT_MAX;
      w0[s] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(w0[s] - mx);
      w0[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float sw1 = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float p = w0[s] / sum;
      w0[s] = p;
      sw1 += p * mk[s];
    }
    sw1 = warp_sum(sw1);
    const float n = fmaxf(sw1, 1e-9f);
    float sdw1 = 0.0f;
    for (int s = lane; s < S; s += 32) sdw1 += dsc[s] * (w0[s] * mk[s]);
    sdw1 = warp_sum(sdw1);
    const float d_n = -sdw1 / (n * n);
    const float live = sw1 > 1e-9f ? 1.0f : 0.0f;
    float t0 = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float d_w0 = (dsc[s] / n + d_n * live) * mk[s];
      dsc[s] = d_w0;
      t0 += w0[s] * d_w0;
    }
    t0 = warp_sum(t0);
    for (int s = lane; s < S; s += 32) {
      const float d = mk[s] > 0.0f ? w0[s] * (dsc[s] - t0) : 0.0f;
      dsc[s] = d;
      dsc_t[(size_t)b * S + s] = d;
    }
  }
  __syncthreads();
  // sum_dpre[a] = sum_s (1 - pre^2) d_score[s] att_v[a], ATT_CHUNK columns
  // a round: warp w takes the positions s = w mod 8 (none where d_score is
  // 0: masked or no cotangent), each lane 8 columns; the warps' partials
  // are added in warp order
  for (int a0 = 0; a0 < A; a0 += ATT_CHUNK) {
    const int a = a0 + 8 * lane;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int s = warp; s < S; s += ATT_WARPS) {
      const float d = dsc[s];
      if (d == 0.0f) continue;        // uniform over the warp
      float e[8];
      load8<CT>(ep + (size_t)s * A + a, A - a, vec, e);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (a + j < A) {
          const int m = a0 + lane + 32 * j;
          const float p = pre_of<CT>(e[j], qs[m]);
          acc[j] += (1.0f - p * p) * (d * vf[m]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][lane + 32 * j] = acc[j];
    __syncthreads();
    if (a0 + threadIdx.x < A) {
      const int m = lane_major(threadIdx.x);
      float v = red[0][m];
#pragma unroll
      for (int w = 1; w < ATT_WARPS; ++w) v += red[w][m];
      sdp_t[(size_t)b * A + a0 + threadIdx.x] = v;
    }
    __syncthreads();
  }
}

// step part 4: d_h += sum_dpre @ att_w^T (attw_t [A, D]); d_s = (1 - m) d_s
// + d_h; then (has_prev) step t - 1's gate cotangents from the new d_s.
// Each thread reads and writes only its own d_s entries.
__global__ void __launch_bounds__(k6::THREADS) bwd_carry_kernel(
    const float* __restrict__ sdp_t, const float* __restrict__ attw_t,
    const float* __restrict__ dh, const float* __restrict__ mask_t,
    float* __restrict__ ds, const float* __restrict__ dout_p,
    const float* __restrict__ mask_p, const float* __restrict__ sp_p,
    const float* __restrict__ u_p, const float* __restrict__ cand_p,
    float* __restrict__ dxp_p, int B, int D, int A) {
  extern __shared__ float4 dyn4[];
  float* sm = reinterpret_cast<float*>(dyn4);
  tile_product(
      sm, sdp_t, A, attw_t, D, B, D, A, blockIdx.y * k6::BM,
      blockIdx.x * k6::BN, [&](int b, int c, float v) {
        const size_t o = (size_t)b * D + c;
        const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
        ds[o] = (1.0f - mcol) * ds[o] + (dh[o] + v);
        if (dxp_p != nullptr)
          gate_grads(dout_p, mask_p, sp_p, u_p, cand_p, ds, dxp_p, b, c, D);
      });
}

// after the loop, per (b, s, a): d_enc_proj = sum over t from T-1 down to
// 0 of (1 - pre_t^2) d_score[t] att_v[a]; the row's d_v partial = sum over
// s, then t, of d_score[t] pre_t.  Steps with d_score 0 (padded target
// steps, masked positions) add nothing and are skipped.
template <typename CT>
__global__ void __launch_bounds__(DV_THREADS) denc_dv_kernel(
    const float* __restrict__ q, const CT* __restrict__ enc_proj,
    const float* __restrict__ att_v, const float* __restrict__ dsc,
    float* __restrict__ denc_p, float* __restrict__ dv_part, int T, int B,
    int S, int A) {
  const int b = blockIdx.y, a = blockIdx.x * DV_THREADS + threadIdx.x;
  if (a >= A) return;
  const float va = att_v[a];
  float dv = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float ep = to_f(enc_proj[((size_t)b * S + s) * A + a]);
    float acc = 0.0f, dvs = 0.0f;
    for (int t = T - 1; t >= 0; --t) {
      const float d = dsc[((size_t)t * B + b) * S + s];
      if (d == 0.0f) continue;        // uniform over the block
      const float p =
          pre_of<CT>(ep, round_ct<CT>(q[((size_t)t * B + b) * A + a]));
      acc += (1.0f - p * p) * (d * va);
      dvs += d * p;
    }
    denc_p[((size_t)b * S + s) * A + a] = acc;
    dv += dvs;
  }
  dv_part[(size_t)b * A + a] = dv;
}

// d_v[a] = sum over batch rows of the rows' partials, in row order
__global__ void dv_reduce_kernel(const float* __restrict__ dv_part,
                                 float* __restrict__ dv, int B, int A) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += dv_part[(size_t)b * A + a];
  dv[a] = acc;
}

#define PTT_CHECK(call)                              \
  do {                                               \
    const cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

template <typename CT>
int attn_dec_bwd_impl(const float* dout, const float* mask, const float* sp,
                      const float* r, const float* u, const float* cand,
                      const float* q, const CT* enc, const CT* enc_proj,
                      const float* src_mask, const float* att_v,
                      const float* attw_t, const float* whc_t,
                      const float* whg_t, const float* wxc_t, float* dxp,
                      float* sdp, float* denc_p, float* dv, float* ds,
                      float* work, int T, int B, int S, int D, int A, int H2,
                      cudaStream_t stream) {
  if (T < 0 || B < 0 || S <= 0 || S > MAX_S || D <= 0 || A <= 0 || H2 <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bd = (size_t)B * D;
  PTT_CHECK(cudaMemsetAsync(ds, 0, bd * sizeof(float), stream));
  if (T == 0 || B == 0) {
    PTT_CHECK(cudaMemsetAsync(denc_p, 0, (size_t)B * S * A * sizeof(float),
                              stream));
    PTT_CHECK(cudaMemsetAsync(dv, 0, (size_t)A * sizeof(float), stream));
    return (int)cudaSuccess;
  }
  float* part = work;                    // d_snew * u + d_rh * r  [B, D]
  float* dh = part + bd;                 // d_h before attention   [B, D]
  float* dctx = dh + bd;                 // d_ctx                  [B, 2H]
  float* dv_part = dctx + (size_t)B * H2;  // d_v per batch row    [B, A]
  float* dsc = dv_part + (size_t)B * A;  // d_score                [T, B, S]
  const int rows = (B + k6::BM - 1) / k6::BM;
  const dim3 block(k6::THREADS);
  const dim3 grid_d((D + k6::BN - 1) / k6::BN, rows);
  const dim3 grid_hc(((H2 > D ? H2 : D) + k6::BN - 1) / k6::BN, rows, 2);
  for (const void* fn : {(const void*)bwd_cand_kernel,
                         (const void*)bwd_h_ctx_kernel,
                         (const void*)bwd_carry_kernel})
    PTT_CHECK(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k6::SMEM));
  // the attention block's positions (scores, d_score) and its row's
  // rounded q, att_v and d_ctx and float32 att_v, lane-major
  const size_t att_smem =
      (2 * (size_t)S + 3 * (size_t)padded_chunks(A) + padded_chunks(H2)) *
      sizeof(float);
  if (att_smem > ATT_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  PTT_CHECK(cudaFuncSetAttribute(attention_bwd_kernel<CT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)att_smem));
  const size_t step3 = 3 * bd;
  {
    const int t = T - 1;
    gate_init_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, stream>>>(
        dout + t * bd, mask + (size_t)t * B, sp + t * bd, u + t * bd,
        cand + t * bd, ds, dxp + t * step3, B, D);
    PTT_CHECK(cudaGetLastError());
  }
  for (int t = T - 1; t >= 0; --t) {
    const float* mask_t = mask + (size_t)t * B;
    float* dxp_t = dxp + (size_t)t * step3;
    float* sdp_t = sdp + (size_t)t * B * A;
    bwd_cand_kernel<<<grid_d, block, k6::SMEM, stream>>>(
        dout + t * bd, mask_t, sp + t * bd, r + t * bd, u + t * bd, whc_t,
        ds, dxp_t, part, B, D);
    PTT_CHECK(cudaGetLastError());
    bwd_h_ctx_kernel<<<grid_hc, block, k6::SMEM, stream>>>(
        dxp_t, whg_t, wxc_t, part, dh, dctx, B, D, H2);
    PTT_CHECK(cudaGetLastError());
    attention_bwd_kernel<CT><<<B, ATT_THREADS, att_smem, stream>>>(
        q + (size_t)t * B * A, enc_proj, enc, src_mask, att_v, dctx,
        dsc + (size_t)t * B * S, sdp_t, S, A, H2);
    PTT_CHECK(cudaGetLastError());
    const bool prev = t > 0;
    const int tp = t - 1;
    bwd_carry_kernel<<<grid_d, block, k6::SMEM, stream>>>(
        sdp_t, attw_t, dh, mask_t, ds, prev ? dout + tp * bd : nullptr,
        prev ? mask + (size_t)tp * B : nullptr, prev ? sp + tp * bd : nullptr,
        prev ? u + tp * bd : nullptr, prev ? cand + tp * bd : nullptr,
        prev ? dxp + tp * step3 : nullptr, B, D, A);
    PTT_CHECK(cudaGetLastError());
  }
  denc_dv_kernel<CT>
      <<<dim3((A + DV_THREADS - 1) / DV_THREADS, B), DV_THREADS, 0, stream>>>(
          q, enc_proj, att_v, dsc, denc_p, dv_part, T, B, S, A);
  PTT_CHECK(cudaGetLastError());
  dv_reduce_kernel<<<(A + 255) / 256, 256, 0, stream>>>(dv_part, dv, B, A);
  PTT_CHECK(cudaGetLastError());
  return (int)cudaSuccess;
}

template <typename CT>
int attn_dec_bwd_entry(const void* dout, const void* mask, const void* sp,
                       const void* r, const void* u, const void* cand,
                       const void* q, const void* enc, const void* enc_proj,
                       const void* src_mask, const void* att_v,
                       const void* attw_t, const void* whc_t,
                       const void* whg_t, const void* wxc_t, void* dxp,
                       void* sdp, void* denc_p, void* dv, void* ds,
                       void* work, int T, int B, int S, int D, int A, int H2,
                       void* stream) {
  return attn_dec_bwd_impl<CT>(
      (const float*)dout, (const float*)mask, (const float*)sp,
      (const float*)r, (const float*)u, (const float*)cand, (const float*)q,
      (const CT*)enc, (const CT*)enc_proj, (const float*)src_mask,
      (const float*)att_v, (const float*)attw_t, (const float*)whc_t,
      (const float*)whg_t, (const float*)wxc_t, (float*)dxp, (float*)sdp,
      (float*)denc_p, (float*)dv, (float*)ds, (float*)work, T, B, S, D, A,
      H2, (cudaStream_t)stream);
}

}  // namespace

// dout, s_prev, r, u, cand [T, B, D] f32, mask [T, B] f32, q [T, B, A] f32,
// enc [B, S, 2H] and enc_proj [B, S, A] in the compute type, src_mask
// [B, S] f32, att_v [A] f32, the transposed float32 weights att_w^T
// [A, D], wh[:, 2D:]^T [D, D], wh[:, :2D]^T [2D, D], wx_c^T [3D, 2H] ->
// d_xp [T, B, 3D], sum_dpre [T, B, A], d_enc_proj [B, S, A], d_v [A],
// d_s0 [B, D], all f32; work is float32 scratch of B * (2D + 2H + A) +
// T * B * S.
// Returns a cudaError_t.
extern "C" int attn_dec_bwd_f32(const void* dout, const void* mask,
                                const void* sp, const void* r, const void* u,
                                const void* cand, const void* q,
                                const void* enc, const void* enc_proj,
                                const void* src_mask, const void* att_v,
                                const void* attw_t, const void* whc_t,
                                const void* whg_t, const void* wxc_t,
                                void* dxp, void* sdp, void* denc_p, void* dv,
                                void* ds, void* work, int T, int B, int S,
                                int D, int A, int H2, void* stream) {
  return attn_dec_bwd_entry<float>(dout, mask, sp, r, u, cand, q, enc,
                                   enc_proj, src_mask, att_v, attw_t, whc_t,
                                   whg_t, wxc_t, dxp, sdp, denc_p, dv, ds,
                                   work, T, B, S, D, A, H2, stream);
}

extern "C" int attn_dec_bwd_bf16(const void* dout, const void* mask,
                                 const void* sp, const void* r, const void* u,
                                 const void* cand, const void* q,
                                 const void* enc, const void* enc_proj,
                                 const void* src_mask, const void* att_v,
                                 const void* attw_t, const void* whc_t,
                                 const void* whg_t, const void* wxc_t,
                                 void* dxp, void* sdp, void* denc_p, void* dv,
                                 void* ds, void* work, int T, int B, int S,
                                 int D, int A, int H2, void* stream) {
  return attn_dec_bwd_entry<bf16>(dout, mask, sp, r, u, cand, q, enc,
                                  enc_proj, src_mask, att_v, attw_t, whc_t,
                                  whg_t, wxc_t, dxp, sdp, denc_p, dv, ds,
                                  work, T, B, S, D, A, H2, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

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
// unavoidable traffic (0.1 ms): operations bound it.  As in the forward,
// each step's products need whole rows of the previous results, so the
// loop is a chain of 4T dependent launches and runs far above the bound.
//
// Design: the reverse loop runs on the host in this file, four small
// kernels a step (the launch boundary is the grid-wide barrier each needs):
//   bwd_cand_kernel     d_rh = d_zc @ wh_c^T, with d_zc formed while its tile
//                       loads; writes d_xp[t] and d_snew * u + d_rh * r
//   bwd_h_ctx_kernel    d_h = ... + d_zr @ wh_zr^T and d_ctx = d_xp @ wx_c^T,
//                       two jobs of one launch (blockIdx.z)
//   attention_bwd_kernel one block per batch row: the scores and d_w (one
//                       warp per source position), the softmax chain (one
//                       warp), then one thread per attention column over S:
//                       d_pre, the row's d_enc_proj, sum_dpre and its d_v
//                       partial
//   bwd_carry_kernel    d_h += sum_dpre @ att_w^T; the carry update
// and a last kernel sums the rows' d_v partials in a fixed order.  The TPU
// kernel keeps a batch block's enc, enc_proj and float32 d_enc_proj
// accumulator resident in VMEM for all T steps; one batch row's set is
// already 160 KB here, so they are streamed: d_enc_proj is read, added and
// written in device memory each step (50 MB a step at the training shape),
// and d_v is accumulated per batch row and summed after the loop, without
// atomics, so the result is the same bits on every run.  The weights
// (10 MB, transposed by the caller) stay in L2 across steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 32;            // batch rows per product block
constexpr int BN = 32;            // output columns per product block
constexpr int BK = 32;            // depth of one shared-memory stage
constexpr int THREADS = 256;      // 16 x 16 threads, each a 2 x 2 patch
constexpr int ATT_THREADS = 256;  // attention block: 8 warps
constexpr int ATT_WARPS = ATT_THREADS / 32;
constexpr int MAX_S = 4096;       // source positions (shared memory: 8 S B)

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

// pre = round(tanh(round(enc_proj + round(q)))), as the forward has it
template <typename CT>
__device__ __forceinline__ float pre_act(CT ep, float q_rounded) {
  return round_ct<CT>(tanhf(round_ct<CT>(to_f(ep) + q_rounded)));
}

// acc[i][j] += sum_k load_a(row, k) * W[k, col] over k < K for the block's
// BM x BN tile at (row0, col0); W is float32 [K, N] with row stride ldw.
template <typename LoadA>
__device__ __forceinline__ void tile_product(LoadA load_a,
                                             const float* __restrict__ W,
                                             int ldw, int M, int N, int K,
                                             int row0, int col0,
                                             float acc[2][2]) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      As[r][c] = (gr < M && gk < K) ? load_a(gr, gk) : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      Ws[r][c] = (gk < K && gc < N) ? W[(size_t)gk * ldw + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[ty * 2][kk], a1 = As[ty * 2 + 1][kk];
      const float w0 = Ws[kk][tx], w1 = Ws[kk][tx + 16];
      acc[0][0] += a0 * w0;
      acc[0][1] += a0 * w1;
      acc[1][0] += a1 * w0;
      acc[1][1] += a1 * w1;
    }
    __syncthreads();
  }
}

// d_snew and d_zc of carry element (b, k) at step t
struct CandGrad {
  float d_snew, u, cand, d_zc;
};

__device__ __forceinline__ CandGrad cand_grad(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const float* __restrict__ u_t, const float* __restrict__ cand_t,
    const float* __restrict__ ds, int b, int k, int D) {
  CandGrad g;
  const size_t o = (size_t)b * D + k;
  const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
  g.d_snew = mcol * (dout_t[o] + ds[o]);
  g.u = u_t[o];
  g.cand = cand_t[o];
  g.d_zc = g.d_snew * (1.0f - g.u) * (1.0f - g.cand * g.cand);
  return g;
}

// step part 1: d_rh = d_zc @ wh_c^T (whc_t = wh[:, 2D:]^T, [D, D]); writes
// d_xp[t] (all three gate blocks) and part = d_snew * u + d_rh * r
__global__ void __launch_bounds__(THREADS) bwd_cand_kernel(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const float* __restrict__ sp_t, const float* __restrict__ r_t,
    const float* __restrict__ u_t, const float* __restrict__ cand_t,
    const float* __restrict__ whc_t, const float* __restrict__ ds,
    float* __restrict__ dxp_t, float* __restrict__ part, int B, int D) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dzc = [&](int b, int k) {
    return cand_grad(dout_t, mask_t, u_t, cand_t, ds, b, k, D).d_zc;
  };
  tile_product(load_dzc, whc_t, D, B, D, D, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= D) continue;
      const size_t o = (size_t)b * D + c;
      const CandGrad g = cand_grad(dout_t, mask_t, u_t, cand_t, ds, b, c, D);
      const float sp = sp_t[o], r = r_t[o];
      const float d_u = g.d_snew * (sp - g.cand);
      const float d_rh = acc[i][j];
      float* dz = dxp_t + (size_t)b * 3 * D;
      dz[c] = d_rh * sp * r * (1.0f - r);
      dz[D + c] = d_u * g.u * (1.0f - g.u);
      dz[2 * D + c] = g.d_zc;
      part[o] = g.d_snew * g.u + d_rh * r;
    }
  }
}

// step part 2: d_h = part + d_zr @ wh_zr^T (blockIdx.z == 0; whg_t =
// wh[:, :2D]^T, [2D, D]) and d_ctx = d_xp @ wx_c^T (blockIdx.z == 1;
// wxc_t = wx_c^T, [3D, 2H])
__global__ void __launch_bounds__(THREADS) bwd_h_ctx_kernel(
    const float* __restrict__ dxp_t, const float* __restrict__ whg_t,
    const float* __restrict__ wxc_t, const float* __restrict__ part,
    float* __restrict__ dh, float* __restrict__ dctx, int B, int D, int H2) {
  const bool ctx_job = blockIdx.z == 1;
  const int N = ctx_job ? H2 : D;
  const int K = ctx_job ? 3 * D : 2 * D;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (col0 >= N) return;                       // the whole block leaves
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dxp = [&](int b, int k) { return dxp_t[(size_t)b * 3 * D + k]; };
  tile_product(load_dxp, ctx_job ? wxc_t : whg_t, N, B, N, K, row0, col0,
               acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= N) continue;
      const size_t o = (size_t)b * N + c;
      if (ctx_job)
        dctx[o] = acc[i][j];
      else
        dh[o] = part[o] + acc[i][j];
    }
  }
}

// step part 3: the attention backward of batch row blockIdx.x.  first != 0
// (step T-1) starts the row's d_enc_proj and d_v accumulators.
template <typename CT>
__global__ void __launch_bounds__(ATT_THREADS) attention_bwd_kernel(
    const float* __restrict__ q_t, const CT* __restrict__ enc_proj,
    const CT* __restrict__ enc, const float* __restrict__ src_mask,
    const float* __restrict__ att_v, const float* __restrict__ dctx,
    float* __restrict__ denc_p, float* __restrict__ dv_part,
    float* __restrict__ sdp_t, int S, int A, int H2, int first) {
  extern __shared__ float sm[];
  float* w0 = sm;                      // [S]: scores, then softmax w0
  float* dsc = sm + S;                 // [S]: d_w, then d_score
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const CT* ep = enc_proj + (size_t)b * S * A;
  const CT* eb = enc + (size_t)b * S * H2;
  const float* qb = q_t + (size_t)b * A;
  const float* dcb = dctx + (size_t)b * H2;
  for (int s = warp; s < S; s += ATT_WARPS) {
    float sc = 0.0f, dw = 0.0f;
    for (int a = lane; a < A; a += 32)
      sc += pre_act<CT>(ep[(size_t)s * A + a], round_ct<CT>(qb[a]))
            * round_ct<CT>(att_v[a]);
    for (int h = lane; h < H2; h += 32)
      dw += round_ct<CT>(dcb[h]) * to_f(eb[(size_t)s * H2 + h]);
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
    for (int s = lane; s < S; s += 32)
      dsc[s] = mk[s] > 0.0f ? w0[s] * (dsc[s] - t0) : 0.0f;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += ATT_THREADS) {
    const float qa = round_ct<CT>(qb[a]), va = att_v[a];
    float sdp = 0.0f, dv = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float p = pre_act<CT>(ep[(size_t)s * A + a], qa);
      const float d_pre = (1.0f - p * p) * (dsc[s] * va);
      const size_t o = ((size_t)b * S + s) * A + a;
      denc_p[o] = first ? d_pre : denc_p[o] + d_pre;
      sdp += d_pre;
      dv += dsc[s] * p;
    }
    const size_t o = (size_t)b * A + a;
    sdp_t[o] = sdp;
    dv_part[o] = first ? dv : dv_part[o] + dv;
  }
}

// step part 4: d_h += sum_dpre @ att_w^T (attw_t [A, D]); d_s = (1 - m) d_s
// + d_h.  Each thread reads and writes only its own d_s entries.
__global__ void __launch_bounds__(THREADS) bwd_carry_kernel(
    const float* __restrict__ sdp_t, const float* __restrict__ attw_t,
    const float* __restrict__ dh, const float* __restrict__ mask_t,
    float* __restrict__ ds, int B, int D, int A) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_sdp = [&](int b, int k) { return sdp_t[(size_t)b * A + k]; };
  tile_product(load_sdp, attw_t, D, B, D, A, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= D) continue;
      const size_t o = (size_t)b * D + c;
      const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
      ds[o] = (1.0f - mcol) * ds[o] + (dh[o] + acc[i][j]);
    }
  }
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
  const int rows = (B + BM - 1) / BM;
  const dim3 block(THREADS);
  const dim3 grid_d((D + BN - 1) / BN, rows);
  const dim3 grid_hc(((H2 > D ? H2 : D) + BN - 1) / BN, rows, 2);
  const size_t att_smem = 2 * (size_t)S * sizeof(float);
  for (int t = T - 1; t >= 0; --t) {
    const float* mask_t = mask + (size_t)t * B;
    float* dxp_t = dxp + (size_t)t * 3 * bd;
    float* sdp_t = sdp + (size_t)t * B * A;
    bwd_cand_kernel<<<grid_d, block, 0, stream>>>(
        dout + t * bd, mask_t, sp + t * bd, r + t * bd, u + t * bd,
        cand + t * bd, whc_t, ds, dxp_t, part, B, D);
    PTT_CHECK(cudaGetLastError());
    bwd_h_ctx_kernel<<<grid_hc, block, 0, stream>>>(dxp_t, whg_t, wxc_t,
                                                    part, dh, dctx, B, D, H2);
    PTT_CHECK(cudaGetLastError());
    attention_bwd_kernel<CT><<<B, ATT_THREADS, att_smem, stream>>>(
        q + (size_t)t * B * A, enc_proj, enc, src_mask, att_v, dctx, denc_p,
        dv_part, sdp_t, S, A, H2, t == T - 1);
    PTT_CHECK(cudaGetLastError());
    bwd_carry_kernel<<<grid_d, block, 0, stream>>>(sdp_t, attw_t, dh, mask_t,
                                                   ds, B, D, A);
    PTT_CHECK(cudaGetLastError());
  }
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
// d_s0 [B, D], all f32; work is float32 scratch of B * (2D + 2H + A).
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

// Attention GRU decoder, forward time loop, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::attn_dec_fwd_pallas (the
// _attn_dec_fwd_kernel body), which the flagship's training decoder reaches
// through ops/attention_decoder.py::_decoder_fwd_scan (its Pallas branch).
//
// Computes, for t = 0 .. T-1 over a time-major batch, with the carry s
// [B, D] in float32 (seeded by s0), round() the cast of a product operand
// to the compute type CT (float or bfloat16) and every product accumulating
// in float32:
//     q       = round(s) @ att_w                                    [B, A]
//     pre     = round(tanh(round(enc_proj[b] + round(q[b]))))       [S, A]
//     score   = pre @ att_v                                         [S]
//     w0      = softmax(src_mask > 0 ? score : -FLT_MAX)
//     w       = w0 * src_mask / max(sum(w0 * src_mask), 1e-9)      -> probs[t]
//     ctx     = round(round(w) @ enc[b])                           -> ctx[t]
//     xp      = xp_y[t] + ctx @ wx_c                                [B, 3D]
//     zr      = xp[:, :2D] + round(s) @ wh[:, :2D];  r, u = sigmoid(zr)
//     cand    = tanh(xp[:, 2D:] + round(r * s) @ wh[:, 2D:])
//     s_new   = u * s + (1 - u) * cand
//     s_prev[t] = s;  s = mask[t] > 0 ? s_new : s;  states[t] = s * mask[t]
// These are the rounding points of the scan path that the port's plain
// version follows (ops/attention_decoder.py::_fwd_step): the score and
// context sums take exact float32 products of CT values.  The TPU kernel
// rounds those products to CT before summing (a Mosaic lowering
// workaround); under the float32 policy the two are the same.
//
// What bounds it on this card: at the training shape (T = 32, B = 384,
// S = 32, D = A = 512, 2H = 1024) a step is 2.05 GFLOP of products, 65.6
// GFLOP a call, 0.066 ms at the bf16 tensor-core peak, against ~0.19 GB of
// unavoidable traffic (0.057 ms): operations bound it.  But every product
// of a step needs the whole previous row of the carry, and the attention
// needs the whole query row, so a step is a chain of grid-wide
// dependencies: the loop is bound by the latency of its dependent launches
// and by how well a small product fills 132 SMs, far above both bounds.
//
// Design: the time loop runs on the host in this file, four small kernels
// a step (the launch boundary is the grid-wide barrier each needs):
//   query_gate_kernel  [q | zr_h] = round(s) @ [att_w | wh[:, :2D]], as two
//                      jobs of one launch (blockIdx.z)
//   attention_kernel   one block per batch row: scores (one warp per source
//                      position), the masked softmax (one warp), the
//                      context (one thread per column); enc / enc_proj are
//                      streamed from device memory (96 KB a row at the
//                      training shape, 37 MB a step: they do not stay in
//                      the 50 MB L2 against the other streams)
//   xp_gate_kernel     ctx @ wx_c, then xp, the gates r * s and u
//   cand_kernel        round(r * s) @ wh[:, 2D:], tanh, the update and the
//                      mask hold; writes states[t] and s_prev[t]
// The weights (5 MB in bf16) stay in L2 across steps.  Each product block
// owns a 32 x 32 output tile and sums over k in a fixed order, and every
// reduction of the attention runs in a fixed order, so a row's result does
// not depend on B and repeated calls give the same bits.  The products
// run on the CUDA cores (float32 FMAs on CT operands widened to float32,
// which is exact for bfloat16); tensor cores are work for a later change.

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
constexpr int MAX_S = 4096;       // source positions (shared memory: 4 S B)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// the operand cast of the reference (astype(compute dtype)), round to
// nearest even, widened back for the float32 arithmetic
template <typename CT>
__device__ __forceinline__ float round_ct(float x);
template <>
__device__ __forceinline__ float round_ct<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_ct<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename CT>
__device__ __forceinline__ CT from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// acc[i][j] += sum_k load_a(row, k) * W[k, col] over k < K for the block's
// BM x BN tile at (row0, col0); W is [K, N] in type WT with row stride ldw,
// load_a(row, k) gives the (already rounded) left operand, 0 outside.
template <typename WT, typename LoadA>
__device__ __forceinline__ void tile_product(LoadA load_a,
                                             const WT* __restrict__ W,
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
      Ws[r][c] = (gk < K && gc < N) ? to_f(W[(size_t)gk * ldw + gc]) : 0.0f;
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

// step part 1: q = round(s) @ att_w (blockIdx.z == 0, N = A) and
// zr_h = round(s) @ wh[:, :2D] (blockIdx.z == 1, N = 2D)
template <typename CT>
__global__ void __launch_bounds__(THREADS) query_gate_kernel(
    const float* __restrict__ s, const CT* __restrict__ att_w,
    const CT* __restrict__ wh, float* __restrict__ q,
    float* __restrict__ zrh, int B, int D, int A) {
  const bool gate = blockIdx.z == 1;
  const int N = gate ? 2 * D : A;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  if (col0 >= N) return;                       // the whole block leaves
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_s = [&](int b, int k) {
    return round_ct<CT>(s[(size_t)b * D + k]);
  };
  tile_product(load_s, gate ? wh : att_w, gate ? 3 * D : A, B, N, D, row0,
               col0, acc);
  float* out = gate ? zrh : q;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b < B && c < N) out[(size_t)b * N + c] = acc[i][j];
    }
  }
}

// step part 2: the attention of batch row blockIdx.x -> probs[t], ctx[t]
template <typename CT>
__global__ void __launch_bounds__(ATT_THREADS) attention_kernel(
    const float* __restrict__ q, const CT* __restrict__ enc_proj,
    const CT* __restrict__ enc, const float* __restrict__ src_mask,
    const CT* __restrict__ att_v, float* __restrict__ probs_t,
    CT* __restrict__ ctx_t, int S, int A, int H2) {
  extern __shared__ float w[];                 // [S]: scores, then weights
  const int b = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const CT* ep = enc_proj + (size_t)b * S * A;
  const float* qb = q + (size_t)b * A;
  for (int s = warp; s < S; s += ATT_WARPS) {
    float part = 0.0f;
    for (int a = lane; a < A; a += 32) {
      const float x = round_ct<CT>(to_f(ep[(size_t)s * A + a])
                                   + round_ct<CT>(qb[a]));
      part += round_ct<CT>(tanhf(x)) * to_f(att_v[a]);
    }
    part = warp_sum(part);
    if (lane == 0) w[s] = part;
  }
  __syncthreads();
  if (warp == 0) {                 // masked softmax, renormalised; each lane
    const float* mk = src_mask + (size_t)b * S;   // owns its own positions
    float mx = -CUDART_INF_F;
    for (int s = lane; s < S; s += 32) {
      const float z = mk[s] > 0.0f ? w[s] : -FLT_MAX;
      w[s] = z;
      mx = fmaxf(mx, z);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(w[s] - mx);
      w[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float n = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float w1 = (w[s] / sum) * mk[s];
      w[s] = w1;
      n += w1;
    }
    n = fmaxf(warp_sum(n), 1e-9f);
    for (int s = lane; s < S; s += 32) {
      const float ws = w[s] / n;
      w[s] = ws;
      probs_t[(size_t)b * S + s] = ws;
    }
  }
  __syncthreads();
  const CT* eb = enc + (size_t)b * S * H2;
  for (int h = threadIdx.x; h < H2; h += ATT_THREADS) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s)
      acc += round_ct<CT>(w[s]) * to_f(eb[(size_t)s * H2 + h]);
    ctx_t[(size_t)b * H2 + h] = from_f<CT>(acc);
  }
}

// step part 3: xp = xp_y[t] + ctx @ wx_c; the gates r * s and u, and the
// candidate's input half xp[:, 2D:]
template <typename CT>
__global__ void __launch_bounds__(THREADS) xp_gate_kernel(
    const CT* __restrict__ ctx_t, const CT* __restrict__ wx_c,
    const float* __restrict__ xp_y_t, const float* __restrict__ zrh,
    const float* __restrict__ s, float* __restrict__ rs,
    float* __restrict__ u, float* __restrict__ xpc, int B, int D, int H2) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int N = 3 * D;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_ctx = [&](int b, int k) { return to_f(ctx_t[(size_t)b * H2 + k]); };
  tile_product(load_ctx, wx_c, N, B, N, H2, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= N) continue;
      const float xp = xp_y_t[(size_t)b * N + c] + acc[i][j];
      if (c < 2 * D) {
        const float g = sigmoid_f(xp + zrh[(size_t)b * 2 * D + c]);
        if (c < D)
          rs[(size_t)b * D + c] = g * s[(size_t)b * D + c];
        else
          u[(size_t)b * D + (c - D)] = g;
      } else {
        xpc[(size_t)b * D + (c - 2 * D)] = xp;
      }
    }
  }
}

// step part 4: cand = tanh(xp_c + round(r * s) @ wh[:, 2D:]); the update,
// the mask hold, states[t] and s_prev[t].  Each thread reads and writes
// only its own carry entries and the product's operand is r * s, so the
// carry is updated in place.
template <typename CT>
__global__ void __launch_bounds__(THREADS) cand_kernel(
    const float* __restrict__ rs, const CT* __restrict__ wh,
    const float* __restrict__ xpc, const float* __restrict__ u,
    const float* __restrict__ mask_t, float* __restrict__ s,
    float* __restrict__ states_t, float* __restrict__ sprev_t, int B,
    int D) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_rs = [&](int b, int k) {
    return round_ct<CT>(rs[(size_t)b * D + k]);
  };
  tile_product(load_rs, wh + 2 * D, 3 * D, B, D, D, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= D) continue;
      const size_t o = (size_t)b * D + c;
      const float cand = tanhf(xpc[o] + acc[i][j]);
      const float sv = s[o], uu = u[o];
      const float sn = uu * sv + (1.0f - uu) * cand;
      const float m = mask_t[b];
      const float sk = m > 0.0f ? sn : sv;
      sprev_t[o] = sv;
      s[o] = sk;
      states_t[o] = sk * m;
    }
  }
}

#define PTT_CHECK(call)                              \
  do {                                               \
    const cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

template <typename CT>
int attn_dec_fwd_impl(const float* xp_y, const float* mask, const float* s0,
                      const CT* enc, const CT* enc_proj,
                      const float* src_mask, const CT* att_w,
                      const CT* att_v, const CT* wx_c, const CT* wh,
                      float* states, float* probs, CT* ctx, float* s_prev,
                      float* work, int T, int B, int S, int D, int A, int H2,
                      cudaStream_t stream) {
  if (T < 0 || B < 0 || S <= 0 || S > MAX_S || D <= 0 || A <= 0 || H2 <= 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return (int)cudaSuccess;
  const size_t bd = (size_t)B * D;
  float* s = work;                       // the carry         [B, D]
  float* q = s + bd;                     // query             [B, A]
  float* zrh = q + (size_t)B * A;        // round(s) @ wh_zr  [B, 2D]
  float* rs = zrh + 2 * bd;              // r * s             [B, D]
  float* u = rs + bd;                    // update gate       [B, D]
  float* xpc = u + bd;                   // xp[:, 2D:]        [B, D]
  PTT_CHECK(cudaMemcpyAsync(s, s0, bd * sizeof(float),
                            cudaMemcpyDeviceToDevice, stream));
  const int rows = (B + BM - 1) / BM;
  const dim3 block(THREADS);
  const dim3 grid_qg(((A > 2 * D ? A : 2 * D) + BN - 1) / BN, rows, 2);
  const dim3 grid_xp((3 * D + BN - 1) / BN, rows);
  const dim3 grid_c((D + BN - 1) / BN, rows);
  const size_t att_smem = (size_t)S * sizeof(float);
  for (int t = 0; t < T; ++t) {
    query_gate_kernel<CT><<<grid_qg, block, 0, stream>>>(s, att_w, wh, q,
                                                         zrh, B, D, A);
    PTT_CHECK(cudaGetLastError());
    CT* ctx_t = ctx + (size_t)t * B * H2;
    attention_kernel<CT><<<B, ATT_THREADS, att_smem, stream>>>(
        q, enc_proj, enc, src_mask, att_v, probs + (size_t)t * B * S, ctx_t,
        S, A, H2);
    PTT_CHECK(cudaGetLastError());
    xp_gate_kernel<CT><<<grid_xp, block, 0, stream>>>(
        ctx_t, wx_c, xp_y + (size_t)t * 3 * bd, zrh, s, rs, u, xpc, B, D, H2);
    PTT_CHECK(cudaGetLastError());
    cand_kernel<CT><<<grid_c, block, 0, stream>>>(
        rs, wh, xpc, u, mask + (size_t)t * B, s, states + t * bd,
        s_prev + t * bd, B, D);
    PTT_CHECK(cudaGetLastError());
  }
  return (int)cudaSuccess;
}

template <typename CT>
int attn_dec_fwd_entry(const void* xp_y, const void* mask, const void* s0,
                       const void* enc, const void* enc_proj,
                       const void* src_mask, const void* att_w,
                       const void* att_v, const void* wx_c, const void* wh,
                       void* states, void* probs, void* ctx, void* s_prev,
                       void* work, int T, int B, int S, int D, int A, int H2,
                       void* stream) {
  return attn_dec_fwd_impl<CT>(
      (const float*)xp_y, (const float*)mask, (const float*)s0,
      (const CT*)enc, (const CT*)enc_proj, (const float*)src_mask,
      (const CT*)att_w, (const CT*)att_v, (const CT*)wx_c, (const CT*)wh,
      (float*)states, (float*)probs, (CT*)ctx, (float*)s_prev, (float*)work,
      T, B, S, D, A, H2, (cudaStream_t)stream);
}

}  // namespace

// xp_y [T, B, 3D] f32, mask [T, B] f32, s0 [B, D] f32, enc [B, S, 2H],
// enc_proj [B, S, A], src_mask [B, S] f32, att_w [D, A], att_v [A],
// wx_c [2H, 3D], wh [D, 3D] (the last six in the compute type) ->
// states [T, B, D] f32, probs [T, B, S] f32, ctx [T, B, 2H] in the compute
// type, s_prev [T, B, D] f32; work is float32 scratch of B * (A + 6D).
// Returns a cudaError_t.
extern "C" int attn_dec_fwd_f32(const void* xp_y, const void* mask,
                                const void* s0, const void* enc,
                                const void* enc_proj, const void* src_mask,
                                const void* att_w, const void* att_v,
                                const void* wx_c, const void* wh,
                                void* states, void* probs, void* ctx,
                                void* s_prev, void* work, int T, int B, int S,
                                int D, int A, int H2, void* stream) {
  return attn_dec_fwd_entry<float>(xp_y, mask, s0, enc, enc_proj, src_mask,
                                   att_w, att_v, wx_c, wh, states, probs, ctx,
                                   s_prev, work, T, B, S, D, A, H2, stream);
}

extern "C" int attn_dec_fwd_bf16(const void* xp_y, const void* mask,
                                 const void* s0, const void* enc,
                                 const void* enc_proj, const void* src_mask,
                                 const void* att_w, const void* att_v,
                                 const void* wx_c, const void* wh,
                                 void* states, void* probs, void* ctx,
                                 void* s_prev, void* work, int T, int B,
                                 int S, int D, int A, int H2, void* stream) {
  return attn_dec_fwd_entry<bf16>(xp_y, mask, s0, enc, enc_proj, src_mask,
                                  att_w, att_v, wx_c, wh, states, probs, ctx,
                                  s_prev, work, T, B, S, D, A, H2, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

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
// needs the whole query row, so a step is a chain of four grid-wide
// dependencies, and the attention reads enc and enc_proj (96 KB a row,
// 37 MB a step) every step.
//
// Two kernels, picked by the wrapper from (compute type, B, S, D, A, 2H,
// SM count) alone (ops/kernels/attention_decoder.py::_attn_dec_fwd_path):
//
// attn_dec_fwd_persistent_kernel ("persistent", bf16 compute): the whole
//   loop in ONE cooperative launch (csrc/persistent.cuh), the weights
//   resident in shared memory split across the blocks.  Block i serves
//   column group i % CG: NU = 16 units j (all three gate columns of each
//   in wh and wx_c) and QC = 16 columns of att_w (160 KB of bf16 at the
//   training shape; _attn_dec_fwd_plan: 32 groups x 4 row groups = 128
//   blocks).  Its warps each own one 16-row tile, so a lane's accumulator
//   entries are the same (row, unit) pairs in every product, and the
//   carry s, the gate pre-activations zr_h and the gates stay in its
//   registers from phase to phase.  Four phases a step, each ended by a
//   grid barrier:
//     (1) [q | zr_h] = round(s) @ [att_w | wh[:, :2D]]; q to a global
//         [B, A] buffer;
//     (2) the attention of batch rows i, i + 128, ..., four at a time:
//         scores with lanes over 8 contiguous columns of enc_proj (16-byte
//         loads), one warp a (row, source position) pair, four pairs'
//         loads in flight; the masked softmax of each row in its own
//         warp; the context with each thread over 4 columns of enc, 16
//         positions' loads in flight; -> probs[t], ctx[t];
//     (3) xp = xp_y[t] + ctx @ wx_c, the gates r and u, round(r * s) to a
//         global bf16 buffer;
//     (4) round(r * s) @ wh[:, 2D:], the candidate, the update and the
//         mask hold; states[t], s_prev[t], round(s) to a global bf16
//         buffer.
//   The products run on the tensor cores: mma.sync m16n8k16, bf16 operands
//   (exact products), f32 accumulators, each lane's operand a 16-byte load
//   from L2, the weights kept in the B fragments' register order.  Each
//   output's k order depends on the widths alone and each row's attention
//   runs in one block, so a row's result does not depend on B.
// The "steps" path (f32 compute, or shapes the plan cannot take): the
//   time loop runs on the host in this file, four small kernels a step
//   (the launch boundary is the grid-wide barrier each needs):
//   query_gate_kernel  [q | zr_h] = round(s) @ [att_w | wh[:, :2D]], as two
//                      jobs of one launch (blockIdx.z)
//   attention_kernel   one block per batch row: scores (one warp per source
//                      position), the masked softmax (one warp), the
//                      context (one thread per column); enc / enc_proj are
//                      streamed from device memory
//   xp_gate_kernel     ctx @ wx_c, then xp, the gates r * s and u
//   cand_kernel        round(r * s) @ wh[:, 2D:], tanh, the update and the
//                      mask hold; writes states[t] and s_prev[t]
//   The weights stay in L2 across steps.  Each product block owns a 32 x
//   32 output tile and sums over k in a fixed order on the CUDA cores
//   (float32 FMAs on CT operands widened to float32, exact for bfloat16),
//   and every reduction of the attention runs in a fixed order, so a row's
//   result does not depend on B and repeated calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <math_constants.h>

#include "persistent.cuh"

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


// ------------------------------------- one persistent launch (bf16 policy)

namespace k5 {

constexpr int THREADS = 256;      // 8 warps, one 16-row tile of the products
constexpr int WARPS = THREADS / 32;
constexpr int ATT_ROWS = 4;       // batch rows the attention takes at once
constexpr size_t SMEM_LIMIT = 232448;

// the three products' B fragments (bf16) and the attention's f32 scratch:
// ATT_ROWS rows' weights and rounded queries, and att_v
inline size_t smem_bytes(int S, int D, int A, int H2, int NU, int QC) {
  return ((size_t)D * (QC + 2 * NU) + (size_t)H2 * 3 * NU +
          (size_t)D * NU) * 2 +
         ((size_t)ATT_ROWS * S + (size_t)(ATT_ROWS + 1) * A) * 4;
}

}  // namespace k5

// The decoder's whole time loop, bf16 compute.  Block i serves column group
// cg = i % CG (its NU = D / CG units and QC = A / CG query columns) and row
// group rg = i / CG (warp w takes the 16-row tile rg * tpg + w, tpg =
// ceil(ceil(B / 16) / RG) <= 8), and batch rows i, i + CG * RG, ... of the
// attention.  NU = 8 NUT and QC = 8 QCT.  q [B, A] f32, sb / rsb [B, D]
// bf16 scratch; bar [1] u32, zero.
template <int NUT, int QCT>
__global__ void __launch_bounds__(k5::THREADS, 1)
    attn_dec_fwd_persistent_kernel(
        const float* __restrict__ xp_y, const float* __restrict__ mask,
        const float* __restrict__ s0, const bf16* __restrict__ enc,
        const bf16* __restrict__ enc_proj, const float* __restrict__ src_mask,
        const bf16* __restrict__ att_w, const bf16* __restrict__ att_v,
        const bf16* __restrict__ wx_c, const bf16* __restrict__ wh,
        float* __restrict__ states, float* __restrict__ probs,
        bf16* __restrict__ ctx, float* __restrict__ s_prev,
        float* __restrict__ q, bf16* __restrict__ sb, bf16* __restrict__ rsb,
        unsigned* bar, int T, int B, int S, int D, int A, int H2, int CG,
        int RG) {
  constexpr int NU = 8 * NUT, QC = 8 * QCT;
  constexpr int NT1 = QCT + 2 * NUT, NT3 = 3 * NUT;
  extern __shared__ float4 smem4[];
  // B fragments [K / 16][NT][32 lanes] of the three products:
  // [q | zr] = round(s) @ [att_w | wh_r | wh_u], xp = ctx @ [wx_c r|u|c],
  // round(r s) @ wh_c, each over this block's columns
  uint2* wf1 = reinterpret_cast<uint2*>(smem4);
  uint2* wf3 = wf1 + (size_t)D / 16 * NT1 * 32;
  uint2* wf4 = wf3 + (size_t)H2 / 16 * NT3 * 32;
  // the attention's [ATT_ROWS][S] scores, then weights; its rows'
  // [ATT_ROWS][A] round(q); att_v [A]
  float* ws = reinterpret_cast<float*>(wf4 + (size_t)D / 16 * NUT * 32);
  float* qs = ws + k5::ATT_ROWS * S;
  float* vs = qs + k5::ATT_ROWS * A;
  const int cg = blockIdx.x % CG, rg = blockIdx.x / CG;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int D3 = 3 * D;

  // the weights' columns in B-fragment order (csrc/persistent.cuh)
  pk::pack_b_fragments(wf1, D, NT1, [&](int n, int& ld) {
    ld = n < QC ? A : D3;
    return n < QC ? att_w + cg * QC + n
                  : wh + (n - QC) / NU * D + cg * NU + (n - QC) % NU;
  });
  pk::pack_b_fragments(wf3, H2, NT3, [&](int n, int& ld) {
    ld = D3;
    return wx_c + n / NU * D + cg * NU + n % NU;
  });
  pk::pack_b_fragments(wf4, D, NUT, [&](int n, int& ld) {
    ld = D3;
    return wh + 2 * D + cg * NU + n;
  });
  for (int a = threadIdx.x; a < A; a += k5::THREADS)
    vs[a] = to_f(att_v[a]);

  // this warp's tile and its lane's entries: rows row0 + g + 8 (i / 2),
  // units cg NU + 8 ut + 2c + i % 2 (the mma accumulator's layout)
  const int ntile = (B + 15) / 16, tpg = (ntile + RG - 1) / RG;
  const int tile = rg * tpg + warp;
  const bool has = warp < tpg && tile < ntile;
  const int row0 = tile * 16;
  auto row_of = [&](int i) { return row0 + g + 8 * (i / 2); };
  auto unit_of = [&](int ut, int i) {
    return cg * NU + 8 * ut + 2 * c + i % 2;
  };
  float sr[NUT][4], zr_r[NUT][4], zr_u[NUT][4], ur[NUT][4], xpc[NUT][4];
#pragma unroll
  for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sr[ut][i] = 0.0f;
      const int b = row_of(i), j = unit_of(ut, i);
      if (has && b < B) {
        sr[ut][i] = s0[(size_t)b * D + j];
        sb[(size_t)b * D + j] = __float2bfloat16_rn(sr[ut][i]);
      }
    }
  unsigned target = 0;
  pk::grid_sync(bar, target);           // round(s0) complete

  for (int t = 0; t < T; ++t) {
    // (1) [q | zr_h] = round(s) @ [att_w | wh[:, :2D]]
    if (has) {
      float acc[NT1][4] = {};
      pk::warp_product(sb, D, row0, B, D, wf1, acc);
#pragma unroll
      for (int qt = 0; qt < QCT; ++qt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = row_of(i);
          if (b < B)
            q[(size_t)b * A + cg * QC + 8 * qt + 2 * c + i % 2] = acc[qt][i];
        }
      }
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          zr_r[ut][i] = acc[QCT + ut][i];
          zr_u[ut][i] = acc[QCT + NUT + ut][i];
        }
    }
    pk::grid_sync(bar, target);         // q complete

    // (2) the attention of this block's batch rows -> probs[t], ctx[t],
    // ATT_ROWS rows at a time (rows blockIdx.x + k gridDim.x)
    bf16* ctx_t = ctx + (size_t)t * B * H2;
    for (int k0 = 0; blockIdx.x + k0 * gridDim.x < B; k0 += k5::ATT_ROWS) {
      // rows br(0) .. br(nr - 1)
      const auto br = [&](int r) { return blockIdx.x + (k0 + r) * gridDim.x; };
      const int nr =
          min(k5::ATT_ROWS, (B - 1 - (int)blockIdx.x) / (int)gridDim.x - k0 + 1);
      for (int e = threadIdx.x; e < nr * A; e += k5::THREADS)
        qs[e] = round_ct<bf16>(__ldcg(q + (size_t)br(e / A) * A + e % A));
      __syncthreads();
      // scores: warp w takes (row, position) pairs w, w + 8, ..., four at
      // a time with their loads issued together; lane l the columns
      // 8 l .. 8 l + 7 of each 256, summed in column order, then across
      // the lanes
      for (int p0 = warp; p0 < nr * S; p0 += 4 * k5::WARPS) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int a0 = 8 * lane; a0 < A; a0 += 512) {
          uint4 raw[4][2];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int pr = p0 + p * k5::WARPS;
            const int row = pr < nr * S ? br(pr / S) : 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int a = a0 + 256 * h;
              raw[p][h] = pr < nr * S && a < A
                              ? __ldg(reinterpret_cast<const uint4*>(
                                    enc_proj + ((size_t)row * S + pr % S) * A
                                    + a))
                              : make_uint4(0u, 0u, 0u, 0u);
            }
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float* qr = qs + (p0 + p * k5::WARPS) / S * A;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int a = a0 + 256 * h;
              if (p0 + p * k5::WARPS >= nr * S || a >= A) continue;
              const bf16* e8 = reinterpret_cast<const bf16*>(&raw[p][h]);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float x = round_ct<bf16>(to_f(e8[i]) + qr[a + i]);
                part[p] += round_ct<bf16>(tanhf(x)) * vs[a + i];
              }
            }
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float v = warp_sum(part[p]);
          const int pr = p0 + p * k5::WARPS;
          if (lane == 0 && pr < nr * S) ws[pr] = v;
        }
      }
      __syncthreads();
      if (warp < nr) {                 // masked softmax of row `warp`
        float* w = ws + warp * S;
        const int b = br(warp);
        const float* mk = src_mask + (size_t)b * S;
        float mx = -CUDART_INF_F;
        for (int sp = lane; sp < S; sp += 32) {
          const float zz = mk[sp] > 0.0f ? w[sp] : -FLT_MAX;
          w[sp] = zz;
          mx = fmaxf(mx, zz);
        }
        mx = warp_max(mx);
        float sum = 0.0f;
        for (int sp = lane; sp < S; sp += 32) {
          const float e = expf(w[sp] - mx);
          w[sp] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        float nrm = 0.0f;
        for (int sp = lane; sp < S; sp += 32) {
          const float w1 = (w[sp] / sum) * mk[sp];
          w[sp] = w1;
          nrm += w1;
        }
        nrm = fmaxf(warp_sum(nrm), 1e-9f);
        for (int sp = lane; sp < S; sp += 32) {
          const float wv = w[sp] / nrm;
          w[sp] = round_ct<bf16>(wv);  // the context's operand
          probs[((size_t)t * B + b) * S + sp] = wv;
        }
      }
      __syncthreads();
      // the context: each thread 4 columns of a row at a time, over the
      // positions in order, 16 positions' loads issued together
      const int H4 = H2 / 4;
      for (int it = threadIdx.x; it < nr * H4; it += k5::THREADS) {
        const int r = it / H4, h = 4 * (it % H4);
        const bf16* eb = enc + (size_t)br(r) * S * H2 + h;
        const float* w = ws + r * S;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int sp0 = 0; sp0 < S; sp0 += 16) {
          uint2 raw[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            raw[u] = sp0 + u < S ? __ldg(reinterpret_cast<const uint2*>(
                                       eb + (size_t)(sp0 + u) * H2))
                                 : make_uint2(0u, 0u);
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            if (sp0 + u >= S) break;
            const bf16* e4 = reinterpret_cast<const bf16*>(&raw[u]);
            const float wr = w[sp0 + u];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i] += wr * to_f(e4[i]);
          }
        }
        bf16 o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i] = __float2bfloat16_rn(acc[i]);
        *reinterpret_cast<uint2*>(ctx_t + (size_t)br(r) * H2 + h) =
            *reinterpret_cast<const uint2*>(o);
      }
      __syncthreads();                 // qs and ws are free
    }
    pk::grid_sync(bar, target);         // ctx[t] complete

    // (3) xp = xp_y[t] + ctx @ wx_c; the gates r and u; round(r s)
    const float* xp_t = xp_y + (size_t)t * B * D3;
    if (has) {
      float xv[3][NUT][4];             // xp_y[t], loaded before the product
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int b = row_of(i);
            xv[gt][ut][i] = b < B ? xp_t[(size_t)b * D3 + gt * D
                                         + unit_of(ut, i)]
                                  : 0.0f;
          }
      float acc[NT3][4] = {};
      pk::warp_product(ctx_t, H2, row0, B, H2, wf3, acc);
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = row_of(i), j = unit_of(ut, i);
          if (b >= B) continue;
          const float r = sigmoid_f(xv[0][ut][i] + acc[ut][i] + zr_r[ut][i]);
          ur[ut][i] =
              sigmoid_f(xv[1][ut][i] + acc[NUT + ut][i] + zr_u[ut][i]);
          xpc[ut][i] = xv[2][ut][i] + acc[2 * NUT + ut][i];
          rsb[(size_t)b * D + j] = __float2bfloat16_rn(r * sr[ut][i]);
        }
    }
    pk::grid_sync(bar, target);         // round(r s) complete

    // (4) cand = tanh(xp_c + round(r s) @ wh[:, 2D:]); the update and hold
    if (has) {
      const float mv[2] = {row_of(0) < B ? mask[(size_t)t * B + row_of(0)]
                                         : 0.0f,
                           row_of(2) < B ? mask[(size_t)t * B + row_of(2)]
                                         : 0.0f};
      float acc[NUT][4] = {};
      pk::warp_product(rsb, D, row0, B, D, wf4, acc);
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = row_of(i), j = unit_of(ut, i);
          if (b >= B) continue;
          const size_t o = ((size_t)t * B + b) * D + j;
          const float cand = tanhf(xpc[ut][i] + acc[ut][i]);
          const float sv = sr[ut][i], uu = ur[ut][i];
          const float sn = uu * sv + (1.0f - uu) * cand;
          const float m = mv[i / 2];
          const float sk = m > 0.0f ? sn : sv;
          s_prev[o] = sv;
          states[o] = sk * m;
          sr[ut][i] = sk;
          sb[(size_t)b * D + j] = __float2bfloat16_rn(sk);
        }
    }
    if (t + 1 < T) pk::grid_sync(bar, target);  // round(s) complete
  }
}

int attn_dec_fwd_persistent_launch(
    const float* xp_y, const float* mask, const float* s0, const bf16* enc,
    const bf16* enc_proj, const float* src_mask, const bf16* att_w,
    const bf16* att_v, const bf16* wx_c, const bf16* wh, float* states,
    float* probs, bf16* ctx, float* s_prev, float* q, bf16* sb, bf16* rsb,
    unsigned* bar, int T, int B, int S, int D, int A, int H2, int CG, int RG,
    cudaStream_t stream) {
  if (T < 0 || B < 0 || S <= 0 || S > MAX_S || D <= 0 || A <= 0 || H2 <= 0 ||
      CG <= 0 || RG <= 0)
    return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0) return (int)cudaSuccess;
  const int NU = D / CG, QC = A / CG;
  if (D % CG || A % CG || (NU != 8 && NU != 16) || (QC != 8 && QC != 16) ||
      D % 32 || H2 % 32 || (B + 15) / 16 > RG * k5::WARPS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k5::smem_bytes(S, D, A, H2, NU, QC);
  if (smem > k5::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  void* args[] = {&xp_y,  &mask,  &s0,     &enc, &enc_proj, &src_mask,
                  &att_w, &att_v, &wx_c,   &wh,  &states,   &probs,
                  &ctx,   &s_prev, &q,     &sb,  &rsb,      &bar,
                  &T,     &B,     &S,      &D,   &A,        &H2,
                  &CG,    &RG};
  const auto launch = [&](auto kernel) {
    return pk::cooperative_launch(kernel, args, CG * RG, k5::THREADS, smem,
                                  stream);
  };
  if (NU == 16)
    return QC == 16 ? launch(attn_dec_fwd_persistent_kernel<2, 2>)
                    : launch(attn_dec_fwd_persistent_kernel<2, 1>);
  return QC == 16 ? launch(attn_dec_fwd_persistent_kernel<1, 2>)
                  : launch(attn_dec_fwd_persistent_kernel<1, 1>);
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

// The persistent kernel (see _attn_dec_fwd_path / _attn_dec_fwd_plan),
// bf16 compute only: the arguments of attn_dec_fwd_bf16 up to s_prev, then
// q [B, A] f32, sb and rsb [B, D] bf16 scratch, bar [1] u32 zeroed, the
// sizes, and the plan's CG column groups (D / CG and A / CG each 8 or 16)
// and RG row groups (CG * RG blocks; B <= 128 RG).
extern "C" int attn_dec_fwd_persistent(
    const void* xp_y, const void* mask, const void* s0, const void* enc,
    const void* enc_proj, const void* src_mask, const void* att_w,
    const void* att_v, const void* wx_c, const void* wh, void* states,
    void* probs, void* ctx, void* s_prev, void* q, void* sb, void* rsb,
    void* bar, int T, int B, int S, int D, int A, int H2, int CG, int RG,
    void* stream) {
  return attn_dec_fwd_persistent_launch(
      (const float*)xp_y, (const float*)mask, (const float*)s0,
      (const bf16*)enc, (const bf16*)enc_proj, (const float*)src_mask,
      (const bf16*)att_w, (const bf16*)att_v, (const bf16*)wx_c,
      (const bf16*)wh, (float*)states, (float*)probs, (bf16*)ctx,
      (float*)s_prev, (float*)q, (bf16*)sb, (bf16*)rsb, (unsigned*)bar, T, B,
      S, D, A, H2, CG, RG, (cudaStream_t)stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: persistent with 16 units and 16 query
// columns a block, the flagship's plan, at (S, D, A, H2); 1: the steps
// path's attention kernel, bf16; 2: its candidate product, bf16)
extern "C" int attn_dec_fwd_info(int which, int S, int D, int A, int H2,
                                 int* regs, int* local_bytes,
                                 int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn = which == 0 ? (const void*)attn_dec_fwd_persistent_kernel<2, 2>
                   : which == 1 ? (const void*)attention_kernel<bf16>
                                : (const void*)cand_kernel<bf16>;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k5::smem_bytes(S, D, A, H2, 16, 16) : 0);
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

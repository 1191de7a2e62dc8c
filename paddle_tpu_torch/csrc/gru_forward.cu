// GRU forward time loop for Hopper (sm_90a), with or without the backward's
// residual outputs.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_pallas_raw (the
// _gru_kernel body, batch_split=0; residuals=False for inference,
// residuals=True for training), which the encoder reaches through
// ops/rnn_fused.py::_gru_core_fwd.
//
// Computes, for t = 0 .. T-1 over a time-major batch (gate order [r, u, c],
// r applied to h BEFORE the candidate product, as ops/rnn.py::gru_step):
//     zr     = xp[t, :, :2H] + round(h) @ W[:, :2H]
//     r, u   = sigmoid(zr[:, :H]), sigmoid(zr[:, H:])
//     zc     = xp[t, :, 2H:] + round(r * h) @ W[:, 2H:]
//     h_new  = u * h + (1 - u) * tanh(zc)
//     h      = mask[t] > 0 ? h_new : h          (masked steps hold the carry)
//     h_seq[t] = h * mask[t]                    (and emit zero)
// round() is the cast of a matmul operand to the compute type (CT: float or
// bfloat16); products accumulate in float32 and the carry stays float32.
// With residuals (training), each step also stores, in the residual type RT
// (ops/rnn_fused.py::residual_dtype), where _gru_kernel stores them:
//     z[t]      = [zr, zc]   the pre-activations           [B, 3H]
//     h_prev[t] = h          the carry entering the step   [B, H]
//
// What bounds it on this card: the recurrence is sequential over T and each
// step has a row-wide dependency -- (r*h) @ W_c needs the whole r row.  At
// the serving shape (B <= 64, H = 512, T = 32) one step is 0.1 GFLOP and
// reads W (1.5 MB in bf16, resident in the 50 MB L2 after the first step),
// so the loop is bound by the latency of 2T dependent kernel launches, far
// above both the byte and the FLOP bound of the whole call.
//
// Design: two small kernels per step, launched from a host loop over T in
// this file (one library call per direction):
//   gru_gates_kernel   the [B, 2H] gate product + sigmoid -> r*h, u
//   gru_cand_kernel    the [B, H] candidate product + tanh + update + mask
// The launch boundary is the grid-wide barrier the row dependency needs; a
// cooperative persistent kernel with two grid syncs per step is the faster
// alternative for a later change.  Each block computes a 32 x 32 output tile
// with a shared-memory tiled product over k in a FIXED order, so a row's
// arithmetic never depends on B: a merged prefill and a solo one give the
// same rows bit for bit.  The residual stores add 8 bytes (bf16) per
// carry element a step to a loop that is bound by launch latency, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // batch rows per block
constexpr int BN = 32;        // output columns per block
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 2 x 2 patch

template <typename CT>
__device__ __forceinline__ float to_f(CT x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the operand cast of the reference (astype(compute dtype)), round to
// nearest even, widened back for the float32 multiply-add
template <typename CT>
__device__ __forceinline__ float round_ct(float x);
template <>
__device__ __forceinline__ float round_ct<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_ct<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a residual store in the residual type (round to nearest even)
template <typename RT>
__device__ __forceinline__ RT to_rt(float x);
template <>
__device__ __forceinline__ float to_rt<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_rt<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[i][j] = sum_k round(A[row, k]) * W[k, col] for the block's BM x BN
// tile.  A is [B, H] float32 (row stride H); W points at the first column
// of the product's column range, row stride ldw, ncols columns in range.
template <typename CT>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, const CT* __restrict__ W, int B, int H,
    int ldw, int ncols, int row0, int col0, float acc[2][2]) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      As[r][c] = (gr < B && gk < H) ? round_ct<CT>(A[(size_t)gr * H + gk])
                                    : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      Ws[r][c] = (gk < H && gc < ncols) ? to_f<CT>(W[(size_t)gk * ldw + gc])
                                        : 0.0f;
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

// step part 1: zr = xp[:, :2H] + round(h) @ W[:, :2H]; writes r*h and u,
// and (z_t non-null) the residuals zr and h_prev
template <typename CT, typename RT>
__global__ void __launch_bounds__(THREADS) gru_gates_kernel(
    const float* __restrict__ xp_t, const CT* __restrict__ W,
    const float* __restrict__ h, float* __restrict__ rh,
    float* __restrict__ u, RT* __restrict__ z_t, RT* __restrict__ hp_t,
    int B, int H) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  tile_product<CT>(h, W, B, H, 3 * H, 2 * H, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= 2 * H) continue;
      const float zr = xp_t[(size_t)b * 3 * H + c] + acc[i][j];
      const float g = sigmoid_f(zr);
      if (z_t != nullptr) z_t[(size_t)b * 3 * H + c] = to_rt<RT>(zr);
      if (c < H) {
        const float hv = h[(size_t)b * H + c];
        rh[(size_t)b * H + c] = g * hv;
        if (hp_t != nullptr) hp_t[(size_t)b * H + c] = to_rt<RT>(hv);
      } else {
        u[(size_t)b * H + (c - H)] = g;
      }
    }
  }
}

// step part 2: zc = xp[:, 2H:] + round(r*h) @ W[:, 2H:]; the update, the
// mask hold, and h_seq[t].  Each thread reads and writes only its own h
// entries, and the product's operand is r*h, so updating h in place is safe.
// (z_t non-null) also stores the residual zc.
template <typename CT, typename RT>
__global__ void __launch_bounds__(THREADS) gru_cand_kernel(
    const float* __restrict__ xp_t, const float* __restrict__ mask_t,
    const CT* __restrict__ W, const float* __restrict__ rh,
    const float* __restrict__ u, float* __restrict__ h,
    float* __restrict__ hseq_t, RT* __restrict__ z_t, int B, int H) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  tile_product<CT>(rh, W + 2 * H, B, H, 3 * H, H, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= H) continue;
      const size_t o = (size_t)b * H + c;
      const float zc = xp_t[(size_t)b * 3 * H + 2 * H + c] + acc[i][j];
      const float cand = tanhf(zc);
      if (z_t != nullptr) z_t[(size_t)b * 3 * H + 2 * H + c] = to_rt<RT>(zc);
      const float hp = h[o], uu = u[o];
      const float hn = uu * hp + (1.0f - uu) * cand;
      const float m = mask_t[b];
      const float hk = m > 0.0f ? hn : hp;
      h[o] = hk;
      hseq_t[o] = hk * m;
    }
  }
}

template <typename CT, typename RT>
int gru_forward_impl(const float* xp, const float* mask, const CT* w,
                     float* h_seq, float* h, float* rh, float* u, RT* z,
                     RT* hprev, int T, int B, int H, cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 block(THREADS);
  const dim3 grid_g((2 * H + BN - 1) / BN, (B + BM - 1) / BM);
  const dim3 grid_c((H + BN - 1) / BN, (B + BM - 1) / BM);
  const size_t xs = (size_t)B * 3 * H, hs = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    RT* z_t = z == nullptr ? nullptr : z + t * xs;
    RT* hp_t = hprev == nullptr ? nullptr : hprev + t * hs;
    gru_gates_kernel<CT, RT><<<grid_g, block, 0, stream>>>(
        xp + t * xs, w, h, rh, u, z_t, hp_t, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gru_cand_kernel<CT, RT><<<grid_c, block, 0, stream>>>(
        xp + t * xs, mask + (size_t)t * B, w, rh, u, h, h_seq + t * hs, z_t,
        B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// residual type by flag: z == nullptr (inference) stores no residuals
template <typename CT>
int gru_forward_dispatch(const void* xp, const void* mask, const void* w,
                         void* h_seq, void* h, void* rh, void* u, void* z,
                         void* hprev, int res_bf16, int T, int B, int H,
                         void* stream) {
  if ((z == nullptr) != (hprev == nullptr)) return (int)cudaErrorInvalidValue;
  if (res_bf16) {
    return gru_forward_impl<CT, __nv_bfloat16>(
        (const float*)xp, (const float*)mask, (const CT*)w, (float*)h_seq,
        (float*)h, (float*)rh, (float*)u, (__nv_bfloat16*)z,
        (__nv_bfloat16*)hprev, T, B, H, (cudaStream_t)stream);
  }
  return gru_forward_impl<CT, float>(
      (const float*)xp, (const float*)mask, (const CT*)w, (float*)h_seq,
      (float*)h, (float*)rh, (float*)u, (float*)z, (float*)hprev, T, B, H,
      (cudaStream_t)stream);
}

}  // namespace

// xp [T, B, 3H] f32, mask [T, B] f32, w [H, 3H] in the compute type,
// h_seq [T, B, H] f32 out, h [B, H] f32 in: h0, out: h_final,
// rh / u [B, H] f32 scratch; z [T, B, 3H] and hprev [T, B, H] residual
// outputs in bfloat16 (res_bf16 != 0) or float32, both null for
// inference.  Returns a cudaError_t.
extern "C" int gru_forward_f32(const void* xp, const void* mask,
                               const void* w, void* h_seq, void* h, void* rh,
                               void* u, void* z, void* hprev, int res_bf16,
                               int T, int B, int H, void* stream) {
  return gru_forward_dispatch<float>(xp, mask, w, h_seq, h, rh, u, z, hprev,
                                     res_bf16, T, B, H, stream);
}

extern "C" int gru_forward_bf16(const void* xp, const void* mask,
                                const void* w, void* h_seq, void* h, void* rh,
                                void* u, void* z, void* hprev, int res_bf16,
                                int T, int B, int H, void* stream) {
  return gru_forward_dispatch<__nv_bfloat16>(xp, mask, w, h_seq, h, rh, u, z,
                                             hprev, res_bf16, T, B, H,
                                             stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared by the GRU time loops: gru_forward.cu (K3) and gru_backward.cu
// (K4), one direction over B rows, and bigru_forward.cu / bigru_backward.cu
// (K11), both directions over a stacked batch of 2 x split rows.
//
// Forward step (t = 0 .. T-1, gate order [r, u, c], r applied to h BEFORE
// the candidate product, as ops/rnn.py::gru_step):
//     zr     = xp[t, :, :2H] + round(h) @ W[:, :2H]
//     r, u   = sigmoid(zr[:, :H]), sigmoid(zr[:, H:])
//     zc     = xp[t, :, 2H:] + round(r * h) @ W[:, 2H:]
//     h_new  = u * h + (1 - u) * tanh(zc)
//     h      = mask[t] > 0 ? h_new : h          (masked steps hold the carry)
//     h_seq[t] = h * mask[t]                    (and emit zero)
// round() is the cast of a matmul operand to the compute type (CT: float or
// bfloat16); products accumulate in float32 and the carry stays float32.
// With residuals (training) each step also stores, in the residual type RT,
// z[t] = [zr, zc] and h_prev[t] = h (the carry entering the step).
//
// Reverse step (t = T-1 .. 0), from those residuals and the carry
// cotangent d_c (seeded by d_hfin), with f32 products against the
// transposed weight w_t:
//     r, u = sigmoid(zr[:, :H]), sigmoid(zr[:, H:]);  cand = tanh(zc)
//     m      = mask[t] > 0 ? 1 : 0
//     d_hnew = m * (d_out[t] + d_c)
//     d_u    = d_hnew * (h_prev - cand)
//     d_zc   = d_hnew * (1 - u) * (1 - cand * cand)
//     d_rh   = d_zc @ W[:, 2H:]^T
//     d_zr   = [d_rh * h_prev * r * (1 - r),  d_u * u * (1 - u)]
//     d_hp   = d_hnew * u + d_rh * r + d_zr @ W[:, :2H]^T
//     d_c    = (1 - m) * d_c + d_hp
//     d_z[t] = [d_zr, d_zc]
//
// Two small kernels a step, from a host loop (the launch boundary is the
// grid-wide barrier each step's row-wide products need).  Each block owns
// a 32 x 32 output tile and sums over k in a FIXED order, so a row's bits
// depend only on that row's inputs and its direction's weight: never on B,
// nor on which other rows share the call.
//
// The bidirectional batch (split > 0, B = 2 * split): rows [0, split) use
// direction 0's weight and rows [split, B) direction 1's.  The grid's row
// blocks are cut per direction -- ceil(split / BM) blocks over [0, split),
// then as many over [split, B) -- so no 32-row tile straddles the split for
// any split, and each row meets exactly the arithmetic of a one-direction
// call (K11 against two K3/K4 calls is bit-identical).  The forward's
// weight is the reference's [2H, 3H] (direction 1 starts H * 3H elements
// in); the reverse's is the reference's column-stacked [3H, 2H] (direction
// 1 starts H columns in, row stride 2H).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace gru {

constexpr int BM = 32;        // batch rows per block
constexpr int BN = 32;        // output columns per block
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 2 x 2 patch

template <typename T>
__device__ __forceinline__ float to_f(T x);
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

// The rows of this block: [row0, row_end) and the direction whose weight
// they use.  split == 0: one direction over [0, B).
struct RowBlock {
  int row0, row_end, dir;
};

__device__ __forceinline__ RowBlock row_block(int B, int split) {
  const int by = blockIdx.y;
  if (split == 0) return {by * BM, B, 0};
  const int nb = (split + BM - 1) / BM;
  if (by < nb) return {by * BM, split, 0};
  return {split + (by - nb) * BM, B, 1};
}

inline int row_blocks(int B, int split) {
  return split == 0 ? (B + BM - 1) / BM : 2 * ((split + BM - 1) / BM);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// acc[i][j] = sum_k round(A[row, k]) * W[k, col] for the block's BM x BN
// tile.  A is [*, H] float32 (row stride H), rows below row_end are real;
// W points at the first column of the product's column range, row stride
// ldw, ncols columns in range.
template <typename CT>
__device__ __forceinline__ void fwd_tile_product(
    const float* __restrict__ A, const CT* __restrict__ W, int row_end,
    int H, int ldw, int ncols, int row0, int col0, float acc[2][2]) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      As[r][c] = (gr < row_end && gk < H)
                     ? round_ct<CT>(A[(size_t)gr * H + gk])
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
// and (z_t non-null) the residuals zr and h_prev.  W is [H, 3H] per
// direction, direction 1's at W + H * 3H.
template <typename CT, typename RT>
__global__ void __launch_bounds__(THREADS) gru_gates_kernel(
    const float* __restrict__ xp_t, const CT* __restrict__ W,
    const float* __restrict__ h, float* __restrict__ rh,
    float* __restrict__ u, RT* __restrict__ z_t, RT* __restrict__ hp_t,
    int B, int H, int split) {
  const RowBlock rb = row_block(B, split);
  const int col0 = blockIdx.x * BN;
  const CT* Wd = W + (size_t)rb.dir * H * 3 * H;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  fwd_tile_product<CT>(h, Wd, rb.row_end, H, 3 * H, 2 * H, rb.row0, col0,
                       acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = rb.row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= rb.row_end || c >= 2 * H) continue;
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
    float* __restrict__ hseq_t, RT* __restrict__ z_t, int B, int H,
    int split) {
  const RowBlock rb = row_block(B, split);
  const int col0 = blockIdx.x * BN;
  const CT* Wd = W + (size_t)rb.dir * H * 3 * H;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  fwd_tile_product<CT>(rh, Wd + 2 * H, rb.row_end, H, 3 * H, H, rb.row0,
                       col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = rb.row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= rb.row_end || c >= H) continue;
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
int forward_loop(const float* xp, const float* mask, const CT* w,
                 float* h_seq, float* h, float* rh, float* u, RT* z,
                 RT* hprev, int T, int B, int H, int split,
                 cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0 || split < 0) return (int)cudaErrorInvalidValue;
  if (split > 0 && B != 2 * split) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 block(THREADS);
  const int nrb = row_blocks(B, split);
  const dim3 grid_g((2 * H + BN - 1) / BN, nrb);
  const dim3 grid_c((H + BN - 1) / BN, nrb);
  const size_t xs = (size_t)B * 3 * H, hs = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    RT* z_t = z == nullptr ? nullptr : z + t * xs;
    RT* hp_t = hprev == nullptr ? nullptr : hprev + t * hs;
    gru_gates_kernel<CT, RT><<<grid_g, block, 0, stream>>>(
        xp + t * xs, w, h, rh, u, z_t, hp_t, B, H, split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gru_cand_kernel<CT, RT><<<grid_c, block, 0, stream>>>(
        xp + t * xs, mask + (size_t)t * B, w, rh, u, h, h_seq + t * hs, z_t,
        B, H, split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// residual type by flag: z == nullptr (inference) stores no residuals
template <typename CT>
int forward_dispatch(const void* xp, const void* mask, const void* w,
                     void* h_seq, void* h, void* rh, void* u, void* z,
                     void* hprev, int res_bf16, int T, int B, int H,
                     int split, void* stream) {
  if ((z == nullptr) != (hprev == nullptr)) return (int)cudaErrorInvalidValue;
  if (res_bf16) {
    return forward_loop<CT, __nv_bfloat16>(
        (const float*)xp, (const float*)mask, (const CT*)w, (float*)h_seq,
        (float*)h, (float*)rh, (float*)u, (__nv_bfloat16*)z,
        (__nv_bfloat16*)hprev, T, B, H, split, (cudaStream_t)stream);
  }
  return forward_loop<CT, float>(
      (const float*)xp, (const float*)mask, (const CT*)w, (float*)h_seq,
      (float*)h, (float*)rh, (float*)u, (float*)z, (float*)hprev, T, B, H,
      split, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// reverse
// ---------------------------------------------------------------------------

// d_zc[b, k] and its inputs for one carry element (b, k) of step t
struct CandGrad {
  float d_hnew, u, cand, d_zc;
};

template <typename RT>
__device__ __forceinline__ CandGrad cand_grad(
    const float* __restrict__ dout_t, float m, const RT* __restrict__ z_t,
    const float* __restrict__ dc, int b, int k, int H) {
  CandGrad g;
  const float mcol = m > 0.0f ? 1.0f : 0.0f;
  g.d_hnew = mcol * (dout_t[(size_t)b * H + k] + dc[(size_t)b * H + k]);
  g.u = sigmoid_f(to_f<RT>(z_t[(size_t)b * 3 * H + H + k]));
  g.cand = tanhf(to_f<RT>(z_t[(size_t)b * 3 * H + 2 * H + k]));
  g.d_zc = g.d_hnew * (1.0f - g.u) * (1.0f - g.cand * g.cand);
  return g;
}

// acc[i][j] += sum_k A(row, k) * w_t[k0w + k, col] over k < K for the
// block's BM x BN tile; A is produced by load_a(row, k) (0 outside),
// rows below row_end are real; w_t is float32 with row stride ldw and H
// columns in range.
template <typename LoadA>
__device__ __forceinline__ void bwd_tile_product(
    LoadA load_a, const float* __restrict__ w_t, int ldw, int k0w, int K,
    int row_end, int H, int row0, int col0, float acc[2][2]) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      As[r][c] = (gr < row_end && gk < K) ? load_a(gr, gk) : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      Ws[r][c] = (gk < K && gc < H) ? w_t[(size_t)(k0w + gk) * ldw + gc]
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

// w_t holds one direction's [3H, H] (split == 0, row stride H) or both
// directions' column-stacked [3H, 2H] (split > 0, row stride 2H, direction
// 1 at column H)
__device__ __forceinline__ const float* dir_w_t(const float* w_t,
                                                const RowBlock& rb, int H,
                                                int split, int* ldw) {
  *ldw = split == 0 ? H : 2 * H;
  return w_t + (size_t)rb.dir * H;
}

// step part 1: d_rh = d_zc @ W_c^T; writes d_z[t] (all three blocks) and
// part = d_hnew * u + d_rh * r
template <typename RT>
__global__ void __launch_bounds__(THREADS) gru_bwd_cand_kernel(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const RT* __restrict__ z_t, const RT* __restrict__ hp_t,
    const float* __restrict__ w_t, const float* __restrict__ dc,
    float* __restrict__ dz_t, float* __restrict__ part, int B, int H,
    int split) {
  const RowBlock rb = row_block(B, split);
  const int col0 = blockIdx.x * BN;
  int ldw;
  const float* wd = dir_w_t(w_t, rb, H, split, &ldw);
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dzc = [&](int b, int k) {
    return cand_grad<RT>(dout_t, mask_t[b], z_t, dc, b, k, H).d_zc;
  };
  bwd_tile_product(load_dzc, wd, ldw, 2 * H, H, rb.row_end, H, rb.row0, col0,
                   acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = rb.row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= rb.row_end || c >= H) continue;
      const CandGrad g = cand_grad<RT>(dout_t, mask_t[b], z_t, dc, b, c, H);
      const float hp = to_f<RT>(hp_t[(size_t)b * H + c]);
      const float r = sigmoid_f(to_f<RT>(z_t[(size_t)b * 3 * H + c]));
      const float d_u = g.d_hnew * (hp - g.cand);
      const float d_rh = acc[i][j];
      const float d_r = d_rh * hp;
      float* dz = dz_t + (size_t)b * 3 * H;
      dz[c] = d_r * r * (1.0f - r);
      dz[H + c] = d_u * g.u * (1.0f - g.u);
      dz[2 * H + c] = g.d_zc;
      part[(size_t)b * H + c] = g.d_hnew * g.u + d_rh * r;
    }
  }
}

// step part 2: d_hp = part + d_zr @ W_g^T; d_c = (1 - m) * d_c + d_hp.
// Each thread reads and writes only its own d_c entries (the product's
// operand is d_z[t]), so the carry is updated in place.
__global__ void __launch_bounds__(THREADS) gru_bwd_gate_kernel(
    const float* __restrict__ mask_t, const float* __restrict__ dz_t,
    const float* __restrict__ w_t, const float* __restrict__ part,
    float* __restrict__ dc, int B, int H, int split) {
  const RowBlock rb = row_block(B, split);
  const int col0 = blockIdx.x * BN;
  int ldw;
  const float* wd = dir_w_t(w_t, rb, H, split, &ldw);
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dzr = [&](int b, int k) { return dz_t[(size_t)b * 3 * H + k]; };
  bwd_tile_product(load_dzr, wd, ldw, 0, 2 * H, rb.row_end, H, rb.row0, col0,
                   acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = rb.row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= rb.row_end || c >= H) continue;
      const size_t o = (size_t)b * H + c;
      const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
      const float d_hp = part[o] + acc[i][j];
      dc[o] = (1.0f - mcol) * dc[o] + d_hp;
    }
  }
}

template <typename RT>
int backward_loop(const float* dout, const float* mask, const RT* z,
                  const RT* hprev, const float* w_t, float* dz, float* dc,
                  float* part, int T, int B, int H, int split,
                  cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0 || split < 0) return (int)cudaErrorInvalidValue;
  if (split > 0 && B != 2 * split) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 block(THREADS);
  const dim3 grid((H + BN - 1) / BN, row_blocks(B, split));
  const size_t zs = (size_t)B * 3 * H, hs = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_cand_kernel<RT><<<grid, block, 0, stream>>>(
        dout + t * hs, mask + (size_t)t * B, z + t * zs, hprev + t * hs, w_t,
        dc, dz + t * zs, part, B, H, split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gru_bwd_gate_kernel<<<grid, block, 0, stream>>>(
        mask + (size_t)t * B, dz + t * zs, w_t, part, dc, B, H, split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

inline int backward_dispatch(const void* dout, const void* mask,
                             const void* z, const void* hprev,
                             const void* w_t, void* dz, void* dc, void* part,
                             int res_bf16, int T, int B, int H, int split,
                             void* stream) {
  if (res_bf16) {
    return backward_loop<__nv_bfloat16>(
        (const float*)dout, (const float*)mask, (const __nv_bfloat16*)z,
        (const __nv_bfloat16*)hprev, (const float*)w_t, (float*)dz,
        (float*)dc, (float*)part, T, B, H, split, (cudaStream_t)stream);
  }
  return backward_loop<float>(
      (const float*)dout, (const float*)mask, (const float*)z,
      (const float*)hprev, (const float*)w_t, (float*)dz, (float*)dc,
      (float*)part, T, B, H, split, (cudaStream_t)stream);
}

}  // namespace gru

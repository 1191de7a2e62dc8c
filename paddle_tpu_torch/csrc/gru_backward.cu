// GRU backward time loop (the reverse recurrence) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_gru_bwd_pallas_raw (the
// _gru_bwd_kernel body, batch_split=0), which the encoder's backward
// reaches through ops/rnn_fused.py::_gru_seq_bwd.
//
// Computes, for t = T-1 .. 0 over a time-major batch, from the forward's
// residuals z[t] = [zr, zc] and h_prev[t] (stored in RT: float or bfloat16,
// widened to float32 here), the carry cotangent d_c (seeded by d_hfin):
//     r, u = sigmoid(zr[:, :H]), sigmoid(zr[:, H:]);  cand = tanh(zc)
//     m      = mask[t] > 0 ? 1 : 0
//     d_hnew = m * (d_out[t] + d_c)
//     d_u    = d_hnew * (h_prev - cand)
//     d_zc   = d_hnew * (1 - u) * (1 - cand * cand)
//     d_rh   = d_zc @ W[:, 2H:]^T                      (f32 product)
//     d_zr   = [d_rh * h_prev * r * (1 - r),  d_u * u * (1 - u)]
//     d_hp   = d_hnew * u + d_rh * r + d_zr @ W[:, :2H]^T   (f32 product)
//     d_c    = (1 - m) * d_c + d_hp
//     d_z[t] = [d_zr, d_zc]
// and returns d_h0 = d_c after step 0.  The products take the transposed
// float32 weight w_t [3H, H] (= W^T), as the reference does (f32 operands,
// the backward's deliberate accumulation policy: ops/numerics.py::bwd_mm).
//
// What bounds it on this card: as in the forward, the loop is sequential
// over T and each step has two dependent row-wide products (d_rh needs the
// whole d_zc row; the second product needs the whole d_zr row).  At the
// training shape (B = 384, H = 512, T = 32) a step is 0.6 GFLOP of f32
// products and reads w_t (3 MB, resident in the 50 MB L2 after the first
// step); the whole call's bound is ~0.3 ms of f32 FMA time, and it runs as
// 2T dependent launches, so launch latency and per-block k-loops bound it.
//
// Design: two small kernels per step from a host loop in this file (the
// launch boundary is the grid-wide barrier each product needs):
//   gru_bwd_cand_kernel  d_rh = d_zc @ W_c^T, with d_zc formed elementwise
//                        while its tile is loaded (it is never stored
//                        before the product); the epilogue writes all
//                        three gate blocks of d_z[t] and the partial
//                        d_hnew * u + d_rh * r
//   gru_bwd_gate_kernel  d_zr @ W_g^T from the d_z[t] just written, then
//                        the carry update d_c = (1 - m) d_c + d_hp
// Each block owns a 32 x 32 output tile and sums over k in a fixed order,
// so a row's result does not depend on B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;        // batch rows per block
constexpr int BN = 32;        // output columns per block
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 2 x 2 patch

template <typename RT>
__device__ __forceinline__ float to_f(RT x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

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
// block's BM x BN tile; A is produced by load_a(row, k) (0 outside), w_t is
// [*, H] float32 (row stride H).
template <typename LoadA>
__device__ __forceinline__ void tile_product(LoadA load_a,
                                             const float* __restrict__ w_t,
                                             int k0w, int K, int B, int H,
                                             int row0, int col0,
                                             float acc[2][2]) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gk = k0 + c;
      As[r][c] = (gr < B && gk < K) ? load_a(gr, gk) : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gc = col0 + c;
      Ws[r][c] = (gk < K && gc < H) ? w_t[(size_t)(k0w + gk) * H + gc]
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

// step part 1: d_rh = d_zc @ W_c^T; writes d_z[t] (all three blocks) and
// part = d_hnew * u + d_rh * r
template <typename RT>
__global__ void __launch_bounds__(THREADS) gru_bwd_cand_kernel(
    const float* __restrict__ dout_t, const float* __restrict__ mask_t,
    const RT* __restrict__ z_t, const RT* __restrict__ hp_t,
    const float* __restrict__ w_t, const float* __restrict__ dc,
    float* __restrict__ dz_t, float* __restrict__ part, int B, int H) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dzc = [&](int b, int k) {
    return cand_grad<RT>(dout_t, mask_t[b], z_t, dc, b, k, H).d_zc;
  };
  tile_product(load_dzc, w_t, 2 * H, H, B, H, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= H) continue;
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
    float* __restrict__ dc, int B, int H) {
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  auto load_dzr = [&](int b, int k) { return dz_t[(size_t)b * 3 * H + k]; };
  tile_product(load_dzr, w_t, 0, 2 * H, B, H, row0, col0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = row0 + ty * 2 + i, c = col0 + tx + 16 * j;
      if (b >= B || c >= H) continue;
      const size_t o = (size_t)b * H + c;
      const float mcol = mask_t[b] > 0.0f ? 1.0f : 0.0f;
      const float d_hp = part[o] + acc[i][j];
      dc[o] = (1.0f - mcol) * dc[o] + d_hp;
    }
  }
}

template <typename RT>
int gru_backward_impl(const float* dout, const float* mask, const RT* z,
                      const RT* hprev, const float* w_t, float* dz,
                      float* dc, float* part, int T, int B, int H,
                      cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 block(THREADS);
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  const size_t zs = (size_t)B * 3 * H, hs = (size_t)B * H;
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_cand_kernel<RT><<<grid, block, 0, stream>>>(
        dout + t * hs, mask + (size_t)t * B, z + t * zs, hprev + t * hs, w_t,
        dc, dz + t * zs, part, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gru_bwd_gate_kernel<<<grid, block, 0, stream>>>(
        mask + (size_t)t * B, dz + t * zs, w_t, part, dc, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// dout [T, B, H] f32, mask [T, B] f32, z [T, B, 3H] and hprev [T, B, H] in
// the residual type (res_bf16 != 0: bfloat16, else float32), w_t [3H, H]
// f32 (the transposed recurrent weight), dz [T, B, 3H] f32 out,
// dc [B, H] f32 in: d_hfin, out: d_h0, part [B, H] f32 scratch.
// Returns a cudaError_t.
extern "C" int gru_backward(const void* dout, const void* mask, const void* z,
                            const void* hprev, const void* w_t, void* dz,
                            void* dc, void* part, int res_bf16, int T, int B,
                            int H, void* stream) {
  if (res_bf16) {
    return gru_backward_impl<__nv_bfloat16>(
        (const float*)dout, (const float*)mask, (const __nv_bfloat16*)z,
        (const __nv_bfloat16*)hprev, (const float*)w_t, (float*)dz,
        (float*)dc, (float*)part, T, B, H, (cudaStream_t)stream);
  }
  return gru_backward_impl<float>(
      (const float*)dout, (const float*)mask, (const float*)z,
      (const float*)hprev, (const float*)w_t, (float*)dz, (float*)dc,
      (float*)part, T, B, H, (cudaStream_t)stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// LSTM backward time loop (the reverse recurrence) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_lstm_bwd_pallas_raw (the
// _lstm_bwd_kernel body), which the text-classification LSTMs' backward
// reaches through ops/rnn_fused.py::_lstm_seq_bwd.
//
// Computes, for t = T-1 .. 0 over a time-major batch, from the forward's
// residuals z[t] (pre-peephole, gate order [i, f, o, g]) and c_prev[t]
// (stored in RT: float or bfloat16, widened to float32 here), the carry
// cotangents d_h, d_c (seeded by d_hfin, d_cfin), all in float32:
//     i, f = sigmoid(z_i + pi c_prev), sigmoid(z_f + pf c_prev)
//     g = tanh(z_g);  c_new = f c_prev + i g
//     o = sigmoid(z_o + po c_new);  tc = tanh(c_new)
//     m      = mask[t] > 0 ? 1 : 0
//     d_hnew = m (d_out[t] + d_h)
//     d_zo   = d_hnew tc o (1 - o)
//     d_cnew = m d_c + d_hnew o (1 - tc^2) + d_zo po
//     d_zi   = d_cnew g i (1 - i);   d_zf = d_cnew c_prev f (1 - f)
//     d_zg   = d_cnew i (1 - g^2)
//     d_z[t] = [d_zi, d_zf, d_zo, d_zg];  c_new[t] = c_new (when asked)
//     d_c    = (1 - m) d_c + d_cnew f + d_zi pi + d_zf pf
//     d_h    = (1 - m) d_h + d_z[t] @ W^T                 (f32 product)
// and returns d_h0 = d_h, d_c0 = d_c after step 0.  The product takes the
// transposed float32 weight w_t [4H, H], as the reference does (f32
// operands, ops/numerics.py::bwd_mm).
//
// What bounds it on this card: each reverse step's product [B, 4H] x
// [4H, H] needs the whole d_z row of that step, a dependency across the
// whole grid, and the next step's cell math needs the product's d_h.  The
// whole call's bound is its f32 FMA time (2 T B 4H H operations at
// 67 TFLOP/s: ~0.05 ms at B = 64, H = 256; ~1.25 ms at H = 1280); with
// T = 100 dependent steps it is bound by launch latency and the k loop of
// each block.  w_t (1 MB at H = 256, 26 MB at H = 1280) stays in L2.
//
// Design: ONE launch per reverse step, T + 1 in all, from a host loop in
// this file (the launch boundary is the grid-wide barrier).  Launch s runs
// the product of step s (s < T) and then, in the same thread that owns a
// (row, unit) of d_h, the cell math of step s - 1 (s > 0): it needs only
// that d_h entry, that d_c entry and the step's residuals, so no barrier
// lies between the two.  A block owns 8 rows x 16 units; its 256 threads
// are 8 groups (one warp each) over interleaved 32-deep k stages, their
// partial sums added in a fixed order, so a row's result does not depend
// on B (128 blocks at B = 64, H = 256; 640 at H = 1280).  d_h and d_c are
// updated in place: each thread owns its entries, and the product's
// operand is d_z, not d_h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;                     // batch rows per block
constexpr int BN = 16;                    // hidden units per block
constexpr int BK = 32;                    // depth of one k stage
constexpr int KSPLIT = 8;                 // thread groups over the k stages
constexpr int GROUP = 32;                 // 4 x 8 threads, 2 x 2 outputs each
constexpr int THREADS = KSPLIT * GROUP;   // 256

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

// launch s: dz_s != nullptr runs step s's product into d_h (mask_s = m[s]);
// z_t != nullptr runs step t = s - 1's cell math (mask_t = m[t]).
template <typename RT>
__global__ void __launch_bounds__(THREADS) lstm_bwd_step_kernel(
    const float* __restrict__ dz_s, const float* __restrict__ mask_s,
    const float* __restrict__ w_t, float* __restrict__ dh,
    float* __restrict__ dc, const float* __restrict__ dout_t,
    const float* __restrict__ mask_t, const RT* __restrict__ z_t,
    const RT* __restrict__ cp_t, const float* __restrict__ pi,
    const float* __restrict__ pf, const float* __restrict__ po,
    float* __restrict__ dz_t, float* __restrict__ cn_t, int B, int H) {
  __shared__ float As[KSPLIT][BM][BK + 1];
  __shared__ float Ws[KSPLIT][BK][BN];
  __shared__ float Ps[KSPLIT][BM][BN];
  const int grp = threadIdx.x / GROUP, lt = threadIdx.x % GROUP;
  const int tx = lt % 8, ty = lt / 8;     // rows 2ty, 2ty+1; cols tx, tx+8
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int K = 4 * H;
  if (dz_s != nullptr) {                   // uniform over the block
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    const int nst = (K + BK - 1) / BK;
    for (int s0 = 0; s0 < nst; s0 += KSPLIT) {
      const int k0 = (s0 + grp) * BK;     // past the end: zeros
      for (int e = lt; e < BM * BK; e += GROUP) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[grp][r][kk] = (gr < B && gk < K) ? dz_s[(size_t)gr * K + gk]
                                            : 0.0f;
      }
      for (int e = lt; e < BK * BN; e += GROUP) {
        const int kk = e / BN, cc = e % BN;
        const int gk = k0 + kk, gc = col0 + cc;
        Ws[grp][kk][cc] = (gk < K && gc < H) ? w_t[(size_t)gk * H + gc]
                                             : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float a0 = As[grp][ty * 2][kk], a1 = As[grp][ty * 2 + 1][kk];
        const float w0 = Ws[grp][kk][tx], w1 = Ws[grp][kk][tx + 8];
        acc[0][0] += a0 * w0;
        acc[0][1] += a0 * w1;
        acc[1][0] += a1 * w0;
        acc[1][1] += a1 * w1;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) Ps[grp][ty * 2 + i][tx + 8 * j] = acc[i][j];
    }
    __syncthreads();
  }
  if (threadIdx.x >= BM * BN) return;
  const int r = threadIdx.x / BN, cc = threadIdx.x % BN;
  const int b = row0 + r, j = col0 + cc;
  if (b >= B || j >= H) return;
  const size_t o = (size_t)b * H + j;
  float d_h = dh[o];
  if (dz_s != nullptr) {
    float s = 0.0f;
#pragma unroll
    for (int g2 = 0; g2 < KSPLIT; ++g2) s += Ps[g2][r][cc];
    const float ms = mask_s[b] > 0.0f ? 1.0f : 0.0f;
    d_h = (1.0f - ms) * d_h + s;
    dh[o] = d_h;
  }
  if (z_t == nullptr) return;
  const RT* zr = z_t + (size_t)b * K;
  const float cp = to_f<RT>(cp_t[o]);
  const float pij = pi[j], pfj = pf[j], poj = po[j];
  const float ig = sigmoid_f(to_f<RT>(zr[j]) + pij * cp);
  const float fg = sigmoid_f(to_f<RT>(zr[H + j]) + pfj * cp);
  const float gg = tanhf(to_f<RT>(zr[3 * H + j]));
  const float cn = fg * cp + ig * gg;
  const float og = sigmoid_f(to_f<RT>(zr[2 * H + j]) + poj * cn);
  const float tc = tanhf(cn);
  const float mc = mask_t[b] > 0.0f ? 1.0f : 0.0f;
  const float d_c = dc[o];
  const float d_hnew = mc * (dout_t[o] + d_h);
  const float d_zo = d_hnew * tc * og * (1.0f - og);
  const float d_cnew = mc * d_c + d_hnew * og * (1.0f - tc * tc) + d_zo * poj;
  const float d_zi = d_cnew * gg * ig * (1.0f - ig);
  const float d_zf = d_cnew * cp * fg * (1.0f - fg);
  const float d_zg = d_cnew * ig * (1.0f - gg * gg);
  float* dzr = dz_t + (size_t)b * K;
  dzr[j] = d_zi;
  dzr[H + j] = d_zf;
  dzr[2 * H + j] = d_zo;
  dzr[3 * H + j] = d_zg;
  if (cn_t != nullptr) cn_t[o] = cn;
  dc[o] = (1.0f - mc) * d_c + (d_cnew * fg + d_zi * pij + d_zf * pfj);
}

template <typename RT>
int lstm_backward_impl(const float* dout, const float* mask, const RT* z,
                       const RT* cprev, const float* w_t, const float* pi,
                       const float* pf, const float* po, float* dz,
                       float* cn, float* dh, float* dc, int T, int B, int H,
                       cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 grid((H + BN - 1) / BN, (B + BM - 1) / BM);
  const size_t zs = (size_t)B * 4 * H, hs = (size_t)B * H;
  for (int s = T; s >= 0; --s) {
    const bool prod = s < T, cell = s > 0;
    const int t = s - 1;
    lstm_bwd_step_kernel<RT><<<grid, THREADS, 0, stream>>>(
        prod ? dz + s * zs : nullptr, prod ? mask + (size_t)s * B : nullptr,
        w_t, dh, dc, cell ? dout + t * hs : nullptr,
        cell ? mask + (size_t)t * B : nullptr, cell ? z + t * zs : nullptr,
        cell ? cprev + t * hs : nullptr, pi, pf, po,
        cell ? dz + t * zs : nullptr,
        (cell && cn != nullptr) ? cn + t * hs : nullptr, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// dout [T, B, H] f32, mask [T, B] f32, z [T, B, 4H] and cprev [T, B, H] in
// the residual type (res_bf16 != 0: bfloat16, else float32), w_t [4H, H]
// f32 (the transposed recurrent weight), pi/pf/po [H] f32, dz [T, B, 4H]
// f32 out, cn [T, B, H] f32 out (c_new, for d_po) or null, dh / dc [B, H]
// f32 in: d_hfin / d_cfin, out: d_h0 / d_c0.  Returns a cudaError_t.
extern "C" int lstm_backward(const void* dout, const void* mask,
                             const void* z, const void* cprev,
                             const void* w_t, const void* pi, const void* pf,
                             const void* po, void* dz, void* cn, void* dh,
                             void* dc, int res_bf16, int T, int B, int H,
                             void* stream) {
  if (res_bf16) {
    return lstm_backward_impl<__nv_bfloat16>(
        (const float*)dout, (const float*)mask, (const __nv_bfloat16*)z,
        (const __nv_bfloat16*)cprev, (const float*)w_t, (const float*)pi,
        (const float*)pf, (const float*)po, (float*)dz, (float*)cn,
        (float*)dh, (float*)dc, T, B, H, (cudaStream_t)stream);
  }
  return lstm_backward_impl<float>(
      (const float*)dout, (const float*)mask, (const float*)z,
      (const float*)cprev, (const float*)w_t, (const float*)pi,
      (const float*)pf, (const float*)po, (float*)dz, (float*)cn,
      (float*)dh, (float*)dc, T, B, H, (cudaStream_t)stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

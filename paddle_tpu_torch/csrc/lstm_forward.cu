// LSTM forward time loop for Hopper (sm_90a), with or without the backward's
// residual outputs.
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::_lstm_pallas_raw (the
// _lstm_kernel body; residuals=False for inference, residuals=True for
// training), which the text-classification LSTMs reach through
// ops/rnn_fused.py::_lstm_core_fwd.
//
// Computes, for t = 0 .. T-1 over a time-major batch (gate order
// [i, f, o, g]; peepholes as the legacy cell: i and f see c_prev, o sees
// c_new):
//     z      = xp[t] + round(h) @ round(W)        (pre-peephole, [B, 4H])
//     i, f   = sigmoid(z_i + pi * c), sigmoid(z_f + pf * c)
//     g      = tanh(z_g)
//     c_new  = f * c + i * g
//     o      = sigmoid(z_o + po * c_new)
//     h_new  = o * tanh(c_new)
//     h, c   = mask[t] > 0 ? (h_new, c_new) : (h, c)   (masked steps hold)
//     h_seq[t] = h * mask[t]                            (and emit zero)
// round() is the cast of a matmul operand to the compute type (CT: float or
// bfloat16); products accumulate in float32, the gate math and the carries
// are float32.  The loop starts from the carries h0/c0.  With residuals
// (training), each step also stores, in the residual type RT
// (ops/numerics.py::residual_dtype), where _lstm_kernel stores them:
//     z[t]      the pre-peephole pre-activations           [B, 4H]
//     h_prev[t] the h carry entering the step              [B, H]
//     c_prev[t] the c carry entering the step              [B, H]
//
// What bounds it on this card: the recurrence is sequential over T and every
// step's product needs the whole h row of the step before, a dependency
// across the whole grid at each step.  At the text-classification shapes
// (B = 64, T = 100, H = 256 or 1280) the call's bytes bound it at ~0.01 ms
// (inference, H = 256) to ~0.11 ms (f32 residuals, H = 1280), far below the
// latency of 100 dependent steps.  On the TPU W_h stays in VMEM for all T
// steps; here bf16 W_h is 0.5 MB (H = 256) or 13 MB (H = 1280): it stays in
// the 50 MB L2, not in one SM's shared memory.
//
// Design: ONE launch per step from a host loop in this file; the launch
// boundary is the grid-wide barrier.  A block owns 8 batch rows and the four
// gate columns j, H+j, 2H+j, 3H+j of 8 units j, so the product's epilogue has
// all four pre-activations of its (row, unit) pairs: the gate math, the
// masked hold, h_seq and the residual stores fuse into it.  The 256 threads
// are 4 groups that take interleaved 32-deep k stages of the product (more
// warps in flight at B = 64: 256 blocks at H = 256, 1280 at H = 1280), and
// the four partial sums are added in a fixed order, so a row's result does
// not depend on B.  The h carry ping-pongs between two buffers (a block
// reads the whole previous row while others write the new one); c is
// updated in place (each thread owns its entries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 8;                     // batch rows per block
constexpr int NU = 8;                     // hidden units per block
constexpr int BN = 4 * NU;                // product columns per block
constexpr int BK = 32;                    // depth of one k stage
constexpr int KSPLIT = 4;                 // thread groups over the k stages
constexpr int GROUP = 64;                 // 4 x 16 threads, 2 x 2 outputs each
constexpr int THREADS = KSPLIT * GROUP;   // 256

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

// one step: z = xp_t + round(h_in) @ W over the block's 8 rows x 32 gate
// columns, then the cell for its 8 x 8 (row, unit) pairs.  z_t == nullptr:
// no residuals (inference).
template <typename CT, typename RT>
__global__ void __launch_bounds__(THREADS) lstm_step_kernel(
    const float* __restrict__ xp_t, const float* __restrict__ mask_t,
    const CT* __restrict__ W, const float* __restrict__ pi,
    const float* __restrict__ pf, const float* __restrict__ po,
    const float* __restrict__ h_in, float* __restrict__ h_out,
    float* __restrict__ c, float* __restrict__ hseq_t, RT* __restrict__ z_t,
    RT* __restrict__ hp_t, RT* __restrict__ cp_t, int B, int H) {
  __shared__ float As[KSPLIT][BM][BK + 1];
  __shared__ float Ws[KSPLIT][BK][BN];
  __shared__ float Zs[KSPLIT][BM][BN];
  const int grp = threadIdx.x / GROUP, lt = threadIdx.x % GROUP;
  const int tx = lt % 16, ty = lt / 16;   // rows 2ty, 2ty+1; cols tx, tx+16
  const int row0 = blockIdx.y * BM, u0 = blockIdx.x * NU;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  const int nst = (H + BK - 1) / BK;
  // every group runs the same number of iterations (a stage past the end
  // loads zeros), so the barriers are uniform across the block
  for (int s0 = 0; s0 < nst; s0 += KSPLIT) {
    const int k0 = (s0 + grp) * BK;
    for (int e = lt; e < BM * BK; e += GROUP) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[grp][r][kk] = (gr < B && gk < H)
                           ? round_ct<CT>(h_in[(size_t)gr * H + gk])
                           : 0.0f;
    }
    for (int e = lt; e < BK * BN; e += GROUP) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, u = u0 + cc % NU, gate = cc / NU;
      Ws[grp][kk][cc] =
          (gk < H && u < H)
              ? to_f<CT>(W[(size_t)gk * 4 * H + (size_t)gate * H + u])
              : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a0 = As[grp][ty * 2][kk], a1 = As[grp][ty * 2 + 1][kk];
      const float w0 = Ws[grp][kk][tx], w1 = Ws[grp][kk][tx + 16];
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
    for (int j = 0; j < 2; ++j) Zs[grp][ty * 2 + i][tx + 16 * j] = acc[i][j];
  }
  __syncthreads();
  if (threadIdx.x >= BM * NU) return;
  const int r = threadIdx.x / NU, uu = threadIdx.x % NU;
  const int b = row0 + r, u = u0 + uu;
  if (b >= B || u >= H) return;
  float z[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    float s = 0.0f;
#pragma unroll
    for (int g2 = 0; g2 < KSPLIT; ++g2) s += Zs[g2][r][gate * NU + uu];
    z[gate] = xp_t[(size_t)b * 4 * H + (size_t)gate * H + u] + s;
  }
  const size_t o = (size_t)b * H + u;
  const float hv = h_in[o], cv = c[o];
  const float ig = sigmoid_f(z[0] + pi[u] * cv);
  const float fg = sigmoid_f(z[1] + pf[u] * cv);
  const float gg = tanhf(z[3]);
  const float cn = fg * cv + ig * gg;
  const float og = sigmoid_f(z[2] + po[u] * cn);
  const float hn = og * tanhf(cn);
  if (z_t != nullptr) {
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      z_t[(size_t)b * 4 * H + (size_t)gate * H + u] = to_rt<RT>(z[gate]);
    hp_t[o] = to_rt<RT>(hv);
    cp_t[o] = to_rt<RT>(cv);
  }
  const float m = mask_t[b];
  const bool keep = m > 0.0f;
  const float hk = keep ? hn : hv;
  h_out[o] = hk;
  c[o] = keep ? cn : cv;
  hseq_t[o] = hk * m;
}

template <typename CT, typename RT>
int lstm_forward_impl(const float* xp, const float* mask, const CT* w,
                      const float* pi, const float* pf, const float* po,
                      float* h_seq, float* h, float* h_tmp, float* c, RT* z,
                      RT* hprev, RT* cprev, int T, int B, int H,
                      cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  const dim3 grid((H + NU - 1) / NU, (B + BM - 1) / BM);
  const size_t xs = (size_t)B * 4 * H, hs = (size_t)B * H;
  float* bufs[2] = {h, h_tmp};
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<CT, RT><<<grid, THREADS, 0, stream>>>(
        xp + t * xs, mask + (size_t)t * B, w, pi, pf, po, bufs[t & 1],
        bufs[(t + 1) & 1], c, h_seq + t * hs,
        z == nullptr ? nullptr : z + t * xs,
        hprev == nullptr ? nullptr : hprev + t * hs,
        cprev == nullptr ? nullptr : cprev + t * hs, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // after an odd number of steps the final h carry is in the scratch buffer
  if (T & 1) {
    return (int)cudaMemcpyAsync(h, h_tmp, hs * sizeof(float),
                                cudaMemcpyDeviceToDevice, stream);
  }
  return (int)cudaSuccess;
}

// residual type by flag: z == nullptr (inference) stores no residuals
template <typename CT>
int lstm_forward_dispatch(const void* xp, const void* mask, const void* w,
                          const void* pi, const void* pf, const void* po,
                          void* h_seq, void* h, void* h_tmp, void* c, void* z,
                          void* hprev, void* cprev, int res_bf16, int T,
                          int B, int H, void* stream) {
  if ((z == nullptr) != (hprev == nullptr) ||
      (z == nullptr) != (cprev == nullptr))
    return (int)cudaErrorInvalidValue;
  if (res_bf16) {
    return lstm_forward_impl<CT, __nv_bfloat16>(
        (const float*)xp, (const float*)mask, (const CT*)w,
        (const float*)pi, (const float*)pf, (const float*)po, (float*)h_seq,
        (float*)h, (float*)h_tmp, (float*)c, (__nv_bfloat16*)z,
        (__nv_bfloat16*)hprev, (__nv_bfloat16*)cprev, T, B, H,
        (cudaStream_t)stream);
  }
  return lstm_forward_impl<CT, float>(
      (const float*)xp, (const float*)mask, (const CT*)w, (const float*)pi,
      (const float*)pf, (const float*)po, (float*)h_seq, (float*)h,
      (float*)h_tmp, (float*)c, (float*)z, (float*)hprev, (float*)cprev, T,
      B, H, (cudaStream_t)stream);
}

}  // namespace

// xp [T, B, 4H] f32, mask [T, B] f32, w [H, 4H] in the compute type,
// pi/pf/po [H] f32, h_seq [T, B, H] f32 out, h [B, H] f32 in: h0, out:
// h_final, h_tmp [B, H] f32 scratch, c [B, H] f32 in: c0, out: c_final;
// z [T, B, 4H], hprev and cprev [T, B, H] residual outputs in bfloat16
// (res_bf16 != 0) or float32, all null for inference.  Returns a
// cudaError_t.
extern "C" int lstm_forward_f32(const void* xp, const void* mask,
                                const void* w, const void* pi, const void* pf,
                                const void* po, void* h_seq, void* h,
                                void* h_tmp, void* c, void* z, void* hprev,
                                void* cprev, int res_bf16, int T, int B,
                                int H, void* stream) {
  return lstm_forward_dispatch<float>(xp, mask, w, pi, pf, po, h_seq, h,
                                      h_tmp, c, z, hprev, cprev, res_bf16, T,
                                      B, H, stream);
}

extern "C" int lstm_forward_bf16(const void* xp, const void* mask,
                                 const void* w, const void* pi,
                                 const void* pf, const void* po, void* h_seq,
                                 void* h, void* h_tmp, void* c, void* z,
                                 void* hprev, void* cprev, int res_bf16,
                                 int T, int B, int H, void* stream) {
  return lstm_forward_dispatch<__nv_bfloat16>(xp, mask, w, pi, pf, po, h_seq,
                                              h, h_tmp, c, z, hprev, cprev,
                                              res_bf16, T, B, H, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

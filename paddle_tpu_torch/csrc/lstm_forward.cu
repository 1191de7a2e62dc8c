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
// latency of 100 dependent steps.  bf16 w_h is 0.5 MB (H = 256) or 13 MB
// (H = 1280).
//
// Two kernels, picked by the wrapper from (compute type, B, H, SM count)
// alone (ops/kernels/lstm.py::_lstm_fwd_path):
//
// lstm_fwd_persistent_kernel ("persistent", bf16 compute): the whole loop
//   in ONE cooperative launch, one block per SM, bf16 w_h resident in
//   shared memory for all T steps, as the TPU kernel keeps w_h in VMEM.
//   Block i owns NU units j (ops/kernels/lstm.py::_lstm_fwd_plan: 10 at
//   H = 1280, 128 blocks of 102,400 bytes of w_h; 4 at H = 256, 64 blocks)
//   and all four gate columns j, H+j, 2H+j, 3H+j of each over the full
//   depth H, so the step's gate math, the masked hold, h_seq and the
//   residual stores fuse into the product's epilogue with no sums across
//   blocks: ONE grid barrier a step (csrc/persistent.cuh).  The f32 h and
//   c carries of a block's units stay in its shared memory; only round(h),
//   the product's bf16 operand (exact), goes to a global ping-pong buffer,
//   which every block streams after the barrier through a ring of four
//   [64 x 64] bf16 stages (cp.async, 16-byte pieces swizzled so ldmatrix
//   reads hit distinct banks).  The product runs on the tensor cores:
//   mma.sync m16n8k16 bf16 with f32 accumulators, w_h kept in the B
//   fragments' register order so a lane reads its fragment with one 8-byte
//   load.  The 8 warps are 4 row tiles of 16 x 2 k-groups (interleaved
//   32-deep halves of each stage); the two k-groups' sums meet in shared
//   memory in a fixed order, z = xp + (P0 + P1), and every k order depends
//   on H alone, so a row's result does not depend on B.  Rows are taken 64
//   at a time, up to 256 (the carries' room).
// lstm_step_kernel ("steps": f32 compute, or shapes the persistent kernel
//   cannot take): ONE launch per step from a host loop in this file; the
//   launch boundary is the grid-wide barrier.  A block owns 8 batch rows
//   and the four gate columns of 8 units, so the product's epilogue has all
//   four pre-activations of its (row, unit) pairs.  The 256 threads are 4
//   groups that take interleaved 32-deep k stages of the product, and the
//   four partial sums are added in a fixed order, so a row's result does
//   not depend on B.  w_h stays in L2 and is converted to f32 in shared
//   memory each step.  The h carry ping-pongs between two buffers (a block
//   reads the whole previous row while others write the new one); c is
//   updated in place (each thread owns its entries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "persistent.cuh"

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


// ------------------------------------------- one persistent launch (bf16)

namespace k9 {

constexpr int THREADS = 256;        // 8 warps: 4 row tiles x 2 k-groups
constexpr int ROWS = 64;                     // rows of one row block
constexpr int KC = 64;                       // depth of one h stage
constexpr int NST = 4;                       // h stages in the ring
constexpr int STAGE_BYTES = ROWS * KC * 2;   // one [64 x 64] bf16 stage
constexpr int ROWS_MAX = 256;                // rows the carries have room for
constexpr int NU_MAX = 16;                   // units a block: 8 n8 tiles
constexpr int NT_MAX = 4 * NU_MAX / 8;
constexpr int PAIRS = ROWS * NU_MAX / THREADS;   // (row, unit) pairs a thread
constexpr size_t SMEM_LIMIT = 232448;

// the product's depth, padded to whole stages (w_h's pad rows are zeros)
__host__ __device__ inline int kpad(int H) { return (H + KC - 1) / KC * KC; }

inline size_t smem_bytes(int H, int NU) {
  return (size_t)kpad(H) * 4 * NU * 2        // w_h slice, bf16
         + (size_t)NST * STAGE_BYTES         // the h ring
         + (size_t)2 * ROWS * 4 * NU * 4     // the k-groups' partial z
         + (size_t)2 * ROWS_MAX * NU * 4     // the h and c carries
         + (size_t)3 * NU * 4;               // peepholes
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* w,
                                              bool ok) {
  return ok ? (uint32_t)__bfloat16_as_ushort(*w) : 0u;
}

}  // namespace k9

// xp [B, T, 4H] and mask [B, T] batch-major; hb [2, B, H] bf16 scratch;
// bar [1] u32, zero.  One block per SM, NU units each (the last may have
// fewer).  z == nullptr: no residuals.
template <typename RT>
__global__ void __launch_bounds__(k9::THREADS, 1) lstm_fwd_persistent_kernel(
    const float* __restrict__ xp, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ pi,
    const float* __restrict__ pf, const float* __restrict__ po,
    float* __restrict__ h_seq, float* __restrict__ h, float* __restrict__ c,
    __nv_bfloat16* __restrict__ hb, RT* __restrict__ z,
    RT* __restrict__ hprev, RT* __restrict__ cprev, unsigned* bar, int T,
    int B, int H, int NU) {
  const int NC = 4 * NU, NT = NC / 8, KP = k9::kpad(H);
  extern __shared__ float4 smem4[];
  // w_h's slice in B-fragment order: [KP / 16][NT][32 lanes] x 2 registers
  uint2* wf = reinterpret_cast<uint2*>(smem4);
  // the h ring: [NST][64 rows][8 pieces of 16 bytes], piece q of row r
  // at q ^ (r % 8)
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(wf + (size_t)KP / 16 * NT * 32);
  float* zs = reinterpret_cast<float*>(ring + k9::NST * k9::STAGE_BYTES);
  float* hs = zs + 2 * k9::ROWS * NC;     // [ROWS_MAX][NU] f32 h carry
  float* cs = hs + k9::ROWS_MAX * NU;     // [ROWS_MAX][NU] f32 c carry
  float* peep = cs + k9::ROWS_MAX * NU;   // [3][NU]: pi, pf, po
  const int u0 = blockIdx.x * NU, nu = min(NU, H - u0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mt = warp % 4, kg = warp / 4;
  const size_t H4 = (size_t)4 * H;

  // B fragment of (k16 step ks, n8 tile nt) for lane l: column n = 8 nt +
  // l / 4 (gate n / NU, unit n % NU), rows k = 16 ks + 2 (l % 4) + {0, 1}
  // and the same + 8, the lower k in the lower half of each register
  const int nfrag = KP / 16 * NT * 32;
  for (int e = threadIdx.x; e < nfrag; e += k9::THREADS) {
    const int l = e % 32, nt = e / 32 % NT, ks = e / 32 / NT;
    const int n = nt * 8 + l / 4, gate = n / NU, uu = n % NU;
    const __nv_bfloat16* col = w + (size_t)gate * H + u0 + uu;
    uint32_t v[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = ks * 16 + (l % 4) * 2 + half * 8;
      const bool ok = uu < nu && k < H;   // H is even: k + 1 < H too
      v[half] = k9::bf16_bits(col + (size_t)k * H4, ok) |
                (k9::bf16_bits(col + (size_t)(k + 1) * H4, ok) << 16);
    }
    wf[e] = make_uint2(v[0], v[1]);
  }
  for (int e = threadIdx.x; e < 3 * NU; e += k9::THREADS) {
    const float* p = e < NU ? pi : e < 2 * NU ? pf : po;
    peep[e] = e % NU < nu ? p[u0 + e % NU] : 0.0f;
  }
  // the carries from h0 / c0; round(h0) is step 0's operand
  for (int e = threadIdx.x; e < B * NU; e += k9::THREADS) {
    const int b = e / NU, uu = e % NU;
    float hv = 0.0f, cv = 0.0f;
    if (uu < nu) {
      const size_t o = (size_t)b * H + u0 + uu;
      hv = h[o];
      cv = c[o];
      hb[o] = __float2bfloat16_rn(hv);
    }
    hs[e] = hv;
    cs[e] = cv;
  }
  unsigned target = 0;
  pk::grid_sync(bar, target);

  const int nkc = KP / k9::KC;
  const int items = (B + k9::ROWS - 1) / k9::ROWS * nkc;
  const size_t hsz = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hin = hb + (size_t)(t & 1) * hsz;
    __nv_bfloat16* hout = hb + (size_t)((t + 1) & 1) * hsz;
    // item n (row block n / nkc, k chunk n % nkc) of round(h) into its
    // stage: each thread copies two 16-byte pieces; H % 8 == 0, so a piece
    // is whole or past the end (zeros)
    auto issue = [&](int n) {
      if (n < items) {
        const int r0 = n / nkc * k9::ROWS, kb = n % nkc * k9::KC;
        unsigned char* st = ring + (n % k9::NST) * k9::STAGE_BYTES;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int p = threadIdx.x + u * k9::THREADS;
          const int r = p / 8, q = p % 8;
          const int b = r0 + r, k = kb + 8 * q;
          const bool ok = b < B && k < H;
          pk::cp_async16(st + r * 128 + 16 * (q ^ (r & 7)),
                         ok ? hin + (size_t)b * H + k : hin, ok ? 16 : 0);
        }
      }
      pk::cp_async_commit();              // an empty group past the end
    };
#pragma unroll
    for (int i = 0; i < k9::NST - 1; ++i) issue(i);
    float acc[k9::NT_MAX][4];
    float xr[k9::PAIRS][4], mr[k9::PAIRS];
    for (int n = 0; n < items; ++n) {
      const int kc = n % nkc, r0 = n / nkc * k9::ROWS;
      if (kc == 0) {
#pragma unroll
        for (int nt = 0; nt < k9::NT_MAX; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
        // this row block's xp and mask, for the epilogue, read early
#pragma unroll
        for (int p = 0; p < k9::PAIRS; ++p) {
          const int e = threadIdx.x + p * k9::THREADS;
          const int b = r0 + e / NU, uu = e % NU;
          if (e < k9::ROWS * NU && b < B && uu < nu) {
            const float* xrow = xp + ((size_t)b * T + t) * H4 + u0 + uu;
#pragma unroll
            for (int g = 0; g < 4; ++g) xr[p][g] = xrow[(size_t)g * H];
            mr[p] = mask[(size_t)b * T + t];
          }
        }
      }
      pk::cp_async_wait<k9::NST - 2>();   // item n has landed (this thread's)
      __syncthreads();                    // ... everyone's; its stage - 1 free
      issue(n + k9::NST - 1);
      if (r0 + mt * 16 < B) {             // uniform over the warp
        const unsigned char* st = ring + (n % k9::NST) * k9::STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c16 = kg * 2 + j;     // k16 step within the stage
          const int r = mt * 16 + lane % 16, q = 2 * c16 + lane / 16;
          uint32_t a[4];
          k9::ldmatrix_x4(a, st + r * 128 + 16 * (q ^ (r & 7)));
          const uint2* wk = wf + ((size_t)(kc * 4 + c16) * NT) * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < k9::NT_MAX; ++nt) {
            if (nt < NT) {
              const uint2 bv = wk[nt * 32];
              pk::mma_bf16(acc[nt], a, bv.x, bv.y);
            }
          }
        }
      }
      if (kc != nkc - 1) continue;
      // the row block's product is done: each k-group's partial z to
      // shared memory, then the cell of each (row, unit) pair
      if (r0 + mt * 16 < B) {
        float* zk = zs + (size_t)kg * k9::ROWS * NC;
        const int row = mt * 16 + lane / 4;
#pragma unroll
        for (int nt = 0; nt < k9::NT_MAX; ++nt) {
          if (nt < NT) {
            const int col = nt * 8 + (lane % 4) * 2;
            zk[row * NC + col] = acc[nt][0];
            zk[row * NC + col + 1] = acc[nt][1];
            zk[(row + 8) * NC + col] = acc[nt][2];
            zk[(row + 8) * NC + col + 1] = acc[nt][3];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < k9::PAIRS; ++p) {
        const int e = threadIdx.x + p * k9::THREADS;
        const int r = e / NU, uu = e % NU, b = r0 + r;
        if (e >= k9::ROWS * NU || b >= B || uu >= nu) continue;
        float zv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const int col = r * NC + g * NU + uu;
          zv[g] = xr[p][g] + (zs[col] + zs[k9::ROWS * NC + col]);
        }
        const int u = u0 + uu;
        const float hv = hs[b * NU + uu], cv = cs[b * NU + uu];
        const float ig = sigmoid_f(zv[0] + peep[uu] * cv);
        const float fg = sigmoid_f(zv[1] + peep[NU + uu] * cv);
        const float gg = tanhf(zv[3]);
        const float cn = fg * cv + ig * gg;
        const float og = sigmoid_f(zv[2] + peep[2 * NU + uu] * cn);
        const float hn = og * tanhf(cn);
        const size_t o = (size_t)b * H + u;
        if (z != nullptr) {
          RT* zr = z + (size_t)t * B * H4 + (size_t)b * H4 + u;
#pragma unroll
          for (int g = 0; g < 4; ++g) zr[(size_t)g * H] = to_rt<RT>(zv[g]);
          hprev[t * hsz + o] = to_rt<RT>(hv);
          cprev[t * hsz + o] = to_rt<RT>(cv);
        }
        const bool keep = mr[p] > 0.0f;
        const float hk = keep ? hn : hv;
        hs[b * NU + uu] = hk;
        cs[b * NU + uu] = keep ? cn : cv;
        h_seq[t * hsz + o] = hk * mr[p];
        hout[o] = __float2bfloat16_rn(hk);
      }
    }
    pk::cp_async_wait<0>();
    pk::grid_sync(bar, target);           // round(h) of step t complete
  }
  for (int e = threadIdx.x; e < B * NU; e += k9::THREADS) {
    const int b = e / NU, uu = e % NU;
    if (uu < nu) {
      h[(size_t)b * H + u0 + uu] = hs[e];
      c[(size_t)b * H + u0 + uu] = cs[e];
    }
  }
}

template <typename RT>
int lstm_fwd_persistent_launch(const float* xp, const float* mask,
                               const __nv_bfloat16* w, const float* pi,
                               const float* pf, const float* po, float* h_seq,
                               float* h, float* c, __nv_bfloat16* hb, RT* z,
                               RT* hprev, RT* cprev, unsigned* bar, int T,
                               int B, int H, int NU, cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  if (B > k9::ROWS_MAX || H % 8 != 0 || NU < 2 || NU > k9::NU_MAX ||
      NU % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (H + NU - 1) / NU;
  const size_t smem = k9::smem_bytes(H, NU);
  if (smem > k9::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  void* args[] = {&xp, &mask, &w,  &pi,    &pf,    &po,  &h_seq,
                  &h,  &c,    &hb, &z,     &hprev, &cprev, &bar,
                  &T,  &B,    &H,  &NU};
  return pk::cooperative_launch(lstm_fwd_persistent_kernel<RT>, args, blocks,
                                k9::THREADS, smem, stream);
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

// The persistent kernel (see _lstm_fwd_path / _lstm_fwd_plan), bf16
// compute only: xp [B, T, 4H] f32 and mask [B, T] f32 batch-major, w
// [H, 4H] bf16, pi/pf/po [H] f32, h_seq [T, B, H] f32 out, h / c [B, H]
// f32 in: h0 / c0, out: h_final / c_final, hb [2, B, H] bf16 scratch, z /
// hprev / cprev as lstm_forward_*, bar [1] u32 zeroed, and NU, the units a
// block (even, at most 16; ceil(H / NU) blocks).  H % 8 == 0, B <= 256.
extern "C" int lstm_forward_persistent(const void* xp, const void* mask,
                                       const void* w, const void* pi,
                                       const void* pf, const void* po,
                                       void* h_seq, void* h, void* c,
                                       void* hb, void* z, void* hprev,
                                       void* cprev, void* bar, int res_bf16,
                                       int T, int B, int H, int NU,
                                       void* stream) {
  if ((z == nullptr) != (hprev == nullptr) ||
      (z == nullptr) != (cprev == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto args = [&](auto* rt) {
    using RT = std::remove_pointer_t<decltype(rt)>;
    return lstm_fwd_persistent_launch<RT>(
        (const float*)xp, (const float*)mask, (const __nv_bfloat16*)w,
        (const float*)pi, (const float*)pf, (const float*)po, (float*)h_seq,
        (float*)h, (float*)c, (__nv_bfloat16*)hb, (RT*)z, (RT*)hprev,
        (RT*)cprev, (unsigned*)bar, T, B, H, NU, (cudaStream_t)stream);
  };
  return res_bf16 ? args((__nv_bfloat16*)nullptr) : args((float*)nullptr);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: persistent with NU units of width H, f32
// residuals; 1: per-step, bf16 compute, f32 residuals)
extern "C" int lstm_forward_info(int which, int H, int NU, int* regs,
                                 int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn =
      which == 1 ? (const void*)lstm_step_kernel<__nv_bfloat16, float>
                 : (const void*)lstm_fwd_persistent_kernel<float>;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k9::smem_bytes(H, NU) : 0);
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

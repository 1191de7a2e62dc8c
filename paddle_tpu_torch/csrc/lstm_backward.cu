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
// T = 100 dependent steps the grid-wide dependency is what costs.
//
// Two kernels, picked by the wrapper from (B, H, SM count) alone
// (ops/kernels/lstm.py::_lstm_bwd_path):
//
// lstm_bwd_persistent_kernel ("persistent"): the whole reverse loop in ONE
//   cooperative launch, one block per SM, w_t resident in shared memory
//   split across the blocks, as the TPU kernel keeps w_t whole in VMEM.
//   Block i owns k-group i % KG (KW rows of w_t, a multiple of 32) and
//   column group i / KG (CW <= 160 columns): at H = 1280, 16 x 8 = 128
//   blocks of 320 x 160 f32 (204,800 bytes), at H = 256 32 x 4 blocks of
//   32 x 64 (the split: ops/kernels/lstm.py::_lstm_bwd_plan).  A step s is
//   (1) the product: each block streams its k-range of d_z[s] from L2
//   through a ring of three [64 x 32] shared stages (cp.async, 16-byte
//   pieces swizzled so a thread's 4-row reads hit distinct banks) and forms
//   its f32 partial d_h for 64 rows x its columns, each thread a 4 x 10 (or
//   4 x 5, CW <= 80) register tile: per k one d_z value a row from a
//   16-byte load of four k, and two 16-byte and two 4-byte w loads for 40
//   FMAs, so the FMAs and not shared-memory bandwidth set the pace.  The
//   partials go to an L2-resident scratch [KG, B, H]; a grid barrier; (2)
//   the thread that owns (b, j) adds the KG partials in k-group order,
//   applies the mask and runs step s - 1's cell math; a grid barrier.  2T
//   barriers in all.  The barrier (csrc/persistent.cuh, shared with K9) is
//   an arrival counter in device memory that only grows; its wait traps
//   after ~2^35 cycles, so a fault ends in an error, never a hung card.
//   The plan (KG, KW, CW) depends on H and the SM count, not on B: a
//   row's sums run in the same order at any B.
//   Rows are taken 64 at a time, up to the wrapper's row limit.
// lstm_bwd_step_kernel ("steps": B or H beyond what the persistent kernel
//   takes): ONE launch per reverse step, T + 1 in all, from a host loop in
//   this file (the launch boundary is the grid-wide barrier).  Launch s
//   runs the product of step s (s < T) and then, in the same thread that
//   owns a (row, unit) of d_h, the cell math of step s - 1 (s > 0): it
//   needs only that d_h entry, that d_c entry and the step's residuals, so
//   no barrier lies between the two.  A block owns 8 rows x 16 units; its
//   256 threads are 8 groups (one warp each) over interleaved 32-deep k
//   stages, their partial sums added in a fixed order, so a row's result
//   does not depend on B.  w_t (26 MB at H = 1280) stays in L2.
// Both update d_h and d_c in place: each thread owns its entries, and the
// product's operand is d_z, not d_h.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "persistent.cuh"

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

// step t's cell math for entry (b, j), given d_h after step t + 1's
// product: writes d_z[t] (row dzr), c_new[t] (when cn_t) and d_c
template <typename RT>
__device__ __forceinline__ void cell_bwd(
    const RT* __restrict__ zr, float cp, float pij, float pfj, float poj,
    float mask_b, float dout, float d_h, float* __restrict__ dc_o,
    float* __restrict__ dzr, float* __restrict__ cn_o, int H, int j) {
  const float ig = sigmoid_f(to_f<RT>(zr[j]) + pij * cp);
  const float fg = sigmoid_f(to_f<RT>(zr[H + j]) + pfj * cp);
  const float gg = tanhf(to_f<RT>(zr[3 * H + j]));
  const float cn = fg * cp + ig * gg;
  const float og = sigmoid_f(to_f<RT>(zr[2 * H + j]) + poj * cn);
  const float tc = tanhf(cn);
  const float mc = mask_b > 0.0f ? 1.0f : 0.0f;
  const float d_c = *dc_o;
  const float d_hnew = mc * (dout + d_h);
  const float d_zo = d_hnew * tc * og * (1.0f - og);
  const float d_cnew = mc * d_c + d_hnew * og * (1.0f - tc * tc) + d_zo * poj;
  const float d_zi = d_cnew * gg * ig * (1.0f - ig);
  const float d_zf = d_cnew * cp * fg * (1.0f - fg);
  const float d_zg = d_cnew * ig * (1.0f - gg * gg);
  dzr[j] = d_zi;
  dzr[H + j] = d_zf;
  dzr[2 * H + j] = d_zo;
  dzr[3 * H + j] = d_zg;
  if (cn_o != nullptr) *cn_o = cn;
  *dc_o = (1.0f - mc) * d_c + (d_cnew * fg + d_zi * pij + d_zf * pfj);
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
  cell_bwd<RT>(z_t + (size_t)b * K, to_f<RT>(cp_t[o]), pi[j], pf[j], po[j],
               mask_t[b], dout_t[o], d_h, dc + o, dz_t + (size_t)b * K,
               cn_t != nullptr ? cn_t + o : nullptr, H, j);
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


// ------------------------------------------- one persistent launch (f32)

namespace k10 {

constexpr int THREADS = 256;      // 16 x 16 threads, each rows 4 ty .. +3
constexpr int ROWS = 64;          // rows of one row block
constexpr int KC = 32;            // depth of one d_z stage
constexpr int NST = 3;            // d_z stages in the ring
constexpr int STAGE = ROWS * KC;  // floats of one d_z stage
constexpr size_t SMEM_LIMIT = 232448;

// A thread's NJ columns (5 or 10) of a column group of up to 16 NJ (the
// w_t slice's pitch): 4 tx .. +3, for NJ = 10 also 64 + 4 tx .. +3, then
// one column in each of the last two (one) 16-wide strips
template <int NJ>
__device__ __forceinline__ int col_of(int j, int tx) {
  if (j < 4) return 4 * tx + j;
  if (NJ == 10 && j < 8) return 64 + 4 * tx + j - 4;
  return (NJ == 10 ? 128 : 64) + 16 * (j - (NJ == 10 ? 8 : 4)) + tx;
}

inline int cols_of(int CW) { return CW > 80 ? 160 : 80; }

inline size_t smem_bytes(int KW, int CW) {
  return ((size_t)KW * cols_of(CW) + NST * STAGE) * sizeof(float);
}

}  // namespace k10

// part [KG, B, H] f32 scratch; bar [1] u32, zero.  One block per SM; NJ
// columns a thread (CW <= 16 NJ).
template <typename RT, int NJ>
__global__ void __launch_bounds__(k10::THREADS, 1) lstm_bwd_persistent_kernel(
    const float* __restrict__ dout, const float* __restrict__ mask,
    const RT* __restrict__ z, const RT* __restrict__ cprev,
    const float* __restrict__ w_t, const float* __restrict__ pi,
    const float* __restrict__ pf, const float* __restrict__ po,
    float* __restrict__ dz, float* __restrict__ cn, float* __restrict__ dh,
    float* __restrict__ dc, float* __restrict__ part, unsigned* bar, int T,
    int B, int H, int KG, int KW, int CW) {
  constexpr int COLS = 16 * NJ;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [KW][COLS] of w_t
  // [NST][ROWS][KC] of d_z: the 16-byte piece q of row r at q ^ (r % 8)
  float* dzs = ws + (size_t)KW * COLS;
  const int K = 4 * H;
  const int kg = blockIdx.x % KG, cg = blockIdx.x / KG;
  const int k0 = kg * KW, k1 = min(K, k0 + KW);
  const int c0 = cg * CW, cw = min(CW, H - c0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int e = threadIdx.x; e < KW * COLS; e += k10::THREADS) {
    const int kk = e / COLS, c = e % COLS;
    ws[e] = (k0 + kk < k1 && c < cw) ? w_t[(size_t)(k0 + kk) * H + c0 + c]
                                     : 0.0f;
  }

  const size_t zs = (size_t)B * K, hs = (size_t)B * H;
  const int nkc = (k1 - k0 + k10::KC - 1) / k10::KC;
  const int items = (B + k10::ROWS - 1) / k10::ROWS * nkc;
  const int gtid = blockIdx.x * k10::THREADS + threadIdx.x;
  const int gthreads = gridDim.x * k10::THREADS;
  unsigned target = 0;

  // item n (row block n / nkc, k chunk n % nkc) of d_z rows into stage st:
  // each thread copies two 16-byte pieces; k1 - k is a multiple of 4, so a
  // piece is whole or past the range (zeros)
  auto issue = [&](const float* src, int n, int st) {
    if (n < items) {
      const int r0 = n / nkc * k10::ROWS, kb = k0 + n % nkc * k10::KC;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = threadIdx.x + u * k10::THREADS;
        const int r = p / 8, q = p % 8;
        const int b = r0 + r, kk = kb + 4 * q;
        const bool ok = b < B && kk < k1;
        pk::cp_async16(
            dzs + st * k10::STAGE + r * k10::KC + 4 * (q ^ (r & 7)),
            ok ? src + (size_t)b * K + kk : src, ok ? 16 : 0);
      }
    }
    pk::cp_async_commit();              // an empty group past the end
  };

  // phase 2 of step s (prod: d_h takes step s's product) and the cell
  // math of step t = s - 1 (t >= 0)
  auto combine = [&](bool prod, int s, int t) {
    for (int e = gtid; e < B * H; e += gthreads) {
      const int b = e / H, j = e % H;
      float d_h = dh[e];
      if (prod) {
        float sum = 0.0f;
        for (int g = 0; g < KG; ++g)
          sum += __ldcg(part + ((size_t)g * B + b) * H + j);
        const float ms = mask[(size_t)s * B + b] > 0.0f ? 1.0f : 0.0f;
        d_h = (1.0f - ms) * d_h + sum;
        dh[e] = d_h;
      }
      if (t < 0) continue;
      cell_bwd<RT>(z + t * zs + (size_t)b * K, to_f<RT>(cprev[t * hs + e]),
                   pi[j], pf[j], po[j], mask[(size_t)t * B + b],
                   dout[t * hs + e], d_h, dc + e, dz + t * zs + (size_t)b * K,
                   cn != nullptr ? cn + t * hs + e : nullptr, H, j);
    }
  };

  combine(false, T, T - 1);
  for (int s = T - 1; s >= 0; --s) {
    pk::grid_sync(bar, target);         // d_z[s] complete
    const float* src = dz + s * zs;
    issue(src, 0, 0);
    issue(src, 1, 1);
    float acc[4][NJ];
    for (int n = 0; n < items; ++n) {
      const int c = n % nkc;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
      }
      pk::cp_async_wait<1>();           // item n has landed (this thread's)
      __syncthreads();                  // ... everyone's; stage n - 1 free
      issue(src, n + 2, (n + 2) % k10::NST);
      const float* d = dzs + (n % k10::NST) * k10::STAGE;
      const float* wr = ws + (size_t)c * k10::KC * COLS;
#pragma unroll 2
      for (int q = 0; q < k10::KC / 4; ++q) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * ty + i;
          a[i] = *reinterpret_cast<const float4*>(
              d + r * k10::KC + 4 * (q ^ (r & 7)));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* wk = wr + (4 * q + e) * COLS;
          float wv[NJ];
#pragma unroll
          for (int h = 0; h < NJ / 5; ++h) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(wk + 64 * h + 4 * tx);
            wv[4 * h] = v4.x;
            wv[4 * h + 1] = v4.y;
            wv[4 * h + 2] = v4.z;
            wv[4 * h + 3] = v4.w;
          }
#pragma unroll
          for (int j = 4 * (NJ / 5); j < NJ; ++j)
            wv[j] = wk[k10::col_of<NJ>(j, tx)];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                           : e == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] += av * wv[j];
          }
        }
      }
      if (c == nkc - 1) {
        const int r0 = n / nkc * k10::ROWS;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = r0 + 4 * ty + i;
          if (b >= B) continue;
          float* prow = part + ((size_t)kg * B + b) * H + c0;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = k10::col_of<NJ>(j, tx);
            if (col < cw) prow[col] = acc[i][j];
          }
        }
      }
    }
    pk::cp_async_wait<0>();
    pk::grid_sync(bar, target);         // every partial of step s written
    combine(true, s, s - 1);
  }
}

template <typename RT, int NJ>
int persistent_launch(void** args, int blocks, size_t smem,
                      cudaStream_t stream) {
  return pk::cooperative_launch(lstm_bwd_persistent_kernel<RT, NJ>, args,
                                blocks, k10::THREADS, smem, stream);
}

template <typename RT>
int lstm_bwd_persistent_launch(const float* dout, const float* mask,
                               const RT* z, const RT* cprev, const float* w_t,
                               const float* pi, const float* pf,
                               const float* po, float* dz, float* cn,
                               float* dh, float* dc, float* part,
                               unsigned* bar, int T, int B, int H, int KG,
                               int KW, int CW, cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  if (KG < 1 || KW < 1 || KW % k10::KC != 0 || CW < 1 || CW > 160 ||
      (long long)KG * KW < 4LL * H || (long long)(KG - 1) * KW >= 4LL * H)
    return (int)cudaErrorInvalidValue;
  const int blocks = KG * ((H + CW - 1) / CW);
  const size_t smem = k10::smem_bytes(KW, CW);
  if (smem > k10::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  void* args[] = {&dout, &mask, &z,  &cprev, &w_t, &pi, &pf, &po, &dz,
                  &cn,   &dh,   &dc, &part,  &bar, &T,  &B,  &H,  &KG,
                  &KW,   &CW};
  return CW > 80 ? persistent_launch<RT, 10>(args, blocks, smem, stream)
                 : persistent_launch<RT, 5>(args, blocks, smem, stream);
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

// The persistent kernel (see _lstm_bwd_path / _lstm_bwd_plan): the same
// arguments as lstm_backward, then part [KG, B, H] f32 scratch, bar [1]
// u32 zeroed, and the plan: KG k-groups of KW rows of w_t (KW a multiple
// of 32), column groups of CW <= 160 units (ceil(H / CW) of them).
extern "C" int lstm_backward_persistent(
    const void* dout, const void* mask, const void* z, const void* cprev,
    const void* w_t, const void* pi, const void* pf, const void* po,
    void* dz, void* cn, void* dh, void* dc, void* part, void* bar,
    int res_bf16, int T, int B, int H, int KG, int KW, int CW,
    void* stream) {
  if (res_bf16) {
    return lstm_bwd_persistent_launch<__nv_bfloat16>(
        (const float*)dout, (const float*)mask, (const __nv_bfloat16*)z,
        (const __nv_bfloat16*)cprev, (const float*)w_t, (const float*)pi,
        (const float*)pf, (const float*)po, (float*)dz, (float*)cn,
        (float*)dh, (float*)dc, (float*)part, (unsigned*)bar, T, B, H, KG,
        KW, CW, (cudaStream_t)stream);
  }
  return lstm_bwd_persistent_launch<float>(
      (const float*)dout, (const float*)mask, (const float*)z,
      (const float*)cprev, (const float*)w_t, (const float*)pi,
      (const float*)pf, (const float*)po, (float*)dz, (float*)cn, (float*)dh,
      (float*)dc, (float*)part, (unsigned*)bar, T, B, H, KG, KW, CW,
      (cudaStream_t)stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: persistent with KW x CW of w_t, f32
// residuals; 1: per-step, f32 residuals)
extern "C" int lstm_backward_info(int which, int KW, int CW, int* regs,
                                  int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn =
      which == 1 ? (const void*)lstm_bwd_step_kernel<float>
      : CW > 80  ? (const void*)lstm_bwd_persistent_kernel<float, 10>
                 : (const void*)lstm_bwd_persistent_kernel<float, 5>;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k10::smem_bytes(KW, CW) : 0);
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

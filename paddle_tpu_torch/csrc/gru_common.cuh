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
// The "steps" paths (the forward under f32, and either loop where its
// plan does not fit): two small kernels a step, from a host loop (the
// launch boundary is the grid-wide barrier each step's row-wide products
// need).  Each block owns a 32 x 32 output tile and sums over k in a FIXED
// order, so a row's bits depend only on that row's inputs and its
// direction's weight: never on B, nor on which other rows share the call.
//
// The forward's "persistent" path (K3, K3r and K11's forward under bf16
// where ops/kernels/gru.py::_gru_fwd_plan fits): the whole forward loop in
// ONE cooperative launch (csrc/persistent.cuh), bf16 W resident in shared
// memory.  Block (direction, unit group ug, row group rg) holds the three
// gate columns j, H + j and 2H + j of its NU = 16 units j = 16 ug .. over
// the full depth H (49,152 bytes at H = 512), so every output it computes
// is complete.  Its warps each take one 16-row tile at a time (the tiles
// rg, rg + RG, ... of its direction), and a lane's mma accumulator entries
// are the same (row, unit) pairs in both products, so the f32 carry h and
// the gate u of those pairs stay in the block's shared memory, each read
// and written by its own thread.  A step is two phases, each ended by a
// grid barrier:
//   (A) [zr_r | zr_u] = xp[t, :, :2H] + round(h) @ W[:, :2H] for the
//       block's units; the epilogue forms r and u, keeps u, stores the
//       residuals zr and h_prev[t], and writes round(r * h) (rounded once,
//       from the f32 product, as the steps path does) to a global bf16
//       buffer;
//   (B) zc = xp[t, :, 2H:] + round(r * h) @ W[:, 2H:]; the epilogue stores
//       zc, updates the carry with the mask hold, writes h_seq[t] and
//       round(h) to a global bf16 buffer, the next phase A's operand.
// The products run on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 accumulators), each lane's operand a 16-byte load from L2 (ld.cg:
// other blocks wrote it), W kept in the B fragments' register order.  A
// product's k order depends on H alone, so a row's bits depend neither on
// B nor on the block that computes it, and the elementwise math is the
// steps kernels' (the same functions, in the same order): the two paths
// differ only in the products' summation order.
//
// The reverse's "persistent" path (K4 and K11's reverse where
// ops/kernels/gru.py::_gru_bwd_plan fits): the whole reverse loop in ONE
// cooperative launch (csrc/persistent.cuh), w_t resident in shared memory.
// Block (direction, column group cg, row group rg) holds its direction's
// w_t[:, 32 cg .. 32 cg + 31] over the full depth 3H (196,608 bytes of f32
// at H = 512), so every output it computes is complete: no partial sums
// cross blocks, and each product's epilogue fuses the step's elementwise
// math, its inputs loaded as the tile starts so that their latency hides
// behind the tile's products.  A step is two phases, each ended by a grid
// barrier:
//   (1) d_rh = d_zc @ W_c^T over the block's row tiles; the epilogue
//       writes d_z[t] (all three gate blocks) and part = d_hnew u + d_rh r;
//   (2) d_zr @ W_g^T from the d_z[t] rows just written; the epilogue adds
//       part, updates the carry d_c and forms the next step's d_zc, the
//       operand of the next phase (1).
// Rows are taken in 16-row tiles, round-robin over the row groups, so any
// B up to the wrapper's limit runs on the same blocks.  Each tile's
// operand streams from L2 through a two-stage cp.async ring of [16 x 256]
// f32 stages; the 8 warps take interleaved 32-deep slices of each stage,
// each thread a 4-row x 4-column register tile, and the 8 slices' partials
// meet in shared memory, added in slice order.  Every order depends on H
// alone, so a row's bits do not depend on B or on the row group that
// computes it, and K11's rows equal two K4 calls' bit for bit.
//
// The bidirectional batch (split > 0, B = 2 * split): rows [0, split) use
// direction 0's weight and rows [split, B) direction 1's.  The steps
// kernels' row blocks are cut per direction -- ceil(split / BM) blocks over
// [0, split), then as many over [split, B) -- and the persistent kernel's
// blocks each serve one direction, so no tile straddles the split for any
// split, and each row meets exactly the arithmetic of a one-direction call
// on the same path.  The forward's weight is the reference's [2H, 3H]
// (direction 1 starts H * 3H elements in); the reverse's is the
// reference's column-stacked [3H, 2H] (direction 1 starts H columns in,
// row stride 2H).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "persistent.cuh"

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
// forward, one persistent launch (bf16 compute)
// ---------------------------------------------------------------------------

namespace k3 {

constexpr int THREADS = 256;      // 8 warps, one 16-row tile at a time each
constexpr int WARPS = THREADS / 32;
constexpr int NUT = 2;            // n8 tiles of units a block
constexpr int NU = 8 * NUT;       // units a block, three gate columns each
constexpr size_t SMEM_LIMIT = 232448;

// W's B fragments (the gate product's [H / 16][2 NUT][32] and the
// candidate's [H / 16][NUT][32], 8 bytes a lane) and the f32 carry h and
// gate u of R rows x NU units
inline size_t smem_bytes(int H, int R) {
  return (size_t)H / 16 * 3 * NUT * 32 * 8 + (size_t)2 * R * NU * 4;
}

// two neighbouring entries in the residual type
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace k3

// xp [T, B, 3H] f32 and mask [T, B] f32 time-major, w [ndir H, 3H] bf16;
// h [B, H] f32 in: h0, out: h_final; hb and rhb [B, H] bf16 scratch
// (round(h), round(r * h)); bar [1] u32, zero.  ndir = split > 0 ? 2 : 1
// directions x UG = H / NU unit groups x RG row groups; R rows of carry a
// block (16 x the most tiles a row group takes).  z == nullptr: no
// residuals.
template <typename RT>
__global__ void __launch_bounds__(k3::THREADS, 1) gru_fwd_persistent_kernel(
    const float* __restrict__ xp, const float* __restrict__ mask,
    const __nv_bfloat16* __restrict__ w, float* __restrict__ h_seq,
    float* __restrict__ h, __nv_bfloat16* __restrict__ hb,
    __nv_bfloat16* __restrict__ rhb, RT* __restrict__ z,
    RT* __restrict__ hprev, unsigned* bar, int T, int B, int H, int split,
    int UG, int RG, int R) {
  constexpr int NU = k3::NU, NUT = k3::NUT;
  extern __shared__ float4 smem4[];
  const int K16 = H / 16, H3 = 3 * H;
  uint2* wf1 = reinterpret_cast<uint2*>(smem4);       // [K16][2 NUT][32]
  uint2* wf2 = wf1 + (size_t)K16 * 2 * NUT * 32;       // [K16][NUT][32]
  float* hs = reinterpret_cast<float*>(wf2 + (size_t)K16 * NUT * 32);
  float* us = hs + (size_t)R * NU;                     // [R][NU] each
  const int per_dir = UG * RG;
  const int dir = blockIdx.x / per_dir;
  const int ug = blockIdx.x % per_dir % UG, rg = blockIdx.x % per_dir / UG;
  const int rows = split > 0 ? split : B;    // rows of this direction
  const int rbase = dir * rows;              // its first row
  const int u0 = ug * NU;
  const __nv_bfloat16* wd = w + (size_t)dir * H * H3;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;

  // W's columns in B-fragment order (the row stride is 3H)
  pk::pack_b_fragments(wf1, H, 2 * NUT, [&](int n, int& ld) {
    ld = H3;                            // r columns, then u columns
    return wd + (n < NU ? u0 + n : H + u0 + (n - NU));
  });
  pk::pack_b_fragments(wf2, H, NUT, [&](int n, int& ld) {
    ld = H3;
    return wd + 2 * H + u0 + n;
  });

  const int ntile = (rows + 15) / 16;
  const int mine = rg < ntile ? (ntile - rg + RG - 1) / RG : 0;
  // the carry from h0 for this block's pairs, [local tile][row][unit];
  // round(h0) is step 0's operand
  for (int e = threadIdx.x; e < mine * 16 * NU; e += k3::THREADS) {
    const int b = (rg + e / (16 * NU) * RG) * 16 + e / NU % 16;
    float hv = 0.0f;
    if (b < rows) {
      const size_t o = (size_t)(rbase + b) * H + u0 + e % NU;
      hv = h[o];
      hb[o] = __float2bfloat16_rn(hv);
    }
    hs[e] = hv;
  }
  unsigned target = 0;
  pk::grid_sync(bar, target);           // round(h0) complete

  const size_t hsz = (size_t)B * H, xsz = (size_t)B * H3;
  const __nv_bfloat16* hb_d = hb + (size_t)rbase * H;
  const __nv_bfloat16* rhb_d = rhb + (size_t)rbase * H;
  for (int t = 0; t < T; ++t) {
    const float* xp_t = xp + t * xsz;
    const float* mask_t = mask + (size_t)t * B;
    // (A) [zr_r | zr_u] = xp[t, :, :2H] + round(h) @ W[:, :2H]; lane
    // entry (ut, i) is row row0 + g + 8 (i / 2), unit u0 + 8 ut + 2c + i % 2
    for (int lt = warp; lt < mine; lt += k3::WARPS) {
      const int row0 = (rg + lt * RG) * 16;
      float2 xr[NUT][2], xu[NUT][2];   // xp[t], loaded before the product
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int b = row0 + g + 8 * hr;
          const float* x = xp_t + (size_t)(rbase + b) * H3 + u0 + 8 * ut
                           + 2 * c;
          xr[ut][hr] = b < rows ? *reinterpret_cast<const float2*>(x)
                                : make_float2(0.0f, 0.0f);
          xu[ut][hr] = b < rows ? *reinterpret_cast<const float2*>(x + H)
                                : make_float2(0.0f, 0.0f);
        }
      float acc[2 * NUT][4] = {};
      pk::warp_product(hb_d, H, row0, rows, H, wf1, acc);
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int b = row0 + g + 8 * hr;
          if (b >= rows) continue;
          const int j = u0 + 8 * ut + 2 * c;
          float* hsp = hs + (size_t)(lt * 16 + g + 8 * hr) * NU + 8 * ut
                       + 2 * c;
          float* usp = us + (hsp - hs);
          float zr[2], zu[2], rh[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            zr[q] = (q ? xr[ut][hr].y : xr[ut][hr].x) + acc[ut][2 * hr + q];
            zu[q] = (q ? xu[ut][hr].y : xu[ut][hr].x)
                    + acc[NUT + ut][2 * hr + q];
            const float r = sigmoid_f(zr[q]);
            usp[q] = sigmoid_f(zu[q]);
            rh[q] = r * hsp[q];
          }
          const size_t bg = (size_t)(rbase + b);
          k3::store2(rhb + bg * H + j, rh[0], rh[1]);
          if (z != nullptr) {
            RT* zt = z + t * xsz + bg * H3 + j;
            k3::store2(zt, zr[0], zr[1]);
            k3::store2(zt + H, zu[0], zu[1]);
            k3::store2(hprev + t * hsz + bg * H + j, hsp[0], hsp[1]);
          }
        }
    }
    pk::grid_sync(bar, target);         // round(r h) of step t complete
    // (B) zc = xp[t, :, 2H:] + round(r h) @ W[:, 2H:]; the update, the
    // mask hold, h_seq[t] and round(h)
    for (int lt = warp; lt < mine; lt += k3::WARPS) {
      const int row0 = (rg + lt * RG) * 16;
      float2 xc[NUT][2];
      float mv[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int b = row0 + g + 8 * hr;
        mv[hr] = b < rows ? mask_t[rbase + b] : 0.0f;
#pragma unroll
        for (int ut = 0; ut < NUT; ++ut)
          xc[ut][hr] = b < rows ? *reinterpret_cast<const float2*>(
                                      xp_t + (size_t)(rbase + b) * H3 + 2 * H
                                      + u0 + 8 * ut + 2 * c)
                                : make_float2(0.0f, 0.0f);
      }
      float acc[NUT][4] = {};
      pk::warp_product(rhb_d, H, row0, rows, H, wf2, acc);
#pragma unroll
      for (int ut = 0; ut < NUT; ++ut)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int b = row0 + g + 8 * hr;
          if (b >= rows) continue;
          const int j = u0 + 8 * ut + 2 * c;
          float* hsp = hs + (size_t)(lt * 16 + g + 8 * hr) * NU + 8 * ut
                       + 2 * c;
          const float* usp = us + (hsp - hs);
          float zc[2], hk[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            zc[q] = (q ? xc[ut][hr].y : xc[ut][hr].x) + acc[ut][2 * hr + q];
            const float cand = tanhf(zc[q]);
            const float hp = hsp[q], uu = usp[q];
            const float hn = uu * hp + (1.0f - uu) * cand;
            hk[q] = mv[hr] > 0.0f ? hn : hp;
            hsp[q] = hk[q];
          }
          const size_t bg = (size_t)(rbase + b);
          if (z != nullptr)
            k3::store2(z + t * xsz + bg * H3 + 2 * H + j, zc[0], zc[1]);
          k3::store2(h_seq + t * hsz + bg * H + j, hk[0] * mv[hr],
                     hk[1] * mv[hr]);
          k3::store2(hb + bg * H + j, hk[0], hk[1]);
        }
    }
    if (t + 1 < T) pk::grid_sync(bar, target);  // round(h) of step t done
  }
  __syncthreads();                      // the carry, in the init's order
  for (int e = threadIdx.x; e < mine * 16 * NU; e += k3::THREADS) {
    const int b = (rg + e / (16 * NU) * RG) * 16 + e / NU % 16;
    if (b < rows) h[(size_t)(rbase + b) * H + u0 + e % NU] = hs[e];
  }
}

// rows of carry a block of the persistent forward holds: 16 x the tiles
// of its direction's first row group
inline int fwd_rows_a_block(int rows, int RG) {
  return ((rows + 15) / 16 + RG - 1) / RG * 16;
}

template <typename RT>
int forward_persistent(const float* xp, const float* mask,
                       const __nv_bfloat16* w, float* h_seq, float* h,
                       __nv_bfloat16* hb, __nv_bfloat16* rhb, RT* z,
                       RT* hprev, unsigned* bar, int T, int B, int H,
                       int split, int UG, int RG, cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0 || split < 0) return (int)cudaErrorInvalidValue;
  if (split > 0 && B != 2 * split) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  if (H % 32 != 0 || UG != H / k3::NU || RG < 1)
    return (int)cudaErrorInvalidValue;
  int R = fwd_rows_a_block(split > 0 ? split : B, RG);
  const size_t smem = k3::smem_bytes(H, R);
  if (smem > k3::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int blocks = (split > 0 ? 2 : 1) * UG * RG;
  void* args[] = {&xp, &mask, &w, &h_seq, &h, &hb,    &rhb, &z,  &hprev,
                  &bar, &T,   &B, &H,     &split, &UG, &RG, &R};
  return pk::cooperative_launch(gru_fwd_persistent_kernel<RT>, args, blocks,
                                k3::THREADS, smem, stream);
}

// residual type by flag: z == nullptr (inference) stores no residuals
inline int forward_persistent_dispatch(
    const void* xp, const void* mask, const void* w, void* h_seq, void* h,
    void* hb, void* rhb, void* z, void* hprev, void* bar, int res_bf16,
    int T, int B, int H, int split, int UG, int RG, void* stream) {
  if ((z == nullptr) != (hprev == nullptr)) return (int)cudaErrorInvalidValue;
  if (res_bf16) {
    return forward_persistent<__nv_bfloat16>(
        (const float*)xp, (const float*)mask, (const __nv_bfloat16*)w,
        (float*)h_seq, (float*)h, (__nv_bfloat16*)hb, (__nv_bfloat16*)rhb,
        (__nv_bfloat16*)z, (__nv_bfloat16*)hprev, (unsigned*)bar, T, B, H,
        split, UG, RG, (cudaStream_t)stream);
  }
  return forward_persistent<float>(
      (const float*)xp, (const float*)mask, (const __nv_bfloat16*)w,
      (float*)h_seq, (float*)h, (__nv_bfloat16*)hb, (__nv_bfloat16*)rhb,
      (float*)z, (float*)hprev, (unsigned*)bar, T, B, H, split, UG, RG,
      (cudaStream_t)stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of the forward kernel `which` (0: persistent at width H with R rows
// of carry a block; 1: the steps path's gates kernel, 2: its candidate
// kernel), bf16 compute and bf16 residuals
inline int forward_info(int which, int H, int R, int* regs, int* local_bytes,
                        int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn =
      which == 0
          ? (const void*)gru_fwd_persistent_kernel<__nv_bfloat16>
          : which == 1
                ? (const void*)gru_gates_kernel<__nv_bfloat16, __nv_bfloat16>
                : (const void*)gru_cand_kernel<__nv_bfloat16, __nv_bfloat16>;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k3::smem_bytes(H, R) : 0);
  return 0;
}

// ---------------------------------------------------------------------------
// reverse
// ---------------------------------------------------------------------------

// d_zc[b, k] and its inputs for one carry element (b, k) of step t
struct CandGrad {
  float d_hnew, u, cand, d_zc;
};

// from the values: d_out[t], the mask, the pre-activations z_u and z_c
// (widened) and the carry d_c
__device__ __forceinline__ CandGrad cand_grad_v(float dout, float m,
                                                float zu, float zc,
                                                float dc) {
  CandGrad g;
  const float mcol = m > 0.0f ? 1.0f : 0.0f;
  g.d_hnew = mcol * (dout + dc);
  g.u = sigmoid_f(zu);
  g.cand = tanhf(zc);
  g.d_zc = g.d_hnew * (1.0f - g.u) * (1.0f - g.cand * g.cand);
  return g;
}

template <typename RT>
__device__ __forceinline__ CandGrad cand_grad(
    const float* __restrict__ dout_t, float m, const RT* __restrict__ z_t,
    const float* __restrict__ dc, int b, int k, int H) {
  return cand_grad_v(dout_t[(size_t)b * H + k], m,
                     to_f<RT>(z_t[(size_t)b * 3 * H + H + k]),
                     to_f<RT>(z_t[(size_t)b * 3 * H + 2 * H + k]),
                     dc[(size_t)b * H + k]);
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


// ---------------------------------------------------------------------------
// reverse, one persistent launch
// ---------------------------------------------------------------------------

namespace k4 {

constexpr int THREADS = 256;      // 8 warps, one 32-deep slice of a stage each
constexpr int WARPS = THREADS / 32;
constexpr int CW = 32;            // w_t columns a block
constexpr int ROWS = 16;          // rows of one tile
constexpr int KC = 256;           // depth of one operand stage
constexpr int KS = KC / WARPS;    // a warp's slice of a stage
constexpr int NST = 2;            // operand stages in the ring
constexpr int STAGE = ROWS * KC;  // floats of one stage
constexpr size_t SMEM_LIMIT = 232448;

// a product's depth, padded to whole stages (w_t's pad rows are zeros)
__host__ __device__ inline int kpad(int K) { return (K + KC - 1) / KC * KC; }

inline size_t smem_bytes(int H) {
  return ((size_t)kpad(H) + kpad(2 * H)) * CW * sizeof(float) +
         (size_t)NST * STAGE * sizeof(float);
}

}  // namespace k4

// the epilogues' inputs of one (row, column) pair, loaded as its tile
// starts: (1) d_out[t], mask[t], z[t]'s r, u, c, h_prev[t], d_c; (2) the
// partial, d_c, mask[t], and step t - 1's d_out, mask, z_u and z_c
struct Pre1 {
  float dout, m, zr, zu, zc, hp, dc;
};
struct Pre2 {
  float part, dc, m, dout_n, m_n, zu_n, zc_n;
};

// dzc [B, H] f32 scratch (each step's d_zc, the first product's operand),
// part [B, H] f32 scratch; bar [1] u32, zero.  ndir = split > 0 ? 2 : 1
// directions x CG column groups (CG = ceil(H / 32)) x RG row groups.
template <typename RT>
__global__ void __launch_bounds__(k4::THREADS, 1) gru_bwd_persistent_kernel(
    const float* __restrict__ dout, const float* __restrict__ mask,
    const RT* __restrict__ z, const RT* __restrict__ hprev,
    const float* __restrict__ w_t, float* __restrict__ dz,
    float* __restrict__ dc, float* __restrict__ dzc,
    float* __restrict__ part, unsigned* bar, int T, int B, int H, int split,
    int CG, int RG) {
  extern __shared__ float4 smem4[];
  const int K1p = k4::kpad(H), K2p = k4::kpad(2 * H);
  // w_t rows [0, 2H) (the second product's), then rows [2H, 3H) (the
  // first's), each [depth][CW], zero past H or 2H and past the columns
  float* ws2 = reinterpret_cast<float*>(smem4);
  float* ws1 = ws2 + (size_t)K2p * k4::CW;
  // the operand ring: [NST][ROWS][KC], the 16-byte piece q of row r at
  // q ^ (r % 8); a stage also takes the 8 slices' partials of a tile
  float* ring = ws1 + (size_t)K1p * k4::CW;
  const int per_dir = CG * RG;
  const int dir = blockIdx.x / per_dir;
  const int cg = blockIdx.x % per_dir % CG, rg = blockIdx.x % per_dir / CG;
  const int rows = split > 0 ? split : B;    // rows of this direction
  const int rbase = dir * rows;              // its first row
  const int c0 = cg * k4::CW, cw = min(k4::CW, H - c0);
  const int ldw = split > 0 ? 2 * H : H;
  const float* wd = w_t + (size_t)dir * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rq = lane / 8, cq = lane % 8;    // rows rq + 4 i, columns 4 cq..

  for (int e = threadIdx.x; e < (K1p + K2p) * k4::CW; e += k4::THREADS) {
    const int kk = e / k4::CW, c = e % k4::CW;
    const int k = kk < K2p ? kk : 2 * H + (kk - K2p);
    const bool ok = (kk < K2p ? kk < 2 * H : kk - K2p < H) && c < cw;
    ws2[e] = ok ? wd[(size_t)k * ldw + c0 + c] : 0.0f;
  }

  const int ntile = (rows + k4::ROWS - 1) / k4::ROWS;
  const int mine = rg < ntile ? (ntile - rg + RG - 1) / RG : 0;
  const size_t zs = (size_t)B * 3 * H, hs = (size_t)B * H;

  // one product over this block's tiles: out(b, j) = sum_k A[b, k] *
  // wsm[k, j - c0] for k < K, A's rows lda apart; epi(b, j, out, pre(b,
  // j)) for each of this block's (row, column) pairs, each by one thread
  // (the same in both products); pre's loads are issued as the tile
  // starts, so their latency hides behind the tile's products
  constexpr int OWN = k4::ROWS * k4::CW / k4::THREADS;   // pairs a thread
  auto product = [&](const float* A, int lda, int K, const float* wsm,
                     auto pre, auto epi) {
    decltype(pre(0, 0)) pv[OWN];
    const int nkc = (K + k4::KC - 1) / k4::KC;
    const int items = mine * nkc;
    // item n (tile n / nkc, stage n % nkc of the depth) into its stage:
    // four 16-byte pieces a thread; K % 4 == 0, so a piece is whole or
    // past the end (zeros)
    auto issue = [&](int n) {
      if (n < items) {
        const int r0 = (rg + n / nkc * RG) * k4::ROWS, kb = n % nkc * k4::KC;
        float* st = ring + (n % k4::NST) * k4::STAGE;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = threadIdx.x + u * k4::THREADS;
          const int r = p / (k4::KC / 4), q = p % (k4::KC / 4);
          const int lr = r0 + r, k = kb + 4 * q;
          const bool ok = lr < rows && k < K;
          pk::cp_async16(st + r * k4::KC + 4 * (q ^ (r & 7)),
                         ok ? A + (size_t)(rbase + lr) * lda + k : A,
                         ok ? 16 : 0);
        }
      }
      pk::cp_async_commit();            // an empty group past the end
    };
    issue(0);
    issue(1);
    float acc[4][4];
    for (int n = 0; n < items; ++n) {
      const int kc = n % nkc;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        const int r0 = (rg + n / nkc * RG) * k4::ROWS;
#pragma unroll
        for (int u = 0; u < OWN; ++u) {
          const int e = threadIdx.x + u * k4::THREADS;
          const int r = e / k4::CW, c = e % k4::CW;
          if (r0 + r < rows && c < cw) pv[u] = pre(rbase + r0 + r, c0 + c);
        }
      }
      pk::cp_async_wait<1>();           // item n has landed (this thread's)
      __syncthreads();                  // ... everyone's
      float* st = ring + (n % k4::NST) * k4::STAGE;
      const float* wk = wsm + (size_t)(kc * k4::KC + warp * k4::KS) * k4::CW
                        + 4 * cq;
#pragma unroll 2
      for (int q4 = 0; q4 < k4::KS / 4; ++q4) {
        const int q = warp * (k4::KS / 4) + q4;
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rq + 4 * i;
          a[i] = *reinterpret_cast<const float4*>(st + r * k4::KC
                                                  + 4 * (q ^ (r & 7)));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 w = *reinterpret_cast<const float4*>(
              wk + (size_t)(4 * q4 + e) * k4::CW);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                           : e == 2 ? a[i].z : a[i].w;
            acc[i][0] += av * w.x;
            acc[i][1] += av * w.y;
            acc[i][2] += av * w.z;
            acc[i][3] += av * w.w;
          }
        }
      }
      if (kc == nkc - 1) {              // the tile's depth is done
        __syncthreads();                // every warp is done with the stage
        // the slices' partials [WARPS][ROWS][CW] into the stage
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(
              st + (warp * k4::ROWS + rq + 4 * i) * k4::CW + 4 * cq) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        __syncthreads();
        const int r0 = (rg + n / nkc * RG) * k4::ROWS;
#pragma unroll
        for (int u = 0; u < OWN; ++u) {
          const int e = threadIdx.x + u * k4::THREADS;
          const int r = e / k4::CW, c = e % k4::CW;
          if (r0 + r >= rows || c >= cw) continue;
          float v = 0.0f;
#pragma unroll
          for (int g = 0; g < k4::WARPS; ++g)
            v += st[(g * k4::ROWS + r) * k4::CW + c];
          epi(rbase + r0 + r, c0 + c, v, pv[u]);
        }
      }
      __syncthreads();                  // stage n % NST is free
      issue(n + 2);
    }
    pk::cp_async_wait<0>();
  };

  // d_zc of step T - 1 from d_hfin, for this block's pairs
  for (int i = 0; i < mine; ++i) {
    const int r0 = (rg + i * RG) * k4::ROWS;
    for (int e = threadIdx.x; e < k4::ROWS * k4::CW; e += k4::THREADS) {
      const int r = e / k4::CW, c = e % k4::CW;
      const int b = rbase + r0 + r, j = c0 + c;
      if (r0 + r < rows && c < cw)
        dzc[(size_t)b * H + j] =
            cand_grad<RT>(dout + (T - 1) * hs, mask[(size_t)(T - 1) * B + b],
                          z + (T - 1) * zs, dc, b, j, H).d_zc;
    }
  }
  unsigned target = 0;
  pk::grid_sync(bar, target);           // d_zc of step T - 1 complete

  for (int t = T - 1; t >= 0; --t) {
    const float* dout_t = dout + t * hs;
    const float* mask_t = mask + (size_t)t * B;
    const RT* z_t = z + t * zs;
    const RT* hp_t = hprev + t * hs;
    float* dz_t = dz + t * zs;
    // (1) d_rh = d_zc @ W_c^T; d_z[t] and part from the step's inputs
    const auto pre1 = [&](int b, int j) {
      const size_t o = (size_t)b * H + j;
      const RT* zr = z_t + (size_t)b * 3 * H;
      return Pre1{dout_t[o], mask_t[b], to_f<RT>(zr[j]), to_f<RT>(zr[H + j]),
                  to_f<RT>(zr[2 * H + j]), to_f<RT>(hp_t[o]), dc[o]};
    };
    product(dzc, H, H, ws1, pre1, [&](int b, int j, float d_rh,
                                      const Pre1& p) {
      const CandGrad g = cand_grad_v(p.dout, p.m, p.zu, p.zc, p.dc);
      const float r = sigmoid_f(p.zr);
      const float d_u = g.d_hnew * (p.hp - g.cand);
      const float d_r = d_rh * p.hp;
      float* dzr = dz_t + (size_t)b * 3 * H;
      dzr[j] = d_r * r * (1.0f - r);
      dzr[H + j] = d_u * g.u * (1.0f - g.u);
      dzr[2 * H + j] = g.d_zc;
      part[(size_t)b * H + j] = g.d_hnew * g.u + d_rh * r;
    });
    pk::grid_sync(bar, target);         // d_z[t] complete
    // (2) d_hp = part + d_zr @ W_g^T; the carry; step t - 1's d_zc
    const float* dout_n = dout + (t > 0 ? t - 1 : 0) * hs;
    const float* mask_n = mask + (size_t)(t > 0 ? t - 1 : 0) * B;
    const RT* z_n = z + (t > 0 ? t - 1 : 0) * zs;
    const auto pre2 = [&](int b, int j) {
      const size_t o = (size_t)b * H + j;
      const RT* zr = z_n + (size_t)b * 3 * H;
      return Pre2{part[o], dc[o], mask_t[b], dout_n[o], mask_n[b],
                  to_f<RT>(zr[H + j]), to_f<RT>(zr[2 * H + j])};
    };
    product(dz_t, 3 * H, 2 * H, ws2, pre2, [&](int b, int j, float acc,
                                               const Pre2& p) {
      const size_t o = (size_t)b * H + j;
      const float mcol = p.m > 0.0f ? 1.0f : 0.0f;
      const float d_hp = p.part + acc;
      const float d_c = (1.0f - mcol) * p.dc + d_hp;
      dc[o] = d_c;
      if (t > 0)
        dzc[o] = cand_grad_v(p.dout_n, p.m_n, p.zu_n, p.zc_n, d_c).d_zc;
    });
    if (t > 0) pk::grid_sync(bar, target);  // d_zc of step t - 1 complete
  }
}

template <typename RT>
int backward_persistent(const float* dout, const float* mask, const RT* z,
                        const RT* hprev, const float* w_t, float* dz,
                        float* dc, float* dzc, float* part, unsigned* bar,
                        int T, int B, int H, int split, int CG, int RG,
                        cudaStream_t stream) {
  if (T < 0 || B < 0 || H < 0 || split < 0) return (int)cudaErrorInvalidValue;
  if (split > 0 && B != 2 * split) return (int)cudaErrorInvalidValue;
  if (T == 0 || B == 0 || H == 0) return (int)cudaSuccess;
  if (H % 4 != 0 || CG != (H + k4::CW - 1) / k4::CW || RG < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k4::smem_bytes(H);
  if (smem > k4::SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int blocks = (split > 0 ? 2 : 1) * CG * RG;
  void* args[] = {&dout, &mask, &z, &hprev, &w_t, &dz, &dc, &dzc, &part,
                  &bar,  &T,    &B, &H,     &split, &CG, &RG};
  return pk::cooperative_launch(gru_bwd_persistent_kernel<RT>, args, blocks,
                                k4::THREADS, smem, stream);
}

inline int backward_persistent_dispatch(
    const void* dout, const void* mask, const void* z, const void* hprev,
    const void* w_t, void* dz, void* dc, void* dzc, void* part, void* bar,
    int res_bf16, int T, int B, int H, int split, int CG, int RG,
    void* stream) {
  if (res_bf16) {
    return backward_persistent<__nv_bfloat16>(
        (const float*)dout, (const float*)mask, (const __nv_bfloat16*)z,
        (const __nv_bfloat16*)hprev, (const float*)w_t, (float*)dz,
        (float*)dc, (float*)dzc, (float*)part, (unsigned*)bar, T, B, H, split,
        CG, RG, (cudaStream_t)stream);
  }
  return backward_persistent<float>(
      (const float*)dout, (const float*)mask, (const float*)z,
      (const float*)hprev, (const float*)w_t, (float*)dz, (float*)dc,
      (float*)dzc, (float*)part, (unsigned*)bar, T, B, H, split, CG, RG,
      (cudaStream_t)stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of the reverse kernel `which` (0: persistent at width H, 1: the
// steps path's cand kernel, 2: its gate kernel), f32 residuals
inline int backward_info(int which, int H, int* regs, int* local_bytes,
                         int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn = which == 0 ? (const void*)gru_bwd_persistent_kernel<float>
                   : which == 1 ? (const void*)gru_bwd_cand_kernel<float>
                                : (const void*)gru_bwd_gate_kernel;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k4::smem_bytes(H) : 0);
  return 0;
}

}  // namespace gru

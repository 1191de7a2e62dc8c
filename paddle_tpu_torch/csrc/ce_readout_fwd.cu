// Vocab-tiled readout + softmax cross-entropy, forward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::ce_readout_fwd_pallas (the
// _ce_fwd_kernel body), which the flagship's loss reaches through
// ops/losses.py::sequence_softmax_ce_readout (the tiled path).
//
// Computes, per row n of states [N, D] against w [D, V] and bias b [V]:
//     l          = states[n] @ w + b           (float32; operands in the
//                                               compute type CT)
//     logits[n]  = round_CT(l)                 (the backward's residual)
//     lse[n]     = logsumexp(l)                (online max / sum-exp over
//                                               the vocab tiles, in order)
//     per_tok[n] = lse[n] - l[labels[n]]       (the label logit unrounded)
// The ragged last vocab tile is masked here (its columns take no part in
// the statistics and are not written), which gives what the reference gets
// from padding w with zero columns and bias -1e30: exp of a padded column
// is 0.
//
// What bounds it on this card: at the training shape (N = B*T = 12288,
// D = 512, V = 30000) the call does 377 GFLOP, 0.38 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.23 ms to write the 737 MB bf16 logits
// residual: it is bound by operations.  So the bfloat16 path multiplies on
// the tensor cores (WMMA 16 x 16 x 16 bf16 fragments, float32
// accumulation; a bf16 product is exact in float32).  The float32 path
// (the f32 compute policy, which the tensor cores cannot take without
// TF32 rounding) multiplies in float32 FMAs on the CUDA cores.
//
// Design: the TPU grid walks (row block, vocab tile) with vocab innermost
// and carries the online statistics in VMEM scratch.  Here one block owns
// a 64-row tile and walks every vocab tile in order, so the running max,
// sum-exp and label logit live in registers for the whole walk and no
// second pass or atomics are needed.  N = 12288 gives 192 blocks (two fit
// on an SM).  Each 64 x 64 logits tile is a shared-memory tiled product
// over D in a fixed order (bf16: eight warps, each a 16 x 32 strip of WMMA
// fragments, staged through shared memory for the epilogue; f32: every
// thread a 4 x 4 patch); in the epilogue every thread owns a 4 x 4 patch,
// and the 16 threads sharing a row reduce its tile max and sum-exp by warp
// shuffles.  A row's result depends only on that row, never on N.  The
// tiles are loaded synchronously (no cp.async / TMA pipeline yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // vocab columns per tile
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 4 x 4 patch
constexpr int LDA = BK + 8;   // bf16 row pitch of a [*, BK] tile (80 bytes)
constexpr int LDB = BN + 8;   // bf16 row pitch of a [*, BN] tile (144 bytes)
constexpr int LDC = BN + 4;   // f32 row pitch of the staged accumulators

template <typename CT>
__device__ __forceinline__ float to_f(CT x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename CT>
__device__ __forceinline__ CT from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// reductions over the 16 lanes that share a row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the epilogue of one [BM, BN] logits tile held as acc[i][j] = the
// product at row ty + 16 i, column tx + 16 j: bias, residual store, online
// max / sum-exp, label logit
template <typename CT>
__device__ __forceinline__ void tile_epilogue(
    float acc[4][4], const float* __restrict__ bias, CT* __restrict__ logits,
    int row0, int v0, int N, int V, const int lab[4], float m_run[4],
    float s_run[4], float tok[4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + ty + 16 * i;
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = v0 + tx + 16 * j;
      if (col < V) {
        const float l = acc[i][j] + bias[col];
        acc[i][j] = l;
        if (n < N) logits[(size_t)n * V + col] = from_f<CT>(l);
        tmax = fmaxf(tmax, l);
        if (col == lab[i]) tok[i] += l;
      } else {
        acc[i][j] = -CUDART_INF_F;        // masked: exp() gives 0
      }
    }
    const float m_new = fmaxf(m_run[i], row_max(tmax));
    float ts = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ts += expf(acc[i][j] - m_new);
    ts = row_sum(ts);
    s_run[i] = s_run[i] * expf(m_run[i] - m_new) + ts;
    m_run[i] = m_new;
  }
}

// the end of the vocab walk: lse and per_tok of the thread's rows
__device__ __forceinline__ void write_stats(const float m_run[4],
                                            const float s_run[4],
                                            const float tok[4], int row0,
                                            int N, float* __restrict__ per_tok,
                                            float* __restrict__ lse_out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + ty + 16 * i;
    const float t = row_sum(tok[i]);
    if (tx == 0 && n < N) {
      const float lse = m_run[i] + logf(s_run[i]);
      lse_out[n] = lse;
      per_tok[n] = lse - t;
    }
  }
}

__device__ __forceinline__ void init_stats(const int* __restrict__ labels,
                                           int row0, int N, float m_run[4],
                                           float s_run[4], float tok[4],
                                           int lab[4]) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + ty + 16 * i;
    m_run[i] = -CUDART_INF_F;
    s_run[i] = 0.0f;
    tok[i] = 0.0f;
    lab[i] = n < N ? labels[n] : -1;
  }
}

// dst[r][c] = src[(r0 + r) * ld_src + c0 + c] for an R x C bf16 tile, zero
// outside rows < rmax, cols < cmax; 16-byte vectors where whole and aligned
template <int R, int C, int LD>
__device__ __forceinline__ void load_tile(bf16 (*dst)[LD],
                                          const bf16* __restrict__ src,
                                          size_t ld_src, int r0, int c0,
                                          int rmax, int cmax) {
  constexpr int VEC = 8;
  for (int e = threadIdx.x; e < R * C / VEC; e += THREADS) {
    const int r = e / (C / VEC), c = (e % (C / VEC)) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    const bf16* p = src + (size_t)gr * ld_src + gc;
    if (gr < rmax && gc + VEC <= cmax &&
        (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      *reinterpret_cast<uint4*>(&dst[r][c]) =
          *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        dst[r][c + q] = (gr < rmax && gc + q < cmax) ? p[q]
                                                     : __float2bfloat16(0.0f);
    }
  }
}

// float32 operands: CUDA-core FMAs
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel_f32(
    const float* __restrict__ S, const float* __restrict__ W,
    const float* __restrict__ bias, const int* __restrict__ labels,
    float* __restrict__ per_tok, float* __restrict__ lse_out,
    float* __restrict__ logits, int N, int D, int V) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM;

  float m_run[4], s_run[4], tok[4];
  int lab[4];
  init_stats(labels, row0, N, m_run, s_run, tok, lab);

  for (int v0 = 0; v0 < V; v0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gr = row0 + r, gk = k0 + c;
        As[r][c] = (gr < N && gk < D) ? S[(size_t)gr * D + gk] : 0.0f;
      }
      for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gc = v0 + c;
        Ws[r][c] = (gk < D && gc < V) ? W[(size_t)gk * V + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
      }
      __syncthreads();
    }

    tile_epilogue<float>(acc, bias, logits, row0, v0, N, V, lab, m_run,
                         s_run, tok);
  }
  write_stats(m_run, s_run, tok, row0, N, per_tok, lse_out);
}

// bfloat16 operands: tensor-core WMMA fragments.  Warp w computes rows
// 16 (w / 2) .. +16 and columns 32 (w % 2) .. +32 of the tile.
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel_bf16(
    const bf16* __restrict__ S, const bf16* __restrict__ W,
    const float* __restrict__ bias, const int* __restrict__ labels,
    float* __restrict__ per_tok, float* __restrict__ lse_out,
    bf16* __restrict__ logits, int N, int D, int V) {
  __shared__ __align__(32) bf16 As[BM][LDA];
  __shared__ __align__(32) bf16 Bs[BK][LDB];
  __shared__ __align__(32) float Cs[BM][LDC];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int row0 = blockIdx.x * BM;
  float m_run[4], s_run[4], tok[4];
  int lab[4];
  init_stats(labels, row0, N, m_run, s_run, tok, lab);

  for (int v0 = 0; v0 < V; v0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
    wmma::fill_fragment(c[0], 0.0f);
    wmma::fill_fragment(c[1], 0.0f);
    for (int k0 = 0; k0 < D; k0 += BK) {
      load_tile<BM, BK, LDA>(As, S, D, row0, k0, N, D);
      load_tile<BK, BN, LDB>(Bs, W, V, k0, v0, D, V);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[wr * 16][kk], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              b;
          wmma::load_matrix_sync(b, &Bs[kk][wc * 32 + j * 16], LDB);
          wmma::mma_sync(c[j], a, b, c[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr * 16][wc * 32 + j * 16], c[j], LDC,
                              wmma::mem_row_major);
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = Cs[ty + 16 * i][tx + 16 * j];
    tile_epilogue<bf16>(acc, bias, logits, row0, v0, N, V, lab, m_run,
                        s_run, tok);
    __syncthreads();        // Cs is rewritten by the next tile
  }
  write_stats(m_run, s_run, tok, row0, N, per_tok, lse_out);
}

template <typename CT, typename Kernel>
int ce_fwd_launch(Kernel kernel, const void* states, const void* w,
                  const void* bias, const void* labels, void* per_tok,
                  void* lse, void* logits, int N, int D, int V,
                  void* stream) {
  if (N < 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  kernel<<<(N + BM - 1) / BM, THREADS, 0, (cudaStream_t)stream>>>(
      (const CT*)states, (const CT*)w, (const float*)bias,
      (const int*)labels, (float*)per_tok, (float*)lse, (CT*)logits, N, D, V);
  return (int)cudaGetLastError();
}

}  // namespace

// states [N, D] and w [D, V] in the compute type, bias [V] f32, labels [N]
// int32 -> per_tok [N] f32, lse [N] f32, logits [N, V] in the compute type.
// Returns a cudaError_t.
extern "C" int ce_readout_fwd_f32(const void* states, const void* w,
                                  const void* bias, const void* labels,
                                  void* per_tok, void* lse, void* logits,
                                  int N, int D, int V, void* stream) {
  return ce_fwd_launch<float>(ce_fwd_kernel_f32, states, w, bias, labels,
                              per_tok, lse, logits, N, D, V, stream);
}

extern "C" int ce_readout_fwd_bf16(const void* states, const void* w,
                                   const void* bias, const void* labels,
                                   void* per_tok, void* lse, void* logits,
                                   int N, int D, int V, void* stream) {
  return ce_fwd_launch<bf16>(ce_fwd_kernel_bf16, states, w, bias, labels,
                             per_tok, lse, logits, N, D, V, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

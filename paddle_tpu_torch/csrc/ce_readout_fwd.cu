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
//     lse[n]     = logsumexp(l)                (online max / sum-exp)
//     per_tok[n] = lse[n] - l[labels[n]]       (the label logit unrounded)
// The ragged last vocab tile is masked here (its columns take no part in
// the statistics and are not written), which gives what the reference gets
// from padding w with zero columns and bias -1e30: exp of a padded column
// is 0.
//
// What bounds it on this card: at the training shape (N = B*T = 12288,
// D = 512, V = 30000) the call does 377 GFLOP, 0.38 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.23 ms to write the 737 MB bf16 logits
// residual: it is bound by operations.
//
// Three kernels, chosen by the wrapper from the shape and alignment alone
// (ops/kernels/ce_readout.py::_ce_path):
//
// ce_fwd_kernel_wgmma (bf16; D in {64, 128, 256, 512}, V % 8 == 0, 16-byte
// aligned operands: what TMA takes).  A block owns a 128-row tile and one
// chunk of CHUNK vocab columns, so the grid is (V / CHUNK) x (N / 128)
// blocks, 1440 at the training shape, ~11 waves on 132 SMs.  Its states
// tile (128 x D bf16, 128 KB at D = 512) is loaded once by TMA and stays in
// shared memory; w streams through a 4-stage TMA ring (64 deep x 128
// columns a stage) fed by one producer thread.  Two consumer warpgroups
// each run wgmma m64n128k16 over their 64 rows with float32 accumulators
// in registers, and the epilogue runs on those registers: bias, the bf16
// logits stored two at a time, the online (max, sum-exp) and the label
// logit, each row's values reduced over its 4 lanes by shuffles.  Each
// block writes its rows' partial (max, sum-exp, label logit) for its chunk;
// ce_fwd_combine_kernel folds them in chunk order into lse and per_tok.
// The chunks depend on V alone, so a row's results never depend on N.
//
// ce_fwd_kernel_bf16 (bf16, any other shape): one block a 64-row tile,
// walking every 64-column vocab tile in order; WMMA 16 x 16 x 16 fragments
// from synchronously loaded 32-deep tiles, staged through shared memory for
// the epilogue.  ce_fwd_kernel_f32 (the f32 compute policy, which the
// tensor cores cannot take without TF32 rounding): the same walk in
// float32 FMAs on the CUDA cores.  Both keep the running statistics in
// registers for the whole walk, and each 16 threads sharing a row reduce
// its tile max and sum-exp by warp shuffles.
//
// No atomics anywhere: every sum has a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <cstdint>

#include "hopper_tma_wgmma.cuh"

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

// ------------------------------------------------------- TMA + wgmma (bf16)

namespace k1 {

constexpr int BM = 128;        // rows per block: two consumer warpgroups
constexpr int BN = 128;        // vocab columns per tile (wgmma N)
constexpr int CHUNK = 2048;    // vocab columns per block (16 tiles)
constexpr int STAGES = 4;      // depth of the w ring
constexpr int THREADS = 384;   // warpgroups 0, 1 consume; 2 produces
constexpr int STAGE_BYTES = 64 * BN * 2;   // two 64 x 64 boxes of w
constexpr int BOX_BYTES = 64 * 64 * 2;

inline size_t smem_bytes(int D) {
  // 1024 for aligning the base, the states tile, the ring, the barriers
  return 1024 + (size_t)BM * D * 2 + STAGES * STAGE_BYTES + 128;
}

}  // namespace k1

// reductions over the 4 lanes that share a row of a wgmma accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// part [3, C, N]: each chunk's max, sum-exp and label logit of every row
__global__ void __launch_bounds__(k1::THREADS, 1) ce_fwd_kernel_wgmma(
    const __grid_constant__ CUtensorMap map_s,
    const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
    const int* __restrict__ labels, float* __restrict__ part,
    bf16* __restrict__ logits, int N, int D, int V) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_tile = smem;                          // D / 64 boxes [128][64]
  uint8_t* ring = smem + (size_t)k1::BM * D * 2;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + k1::STAGES * k1::STAGE_BYTES);
  uint64_t* empty = full + k1::STAGES;
  uint64_t* s_bar = empty + k1::STAGES;

  const int C = gridDim.x, chunk = blockIdx.x, row0 = blockIdx.y * k1::BM;
  const int v_begin = chunk * k1::CHUNK;
  const int v_end = min(V, v_begin + k1::CHUNK);
  const int n_tiles = (v_end - v_begin + k1::BN - 1) / k1::BN;
  const int kchunks = D / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < k1::STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);     // lane 0 of each consumer warp
    }
    hopper::mbar_init(s_bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&map_s);
      hopper::prefetch_map(&map_w);
      hopper::mbar_expect_tx(s_bar, (uint32_t)(k1::BM * D * 2));
      for (int kc = 0; kc < kchunks; ++kc)
        hopper::tma_load(s_tile + kc * (k1::BM * 128), &map_s, s_bar, kc * 64,
                         row0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int v0 = v_begin + t * k1::BN;
        for (int kc = 0; kc < kchunks; ++kc) {
          hopper::mbar_wait(&empty[stage], phase ^ 1u);
          hopper::mbar_expect_tx(&full[stage], k1::STAGE_BYTES);
          uint8_t* dst = ring + stage * k1::STAGE_BYTES;
          hopper::tma_load(dst, &map_w, &full[stage], v0, kc * 64);
          hopper::tma_load(dst + k1::BOX_BYTES, &map_w, &full[stage], v0 + 64,
                           kc * 64);
          if (++stage == k1::STAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    // this thread's two rows of the accumulator: r and r + 8
    const int n_row[2] = {row0 + 64 * wg + 16 * warp + lane / 4,
                          row0 + 64 * wg + 16 * warp + lane / 4 + 8};
    int lab[2];
    float m_run[2], s_run[2], tok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lab[h] = n_row[h] < N ? labels[n_row[h]] : -1;
      m_run[h] = -CUDART_INF_F;
      s_run[h] = 0.0f;
      tok[h] = 0.0f;
    }
    const uint32_t a_base = hopper::smem_u32(s_tile) + wg * 64 * 128;
    const uint32_t ring_base = hopper::smem_u32(ring);
    hopper::mbar_wait(s_bar, 0);

    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int ti = 0; ti < n_tiles; ++ti) {
      const int v0 = v_begin + ti * k1::BN;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int kc = 0; kc < kchunks; ++kc) {
        hopper::mbar_wait(&full[stage], phase);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
        const uint32_t a = a_base + kc * (k1::BM * 128);
        const uint32_t b = ring_base + stage * k1::STAGE_BYTES;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          hopper::wgmma_m64n128<0, 1>(acc, hopper::desc_kmajor(a, k),
                                      hopper::desc_mnmajor(b, k,
                                                           k1::BOX_BYTES));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();       // the previous stage's products done
        hopper::fence_regs(acc);
        if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == k1::STAGES) { stage = 0; phase ^= 1u; }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);

      // epilogue on the accumulators: acc[4j + 2h + e] is row n_row[h],
      // column v0 + 8j + 2 (lane % 4) + e
      float tmax[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < k1::BN / 8; ++j) {
        const int col = v0 + 8 * j + 2 * (lane % 4);
        // V % 8 == 0: col < V means col + 1 < V too
        const float2 bb = col < V
            ? *reinterpret_cast<const float2*>(&bias[col])
            : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
          if (col < V) {
            x0 = acc[4 * j + 2 * h] + bb.x;
            x1 = acc[4 * j + 2 * h + 1] + bb.y;
            if (n_row[h] < N)
              *reinterpret_cast<__nv_bfloat162*>(
                  &logits[(size_t)n_row[h] * V + col]) =
                  __floats2bfloat162_rn(x0, x1);
            tmax[h] = fmaxf(tmax[h], fmaxf(x0, x1));
            if (col == lab[h]) tok[h] += x0;
            if (col + 1 == lab[h]) tok[h] += x1;
          }
          acc[4 * j + 2 * h] = x0;
          acc[4 * j + 2 * h + 1] = x1;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], quad_max(tmax[h]));
        float ts = 0.0f;
#pragma unroll
        for (int j = 0; j < k1::BN / 8; ++j)
          ts += expf(acc[4 * j + 2 * h] - m_new) +
                expf(acc[4 * j + 2 * h + 1] - m_new);
        s_run[h] = s_run[h] * expf(m_run[h] - m_new) + quad_sum(ts);
        m_run[h] = m_new;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tk = quad_sum(tok[h]);
      const int n = n_row[h];
      if (lane % 4 == 0 && n < N) {
        part[((size_t)0 * C + chunk) * N + n] = m_run[h];
        part[((size_t)1 * C + chunk) * N + n] = s_run[h];
        part[((size_t)2 * C + chunk) * N + n] = tk;
      }
    }
  }
}

// lse and per_tok of each row from its chunks' partials, in chunk order
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part, int C,
                                      int N, float* __restrict__ per_tok,
                                      float* __restrict__ lse_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m = -CUDART_INF_F;
  for (int c = 0; c < C; ++c) m = fmaxf(m, part[(size_t)c * N + n]);
  float s = 0.0f, tok = 0.0f;
  for (int c = 0; c < C; ++c) {
    s += part[((size_t)C + c) * N + n] * expf(part[(size_t)c * N + n] - m);
    tok += part[((size_t)2 * C + c) * N + n];
  }
  const float lse = m + logf(s);
  lse_out[n] = lse;
  per_tok[n] = lse - tok;
}

int ce_fwd_wgmma_launch(const void* states, const void* w, const void* bias,
                        const void* labels, void* per_tok, void* lse,
                        void* logits, void* part, int N, int D, int V,
                        void* stream) {
  if (N <= 0 || D <= 0 || D % 64 != 0 || D > 512 || V <= 0 || V % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_s, map_w;
  int err = hopper::make_map_bf16(&map_s, states, N, D, k1::BM);
  if (err == 0) err = hopper::make_map_bf16(&map_w, w, D, V, 64);
  if (err != 0) return err;
  const size_t smem = k1::smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      ce_fwd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int C = (V + k1::CHUNK - 1) / k1::CHUNK;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(C, (N + k1::BM - 1) / k1::BM);
  ce_fwd_kernel_wgmma<<<grid, k1::THREADS, smem, st>>>(
      map_s, map_w, (const float*)bias, (const int*)labels, (float*)part,
      (bf16*)logits, N, D, V);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      (const float*)part, C, N, (float*)per_tok, (float*)lse);
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

// The TMA + wgmma path (bf16; see _ce_path): part [3, ceil(V / 2048), N] f32
// is scratch for the chunks' partial statistics.
extern "C" int ce_readout_fwd_bf16_wgmma(const void* states, const void* w,
                                         const void* bias, const void* labels,
                                         void* per_tok, void* lse,
                                         void* logits, void* part, int N,
                                         int D, int V, void* stream) {
  return ce_fwd_wgmma_launch(states, w, bias, labels, per_tok, lse, logits,
                             part, N, D, V, stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of kernel `which` (0: wgmma at depth D, 1: WMMA bf16, 2: f32)
extern "C" int ce_readout_fwd_info(int which, int D, int* regs,
                                   int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn = which == 0 ? (const void*)ce_fwd_kernel_wgmma
                   : which == 1 ? (const void*)ce_fwd_kernel_bf16
                                : (const void*)ce_fwd_kernel_f32;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k1::smem_bytes(D) : 0);
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

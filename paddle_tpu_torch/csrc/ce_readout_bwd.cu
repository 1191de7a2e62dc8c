// Vocab-tiled readout + softmax cross-entropy, backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::ce_readout_bwd_pallas (the
// _ce_bwd_kernel body), the backward of ops/losses.py's tiled
// sequence_softmax_ce_readout.
//
// Computes, from the forward's logits residual [N, V] (compute type CT),
// its lse [N], the labels [N] and the per-row cotangent scale [N]:
//     d_l[n, v] = (exp(l[n, v] - lse[n]) - (v == labels[n])) * scale[n]
//     d_states  = round_CT(d_l) @ w^T                 [N, D] float32
//     d_w       = states^T @ round_CT(d_l)            [D, V] float32
//     d_b       = sum_n d_l[n, :]                     [V]    float32
// with CT operands and float32 accumulation, as _ce_bwd_kernel casts them.
// d_l is formed in shared memory from the saved logits tile and never
// reaches device memory.
//
// What bounds it on this card: at the training shape (N = 12288, D = 512,
// V = 30000) the two products are 755 GFLOP, 0.76 ms at the 989 TFLOP/s
// bf16 tensor-core peak, against 0.22 ms to read the 737 MB logits once:
// bound by operations.  So the bfloat16 path multiplies on the tensor
// cores (WMMA 16 x 16 x 16 bf16 fragments, float32 accumulation); the
// float32 path (f32 compute policy) in float32 FMAs on the CUDA cores.
//
// Design: the TPU kernel walks the vocab tiles in order and keeps d_states
// as one resident accumulator.  Hopper's blocks run in parallel, so that
// accumulator cannot be shared; instead two passes, each recomputing d_l
// from the logits tile and lse while loading it:
//   pass (a) ce_bwd_states_kernel: a block owns a 64-row x 64-column tile
//            of d_states and loops over V;
//   pass (b) ce_bwd_weights_kernel: a block owns a 64 x 64 tile of d_w and
//            loops over N; the blocks of the first D tile also sum d_b for
//            their vocab columns.
// In both passes the blocks that read one logits tile are adjacent in
// launch order (the D tile is blockIdx.x), so the 737 MB of logits, which
// do not fit the 50 MB L2, come from device memory about once a pass.
// No atomics and fixed summation orders: the result is deterministic, and
// a row of d_states does not depend on N.  In the bf16 kernels eight warps
// each own a 16 x 32 strip of the 64 x 64 output tile as WMMA fragments;
// the rounded d_l tile is written to shared memory in bf16 as it is formed
// (8 logits a thread, one 16-byte load),
// and w (pass a) and states (pass b) are read as column-major fragments in
// place of a transpose.  Tiles are loaded synchronously (no cp.async / TMA
// pipeline yet).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owns a 4 x 4 patch
constexpr int LDA = BK + 8;   // bf16 row pitch of a [*, BK] tile (80 bytes)
constexpr int LDB = BN + 8;   // bf16 row pitch of a [*, BN] tile (144 bytes)
constexpr int LDC = BN + 4;   // f32 row pitch of the staged accumulators
using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <typename CT>
__device__ __forceinline__ float to_f(CT x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the cast of a matmul operand to the compute type, widened back
template <typename CT>
__device__ __forceinline__ float round_ct(float x);
template <>
__device__ __forceinline__ float round_ct<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_ct<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d_l for one logits entry (float32, before the operand cast)
template <typename CT>
__device__ __forceinline__ float d_logit(CT l, float lse, int lab, int v,
                                         float scale) {
  const float p = expf(to_f<CT>(l) - lse);
  return (p - (v == lab ? 1.0f : 0.0f)) * scale;
}

// d_l of the 8 logits at row n, columns v .. v + 7 (0 outside N x V); one
// 16-byte load where the 8 are whole and aligned
__device__ __forceinline__ void d_logits8(const bf16* __restrict__ logits,
                                          int n, int v, int N, int V,
                                          float lse, int lab, float scale,
                                          float out[8]) {
  const bf16* p = logits + (size_t)n * V + v;
  if (n < N && v + 8 <= V && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) out[q] = d_logit<bf16>(h[q], lse, lab, v + q,
                                                       scale);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      out[q] = (n < N && v + q < V) ? d_logit<bf16>(p[q], lse, lab, v + q,
                                                    scale)
                                    : 0.0f;
  }
}

// 8 floats rounded to bf16 into 16 aligned bytes of shared memory
__device__ __forceinline__ void store8_bf16(bf16* dst, const float x[8]) {
  __align__(16) bf16 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16_rn(x[q]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(h);
}

// acc += As^T-free tile product: acc[i][j] += sum_kk A[ty+16i][kk] *
// Bs[kk][tx+16j] over one BK stage
__device__ __forceinline__ void stage_fma(const float (*As)[BK + 1],
                                          const float (*Bs)[BN + 1],
                                          float acc[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
  }
}

// pass (a), float32: d_states[n, d] = sum_v d_l[n, v] * w[d, v]
template <typename CT>
__global__ void __launch_bounds__(THREADS) ce_bwd_states_kernel(
    const CT* __restrict__ logits, const CT* __restrict__ W,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ scale, float* __restrict__ d_states, int N,
    int D, int V) {
  __shared__ float As[BM][BK + 1];      // round(d_l) [row][v]
  __shared__ float Bs[BK][BN + 1];      // w^T        [v][d]
  __shared__ float s_lse[BM], s_scale[BM];
  __shared__ int s_lab[BM];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int n = row0 + r;
    s_lse[r] = n < N ? lse[n] : 0.0f;
    s_scale[r] = n < N ? scale[n] : 0.0f;
    s_lab[r] = n < N ? labels[n] : -1;
  }
  __syncthreads();
  float acc[4][4] = {};
  for (int v0 = 0; v0 < V; v0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;      // v fastest: coalesced
      const int n = row0 + r, v = v0 + c;
      As[r][c] = (n < N && v < V)
                     ? round_ct<CT>(d_logit<CT>(logits[(size_t)n * V + v],
                                                s_lse[r], s_lab[r], v,
                                                s_scale[r]))
                     : 0.0f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e % BK, c = e / BK;      // v fastest: coalesced
      const int v = v0 + r, d = col0 + c;
      Bs[r][c] = (v < V && d < D) ? to_f<CT>(W[(size_t)d * V + v]) : 0.0f;
    }
    __syncthreads();
    stage_fma(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = col0 + tx + 16 * j;
      if (n < N && d < D) d_states[(size_t)n * D + d] = acc[i][j];
    }
  }
}

// pass (b), float32: d_w[d, v] = sum_n states[n, d] * d_l[n, v]; blocks
// with blockIdx.x == 0 (the first D tile) also write d_b[v] = sum_n d_l[n, v]
template <typename CT>
__global__ void __launch_bounds__(THREADS) ce_bwd_weights_kernel(
    const CT* __restrict__ logits, const CT* __restrict__ S,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ scale, float* __restrict__ d_w,
    float* __restrict__ d_b, int N, int D, int V) {
  __shared__ float As[BM][BK + 1];      // states^T   [d][n]
  __shared__ float Bs[BK][BN + 1];      // round(d_l) [n][v]
  __shared__ float s_lse[BK], s_scale[BK];
  __shared__ int s_lab[BK];
  __shared__ float s_db[THREADS];
  const int d0 = blockIdx.x * BM, v0 = blockIdx.y * BN;
  const bool want_db = blockIdx.x == 0;
  float acc[4][4] = {};
  float db = 0.0f;   // this thread's partial d_b of column threadIdx % BN
  for (int n0 = 0; n0 < N; n0 += BK) {
    for (int r = threadIdx.x; r < BK; r += THREADS) {
      const int n = n0 + r;
      s_lse[r] = n < N ? lse[n] : 0.0f;
      s_scale[r] = n < N ? scale[n] : 0.0f;
      s_lab[r] = n < N ? labels[n] : -1;
    }
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e % BM, c = e / BM;      // d fastest: coalesced
      const int d = d0 + r, n = n0 + c;
      As[r][c] = (d < D && n < N) ? to_f<CT>(S[(size_t)n * D + d]) : 0.0f;
    }
    __syncthreads();
    // THREADS is a multiple of BN: each thread keeps one column c
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;      // v fastest: coalesced
      const int n = n0 + r, v = v0 + c;
      float dl = 0.0f;
      if (n < N && v < V)
        dl = d_logit<CT>(logits[(size_t)n * V + v], s_lse[r], s_lab[r], v,
                         s_scale[r]);
      db += dl;
      Bs[r][c] = round_ct<CT>(dl);
    }
    __syncthreads();
    stage_fma(As, Bs, acc);
    __syncthreads();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = d0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (d < D && v < V) d_w[(size_t)d * V + v] = acc[i][j];
    }
  }
  if (want_db) {
    s_db[threadIdx.x] = db;
    __syncthreads();
    if (threadIdx.x < BN && v0 + threadIdx.x < V) {
      float s = 0.0f;
      for (int q = threadIdx.x; q < THREADS; q += BN) s += s_db[q];
      d_b[v0 + threadIdx.x] = s;
    }
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

// the warps' accumulators -> out[(r0 + r) * ld_out + c0 + c] (f32, within
// rmax x cmax), staged through shared memory
__device__ __forceinline__ void store_tile(Frag c[2], float (*Cs)[LDC],
                                           float* __restrict__ out,
                                           size_t ld_out, int r0, int c0,
                                           int rmax, int cmax) {
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&Cs[wr * 16][wc * 32 + j * 16], c[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, cc = e % BN;
    if (r0 + r < rmax && c0 + cc < cmax)
      out[(size_t)(r0 + r) * ld_out + c0 + cc] = Cs[r][cc];
  }
}

// pass (a), bf16: d_states tile (rows row0.., d columns col0..)
__global__ void __launch_bounds__(THREADS) ce_bwd_states_kernel_bf16(
    const bf16* __restrict__ logits, const bf16* __restrict__ W,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ scale, float* __restrict__ d_states, int N,
    int D, int V) {
  __shared__ __align__(32) bf16 As[BM][LDA];    // round(d_l) [row][v]
  __shared__ __align__(32) bf16 Bt[BN][LDA];    // w          [d][v]
  __shared__ __align__(32) float Cs[BM][LDC];
  __shared__ float s_lse[BM], s_scale[BM];
  __shared__ int s_lab[BM];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int n = row0 + r;
    s_lse[r] = n < N ? lse[n] : 0.0f;
    s_scale[r] = n < N ? scale[n] : 0.0f;
    s_lab[r] = n < N ? labels[n] : -1;
  }
  __syncthreads();
  Frag c[2];
  wmma::fill_fragment(c[0], 0.0f);
  wmma::fill_fragment(c[1], 0.0f);
  for (int v0 = 0; v0 < V; v0 += BK) {
    for (int e = threadIdx.x; e < BM * BK / 8; e += THREADS) {
      const int r = e / (BK / 8), cc = (e % (BK / 8)) * 8;
      float dl[8];
      d_logits8(logits, row0 + r, v0 + cc, N, V, s_lse[r], s_lab[r],
                s_scale[r], dl);
      store8_bf16(&As[r][cc], dl);
    }
    load_tile<BN, BK, LDA>(Bt, W, V, col0, v0, D, V);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &As[wr * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, &Bt[wc * 32 + j * 16][kk], LDA);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
    __syncthreads();
  }
  store_tile(c, Cs, d_states, D, row0, col0, N, D);
}

// pass (b), bf16: d_w tile (d rows d0.., vocab columns v0..) and d_b
__global__ void __launch_bounds__(THREADS) ce_bwd_weights_kernel_bf16(
    const bf16* __restrict__ logits, const bf16* __restrict__ S,
    const int* __restrict__ labels, const float* __restrict__ lse,
    const float* __restrict__ scale, float* __restrict__ d_w,
    float* __restrict__ d_b, int N, int D, int V) {
  __shared__ __align__(32) bf16 St[BK][LDB];    // states     [n][d]
  __shared__ __align__(32) bf16 Bs[BK][LDB];    // round(d_l) [n][v]
  __shared__ __align__(32) float Cs[BM][LDC];
  __shared__ float s_lse[BK], s_scale[BK];
  __shared__ int s_lab[BK];
  __shared__ float s_db[BK][BN];
  const int d0 = blockIdx.x * BM, v0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  Frag c[2];
  wmma::fill_fragment(c[0], 0.0f);
  wmma::fill_fragment(c[1], 0.0f);
  // BK * BN / 8 == THREADS: each thread forms the same 8 columns of one
  // row of every d_l tile, and keeps their partial d_b
  static_assert(BK * BN / 8 == THREADS, "one d_l vector per thread");
  const int dr = threadIdx.x / (BN / 8), dc = (threadIdx.x % (BN / 8)) * 8;
  float db[8] = {};
  for (int n0 = 0; n0 < N; n0 += BK) {
    for (int r = threadIdx.x; r < BK; r += THREADS) {
      const int n = n0 + r;
      s_lse[r] = n < N ? lse[n] : 0.0f;
      s_scale[r] = n < N ? scale[n] : 0.0f;
      s_lab[r] = n < N ? labels[n] : -1;
    }
    load_tile<BK, BN, LDB>(St, S, D, n0, d0, N, D);
    __syncthreads();
    {
      float dl[8];
      d_logits8(logits, n0 + dr, v0 + dc, N, V, s_lse[dr], s_lab[dr],
                s_scale[dr], dl);
#pragma unroll
      for (int q = 0; q < 8; ++q) db[q] += dl[q];
      store8_bf16(&Bs[dr][dc], dl);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &St[kk][wr * 16], LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &Bs[kk][wc * 32 + j * 16], LDB);
        wmma::mma_sync(c[j], a, b, c[j]);
      }
    }
    __syncthreads();
  }
  store_tile(c, Cs, d_w, V, d0, v0, D, V);
  if (blockIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) s_db[dr][dc + q] = db[q];
    __syncthreads();
    if (threadIdx.x < BN && v0 + threadIdx.x < V) {
      float s = 0.0f;
      for (int r = 0; r < BK; ++r) s += s_db[r][threadIdx.x];
      d_b[v0 + threadIdx.x] = s;
    }
  }
}

template <typename CT, typename KernelA, typename KernelB>
int ce_bwd_launch(KernelA pass_a, KernelB pass_b, const void* logits,
                  const void* states, const void* w, const void* labels,
                  const void* lse, const void* scale, void* d_states,
                  void* d_w, void* d_b, int N, int D, int V, void* stream) {
  if (N < 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    const dim3 grid_a((D + BN - 1) / BN, (N + BM - 1) / BM);
    pass_a<<<grid_a, THREADS, 0, st>>>(
        (const CT*)logits, (const CT*)w, (const int*)labels,
        (const float*)lse, (const float*)scale, (float*)d_states, N, D, V);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // pass (b) runs at N == 0 too: it writes the zero d_w and d_b.  D tiles
  // on x: the blocks that read one logits column tile run together, so
  // the tile is read from memory once and from L2 by the rest
  const dim3 grid_b((D + BM - 1) / BM, (V + BN - 1) / BN);
  pass_b<<<grid_b, THREADS, 0, st>>>(
      (const CT*)logits, (const CT*)states, (const int*)labels,
      (const float*)lse, (const float*)scale, (float*)d_w, (float*)d_b, N, D,
      V);
  return (int)cudaGetLastError();
}

}  // namespace

// logits [N, V], states [N, D] and w [D, V] in the compute type, labels [N]
// int32, lse [N] and scale [N] f32 -> d_states [N, D], d_w [D, V], d_b [V],
// all f32.  Returns a cudaError_t.
extern "C" int ce_readout_bwd_f32(const void* logits, const void* states,
                                  const void* w, const void* labels,
                                  const void* lse, const void* scale,
                                  void* d_states, void* d_w, void* d_b, int N,
                                  int D, int V, void* stream) {
  return ce_bwd_launch<float>(ce_bwd_states_kernel<float>,
                              ce_bwd_weights_kernel<float>, logits, states,
                              w, labels, lse, scale, d_states, d_w, d_b, N,
                              D, V, stream);
}

extern "C" int ce_readout_bwd_bf16(const void* logits, const void* states,
                                   const void* w, const void* labels,
                                   const void* lse, const void* scale,
                                   void* d_states, void* d_w, void* d_b,
                                   int N, int D, int V, void* stream) {
  return ce_bwd_launch<bf16>(ce_bwd_states_kernel_bf16,
                             ce_bwd_weights_kernel_bf16, logits, states, w,
                             labels, lse, scale, d_states, d_w, d_b, N, D, V,
                             stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Vocab-tiled decode readout with top-k and logsumexp, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::topk_lse_readout_pallas
// (_topk_readout_kernel + _topk_lse_update), the readout of every decode
// step through ops/decode.py::LinearReadout.
//
// Computes, per row n of states [N, D] against w [D, V] and bias b [V]:
//     l      = states[n] @ w + b                  (never written to memory)
//     lse[n] = logsumexp(max(l, -FLT_MAX))        (finite-min clamp: an
//              all -inf vocab tile cannot poison the statistics with nan)
//     vals[n], idx[n] = the k largest l, ties to the LOWEST vocab id
//              (lax.top_k order); a real -inf logit stays selectable by id
// Operands are in the compute type (float or bfloat16), products accumulate
// in float32.  k <= 16.
//
// What bounds it on this card: at the serving shape (N = 64 slots x 3 beams
// = 192, D = 512, V = 30000) one call reads w once, 30.7 MB in bf16, and
// does 5.9 GFLOP: 9.2 us of memory time against 6.0 us of tensor-core time,
// so the call is memory-bound and the logits (23 MB in f32) must never
// reach device memory.
//
// Design: the TPU kernel carries a running top-k and a running logsumexp
// in VMEM scratch across a sequential grid over vocab tiles; Hopper's
// blocks run in no order, so the state is split into two passes.  Pass 1
// reduces each row over each vocab slice to the slice's max, sum-exp and
// top-k (partials pv/pi [N, nV, k], pm/ps [N, nV]); pass 2
// (topk_lse_merge_kernel, in topk_lse_common.cuh) merges
// them per row in one warp.  Pass 1 has two kernels, picked by the wrapper
// from shape, dtype and alignment (ops/kernels/topk_readout.py::
// _topk_path):
//
// topk_lse_tile_kernel_wgmma (bf16; D in {64, 128, 256, 512}, V % 8 == 0,
//   16-byte aligned operands: what TMA takes).  One persistent block per SM
//   walks tiles of 64 rows x one 256-column vocab chunk (3 x 118 = 354 at
//   the serve shape), the row blocks of a chunk on neighbouring blocks at
//   once, so w crosses HBM about once.  One producer thread streams each
//   tile through a 5-stage TMA ring, a stage holding the tile's states box
//   (64 rows x 64 deep) and w (64 deep x 256 columns); the next tile's
//   loads run while the consumers finish the last one.  Two consumer
//   warpgroups each run wgmma m64n128k16 over one 128-column half with
//   float32 accumulators in registers, and the epilogue reads them there:
//   in the m64 accumulator layout a row lies in one quad of lanes, each
//   lane holding 32 of its 128 columns, so the bias, the finite-min-clamped
//   max and sum-exp and the top-k (k rounds of a per-lane best, then two
//   quad shuffles) need no shared memory.  The halves' statistics meet in
//   shared memory, and one thread a row writes the chunk's partial (nV =
//   ceil(V / 256)): the (max, sum-exp) folded, the two ordered lists
//   merged.  Columns past V (TMA fills zeros) are never candidates.
// topk_lse_tile_kernel (the f32 compute policy and every shape TMA cannot
//   take): blocks over (32-row tile, 128-column vocab tile, nV =
//   ceil(V / 128)); each computes its logits tile with a shared-memory
//   tiled product on the CUDA cores (fixed k order), adds the bias, and
//   reduces each row in one warp (topk_lse::row_tile_stats).  The ragged
//   last vocab tile is masked here: w is never padded.
// Tile shapes are fixed, never chosen from N, and no sum is split across
// blocks by row count: a row's result does not depend on N, so a slot
// table's rows match a solo decode bit for bit.

#include "hopper_tma_wgmma.cuh"
#include "topk_lse_common.cuh"

namespace {

using topk_lse::MAXK;
using topk_lse::SENTINEL;
using topk_lse::to_f;

constexpr int RB = 32;        // rows per block (pass 1)
constexpr int VT = 128;       // vocab columns per block (pass 1)
constexpr int BKD = 32;       // depth of one shared-memory stage
constexpr int THREADS = 256;  // 8 warps

// pass 1.  grid (ceil(N / RB), nV).  Partials: pv/pi [N, nV, k],
// pm/ps [N, nV].
template <typename CT>
__global__ void __launch_bounds__(THREADS) topk_lse_tile_kernel(
    const CT* __restrict__ states, const CT* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ pv,
    int* __restrict__ pi, float* __restrict__ pm, float* __restrict__ ps,
    int N, int D, int V, int k, int nV) {
  __shared__ float As[RB][BKD + 1];
  __shared__ float Ws[BKD][VT];
  __shared__ float L[RB][VT + 1];
  const int row0 = blockIdx.x * RB, vt = blockIdx.y, col0 = vt * VT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // --- the [RB, VT] logits tile: thread (warp, lane) owns rows
  // warp*4 .. warp*4+3 and columns lane + 32 j ---
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += BKD) {
    for (int e = threadIdx.x; e < RB * BKD; e += THREADS) {
      const int r = e / BKD, c = e % BKD;
      const int gr = row0 + r, gd = d0 + c;
      As[r][c] = (gr < N && gd < D) ? to_f<CT>(states[(size_t)gr * D + gd])
                                    : 0.0f;
    }
    for (int e = threadIdx.x; e < BKD * VT; e += THREADS) {
      const int r = e / VT, c = e % VT;
      const int gd = d0 + r, gv = col0 + c;
      Ws[r][c] = (gd < D && gv < V) ? to_f<CT>(w[(size_t)gd * V + gv])
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKD; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[warp * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gv = col0 + lane + 32 * j;
      L[warp * 4 + i][lane + 32 * j] = acc[i][j] + (gv < V ? bias[gv] : 0.0f);
    }
  __syncthreads();

  // --- per-row tile statistics: warp `warp` reduces rows warp*4 .. +3 ---
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, gr = row0 + r;
    if (gr >= N) break;  // warp-uniform
    float v[4];
    int id[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gv = col0 + lane + 32 * j;
      v[j] = L[r][lane + 32 * j];
      id[j] = gv < V ? gv : SENTINEL;  // ragged tail: no candidate
    }
    topk_lse::row_tile_stats<4>(v, id, k, (size_t)gr * nV + vt, lane, pm,
                                ps, pv, pi);
  }
}

template <typename CT>
int topk_lse_impl(const CT* states, const CT* w, const float* bias,
                  float* pv, int* pi, float* pm, float* ps, float* out_v,
                  int64_t* out_i, float* out_lse, int N, int D, int V, int k,
                  cudaStream_t stream) {
  if (k < 1 || k > MAXK || V < k || N < 0 || D < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int nV = (V + VT - 1) / VT;
  topk_lse_tile_kernel<CT><<<dim3((N + RB - 1) / RB, nV), THREADS, 0,
                             stream>>>(states, w, bias, pv, pi, pm, ps, N, D,
                                       V, k, nV);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return topk_lse::launch_merge(pv, pi, pm, ps, out_v, out_i, out_lse, N,
                                nV, k, stream);
}


// ------------------------------------------------------- TMA + wgmma (bf16)

namespace k7 {

constexpr int BM = 64;          // rows of a tile: one wgmma M tile
constexpr int HALF = 128;       // vocab columns per consumer warpgroup
constexpr int CHUNK = 256;      // vocab columns of a tile: one partial
constexpr int STAGES = 5;       // depth of the ring
constexpr int THREADS = 384;    // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int BOX_BYTES = 64 * 64 * 2;        // one 64 x 64 bf16 box
// a stage: the tile's states box (64 rows x 64 deep), then w (64 deep x
// 256 columns, four boxes)
constexpr int STAGE_BYTES = BOX_BYTES + 64 * CHUNK * 2;

// the two halves' per-row statistics, exchanged through shared memory
struct Exchange {
  float v[2][BM][MAXK];
  int id[2][BM][MAXK];
  float m[2][BM];
  float s[2][BM];
};

constexpr size_t SMEM_BYTES =
    1024 + (size_t)STAGES * STAGE_BYTES + sizeof(Exchange) + 128;

}  // namespace k7

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One persistent block per SM walks tiles t = blockIdx.x, + gridDim.x, ...
// of (64-row block t % nrb, 256-column chunk t / nrb): the row blocks of a
// chunk are neighbours in t, so they run at once on neighbouring blocks
// and w crosses HBM about once.  Partials pv/pi [N, nC, k], pm/ps [N, nC],
// one per chunk, nC = ceil(V / 256).
__global__ void __launch_bounds__(k7::THREADS, 1) topk_lse_tile_kernel_wgmma(
    const __grid_constant__ CUtensorMap map_s,
    const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
    float* __restrict__ pv, int* __restrict__ pi, float* __restrict__ pm,
    float* __restrict__ ps, int N, int D, int V, int k, int nC) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  k7::Exchange& ex = *reinterpret_cast<k7::Exchange*>(
      ring + k7::STAGES * k7::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(&ex + 1);
  uint64_t* empty = full + k7::STAGES;

  const int nrb = (N + k7::BM - 1) / k7::BM;
  const int tiles = nrb * nC;
  const int kchunks = D / 64;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < k7::STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);     // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every load
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&map_s);
      hopper::prefetch_map(&map_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = t % nrb * k7::BM, v0 = t / nrb * k7::CHUNK;
        for (int kc = 0; kc < kchunks; ++kc) {
          hopper::mbar_wait(&empty[stage], phase ^ 1u);
          hopper::mbar_expect_tx(&full[stage], k7::STAGE_BYTES);
          uint8_t* dst = ring + stage * k7::STAGE_BYTES;
          hopper::tma_load(dst, &map_s, &full[stage], kc * 64, row0);
#pragma unroll
          for (int bx = 0; bx < k7::CHUNK / 64; ++bx)
            hopper::tma_load(dst + (1 + bx) * k7::BOX_BYTES, &map_w,
                             &full[stage], v0 + 64 * bx, kc * 64);
          if (++stage == k7::STAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<232>();
  const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
  const uint32_t ring_base = hopper::smem_u32(ring);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t % nrb * k7::BM, chunk = t / nrb;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    int prev = -1;
    for (int kc = 0; kc < kchunks; ++kc) {
      hopper::mbar_wait(&full[stage], phase);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      const uint32_t a = ring_base + stage * k7::STAGE_BYTES;
      const uint32_t b = a + (1 + 2 * wg) * k7::BOX_BYTES;   // this half
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_m64n128<0, 1>(acc, hopper::desc_kmajor(a, kk),
                                    hopper::desc_mnmajor(b, kk,
                                                         k7::BOX_BYTES));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();         // the previous stage's products done
      hopper::fence_regs(acc);
      if (prev >= 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == k7::STAGES) { stage = 0; phase ^= 1u; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue on the accumulators: acc[4j + 2h + e] is row
    // 16 warp + lane / 4 + 8 h of the tile, column v0 + 8j + 2 (lane % 4)
    // + e; V % 8 == 0, so col < V means col + 1 < V.  Each half's row
    // statistics go to the exchange, quad leader lanes writing.
    const int cq = chunk * k7::CHUNK + wg * k7::HALF + 2 * (lane % 4);
    // bit 2j + e: column cq + 8j + e lies inside the vocabulary
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < k7::HALF / 8; ++j) {
      const int col = cq + 8 * j;
      const float2 bb = col < V
          ? *reinterpret_cast<const float2*>(&bias[col])
          : make_float2(0.0f, 0.0f);
      if (col < V) valid |= 3u << (2 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] += bb.x;
        acc[4 * j + 2 * h + 1] += bb.y;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h;
      const bool lead = lane % 4 == 0;
      // slot c = 2j + e of this row: acc[4j + 2h + e], id cq + 8j + e
      float mx = -FLT_MAX;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if ((valid >> c) & 1u)
          mx = fmaxf(mx, fmaxf(acc[4 * (c / 2) + 2 * h + c % 2], -FLT_MAX));
      mx = quad_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if ((valid >> c) & 1u)
          sum += expf(fmaxf(acc[4 * (c / 2) + 2 * h + c % 2], -FLT_MAX) -
                      mx);
      sum = quad_sum(sum);
      if (lead) {
        ex.m[wg][r] = mx;
        ex.s[wg][r] = sum;
      }
      // k rounds: each lane's best candidate left, then the quad's best;
      // the lane that held the winner drops it.  A lane scans its slots
      // in increasing id, so a strict > keeps the lowest id of a tie.
      // Past V no candidate: the list ends in (-inf, SENTINEL).
      uint32_t avail = valid;
      for (int q = 0; q < k; ++q) {
        float bv = -CUDART_INF_F;
        int slot = -1;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const float v = acc[4 * (c / 2) + 2 * h + c % 2];
          if (((avail >> c) & 1u) && (v > bv || slot < 0)) {
            bv = v;
            slot = c;
          }
        }
        int bi = slot < 0 ? SENTINEL : cq + 8 * (slot / 2) + slot % 2;
        const int mine = bi;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (topk_lse::better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (slot >= 0 && mine == bi) avail &= ~(1u << slot);
        if (lead) {
          ex.v[wg][r][q] = bv;
          ex.id[wg][r][q] = bi;
        }
      }
    }
    hopper::named_barrier(k7::CONSUMERS);   // both halves written
    if (threadIdx.x < k7::BM && row0 + threadIdx.x < N) {
      // the chunk's partial of row r: the halves' (max, sum-exp) folded,
      // their two ordered lists merged
      const int r = threadIdx.x;
      const size_t base = (size_t)(row0 + r) * nC + chunk;
      float mx = ex.m[0][r], sum = ex.s[0][r];
      topk_lse::fold_stats(mx, sum, ex.m[1][r], ex.s[1][r]);
      pm[base] = mx;
      ps[base] = sum;
      int i0 = 0, i1 = 0;
      for (int q = 0; q < k; ++q) {
        const float v0 = ex.v[0][r][i0], v1 = ex.v[1][r][i1];
        const int d0 = ex.id[0][r][i0], d1 = ex.id[1][r][i1];
        const bool first = topk_lse::better(v0, d0, v1, d1) ||
                           (d0 == SENTINEL && d1 == SENTINEL);
        pv[base * k + q] = first ? v0 : v1;
        pi[base * k + q] = first ? d0 : d1;
        if (first) ++i0; else ++i1;
      }
    }
    hopper::named_barrier(k7::CONSUMERS);   // the exchange is free again
  }
}

int topk_wgmma_launch(const void* states, const void* w, const void* bias,
                      float* pv, int* pi, float* pm, float* ps, float* out_v,
                      int64_t* out_i, float* out_lse, int N, int D, int V,
                      int k, cudaStream_t stream) {
  if (k < 1 || k > MAXK || V < k || N <= 0 || D < 64 || D > 512 ||
      D % 64 != 0 || V % 8 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_s, map_w;
  int err = hopper::make_map_bf16(&map_s, states, N, D, k7::BM);
  if (err == 0) err = hopper::make_map_bf16(&map_w, w, D, V, 64);
  if (err != 0) return err;
  // the shared-memory opt-in and the SM count, once per device (the call
  // runs once a decode step, so its host time counts)
  static int sm_count[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    e = cudaFuncSetAttribute(topk_lse_tile_kernel_wgmma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)k7::SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int sms = sm_count[dev];
  const int nC = (V + k7::CHUNK - 1) / k7::CHUNK;
  const int tiles = (N + k7::BM - 1) / k7::BM * nC;
  topk_lse_tile_kernel_wgmma<<<min(tiles, sms), k7::THREADS, k7::SMEM_BYTES,
                               stream>>>(map_s, map_w, (const float*)bias,
                                         pv, pi, pm, ps, N, D, V, k, nC);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return topk_lse::launch_merge(pv, pi, pm, ps, out_v, out_i, out_lse, N, nC,
                                k, stream);
}

}  // namespace

// states [N, D], w [D, V] (both the compute type), bias [V] f32;
// partials pv [N, nV, k] f32, pi [N, nV, k] i32, pm / ps [N, nV] f32;
// outputs vals [N, k] f32, idx [N, k] i64, lse [N] f32.
#define TOPK_LSE_ENTRY(NAME, CT)                                            \
  extern "C" int NAME(const void* states, const void* w, const void* bias,  \
                      void* pv, void* pi, void* pm, void* ps, void* out_v,  \
                      void* out_i, void* out_lse, int N, int D, int V,      \
                      int k, void* stream) {                                \
    return topk_lse_impl<CT>((const CT*)states, (const CT*)w,               \
                             (const float*)bias, (float*)pv, (int*)pi,      \
                             (float*)pm, (float*)ps, (float*)out_v,         \
                             (int64_t*)out_i, (float*)out_lse, N, D, V, k,  \
                             (cudaStream_t)stream);                         \
  }

TOPK_LSE_ENTRY(topk_lse_readout_f32, float)
TOPK_LSE_ENTRY(topk_lse_readout_bf16, __nv_bfloat16)

// The TMA + wgmma pass 1 (bf16; see _topk_path), same arguments and
// partials as topk_lse_readout_bf16.
extern "C" int topk_lse_readout_bf16_wgmma(
    const void* states, const void* w, const void* bias, void* pv, void* pi,
    void* pm, void* ps, void* out_v, void* out_i, void* out_lse, int N, int D,
    int V, int k, void* stream) {
  return topk_wgmma_launch(states, w, bias, (float*)pv, (int*)pi, (float*)pm,
                           (float*)ps, (float*)out_v, (int64_t*)out_i,
                           (float*)out_lse, N, D, V, k, (cudaStream_t)stream);
}

// registers a thread, local (spilled) bytes a thread and shared bytes a
// block of pass 1's kernel `which` (0: wgmma at depth D, 1: SIMT bf16,
// 2: SIMT f32)
extern "C" int topk_lse_readout_info(int which, int D, int* regs,
                                     int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes a;
  const void* fn = which == 0 ? (const void*)topk_lse_tile_kernel_wgmma
                   : which == 1
                       ? (const void*)topk_lse_tile_kernel<__nv_bfloat16>
                       : (const void*)topk_lse_tile_kernel<float>;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes +
                (which == 0 ? (int)k7::SMEM_BYTES : 0);
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

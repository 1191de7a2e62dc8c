// Top-k and logsumexp over pre-built logits, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::topk_lse_logits_pallas
// (_topk_logits_kernel + _topk_lse_update), the readout of every decode
// step through ops/decode.py::LogitsReadout: generation through the nn
// DSL's beam_search layer, whose step net ends in a vocab-size logits
// layer the engine cannot tile.
//
// Computes, per row n of logits [N, V] (float or bfloat16):
//     lse[n] = logsumexp(max(l, -FLT_MAX))        (finite-min clamp: a row
//              that is all -inf gives about -FLT_MAX, never nan)
//     vals[n], idx[n] = the k largest l, ties to the LOWEST vocab id
//              (lax.top_k order); a real -inf logit stays selectable by id
// in float32.  k <= 16.
//
// What bounds it on this card: it reads each logit once and does a few
// operations per logit.  At the generation shape (N = 64 sources x 3 beams
// = 192, V = 30000, f32) that is 23.0 MB, 6.9 us at 3.35 TB/s; the
// operations (a max, an exp and a sum per logit) are below that on the
// CUDA cores.  So the design reads the logits once, with 16-byte loads,
// keeps the work per logit to the lse's few operations, and writes
// nothing but the outputs: one launch, no partials in device memory.
//
// Design: one launch of N x C blocks in clusters of C; cluster n reduces
// row n, its block of rank r the columns [r S, min((r + 1) S, V)).  The
// plan (C, slice S, chunk CH) is a function of V and the dtype alone
// (ops/kernels/topk_logits.py::_k8_plan; measured: C = 2, one chunk a
// slice at V = 30000); a block is T = k8::THREADS = 256 threads (measured
// against 128 and 512 by chip_probe.py k8plans).
//   - A block stages its slice in shared memory, CH columns at a time
//     (the whole slice at once where it fits in 64 KB, as at V = 30000),
//     with 16-byte cp.async copies (4 f32 or 8 bf16 logits), every
//     thread's copies in flight together.
//     Columns before the first 16-byte boundary of a chunk and after the
//     last one (a row start that is not 16-byte aligned: odd V in f32,
//     V % 8 != 0 in bf16, an offset base pointer) are copied with scalar
//     loads.  Column c0 + j of a chunk lands at buf[a + j], a = the slice
//     start's offset past a 16-byte boundary, so the copies stay aligned
//     on both sides and column j goes to the same thread at any address.
//   - Thread t takes the groups of VEC columns g = t, t + T, ... of a
//     chunk (one 16-byte shared load a group where the row is aligned):
//     their max; then the warp's max and the k-th largest of its lanes'
//     maxima (no logit below that can be among the warp's k best); then
//     the sum of 2^((max(l, -FLT_MAX) - m) log2 e) against the warp's
//     running max m; then only the lanes whose max reaches the threshold
//     (about k a warp) scan their groups again into a top-k list in
//     registers, ordered (value desc, id asc).
//   - Merges in a fixed order: a warp's lanes (k rounds of the best list
//     head; the sums by a butterfly), then the block's warps in shared
//     memory (warp 0), then the cluster's blocks: each block's warp 0
//     writes its list and (max, sum-exp) into rank 0's shared memory
//     through distributed shared memory (cluster.map_shared_rank), once
//     every block has started (a cluster barrier phase opened at launch),
//     and after cluster.sync() rank 0's warp 0 merges them and writes.
// Which thread reduces which column, and every sum's order, depend on V
// and the plan only, never on N or on the row's address: a row's bits do
// not depend on N.

#include <cooperative_groups.h>

#include <climits>

#include "persistent.cuh"
#include "topk_lse_common.cuh"

namespace cg = cooperative_groups;

namespace {

using topk_lse::MAXK;
using topk_lse::SENTINEL;
using topk_lse::to_f;

namespace k8 {

constexpr int THREADS = 256;       // a block's width
constexpr int ALIGN = 8;           // slices and chunks: multiples of 8 columns
constexpr int MAX_CLUSTER = 8;     // blocks a row (the portable cluster size)
constexpr int MAX_CHUNK_BYTES = 65536;  // a block's staging buffer

// (v, i) into the ordered list (tv, ti) of length KB; the last entry drops
template <int KB>
__device__ __forceinline__ void insert(float (&tv)[KB], int (&ti)[KB],
                                       float v, int i) {
#pragma unroll
  for (int q = 0; q < KB; ++q)
    if (topk_lse::better(v, i, tv[q], ti[q])) {
      const float sv = tv[q];
      const int si = ti[q];
      tv[q] = v;
      ti[q] = i;
      v = sv;
      i = si;
    }
}

// drop the list's head
template <int KB>
__device__ __forceinline__ void pop(float (&tv)[KB], int (&ti)[KB]) {
#pragma unroll
  for (int q = 0; q + 1 < KB; ++q) {
    tv[q] = tv[q + 1];
    ti[q] = ti[q + 1];
  }
  tv[KB - 1] = -CUDART_INF_F;
  ti[KB - 1] = SENTINEL;
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x (MUFU.EX2: relative error about 2^-22; 2^-inf == 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the VEC = 16 / sizeof(LT) staged logits of columns j0 .. j0 + VEC - 1
// of the chunk (column j at buf[a + j]) as floats; -inf past len.  One
// 16-byte shared load where the group is whole and aligned.
template <typename LT>
__device__ __forceinline__ void load_group(const LT* buf, int a, int j0,
                                           int len,
                                           float (&x)[16 / sizeof(LT)]) {
  constexpr int VEC = 16 / sizeof(LT);
  if (a == 0 && j0 + VEC <= len) {
    const uint4 u = *reinterpret_cast<const uint4*>(buf + j0);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if constexpr (sizeof(LT) == 4)
        x[e] = __uint_as_float(w[e]);
      else  // bf16 -> f32 is exact: the bf16 bits are the f32's high half
        x[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u
                                     : w[e / 2] << 16);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      x[e] = j0 + e < len ? to_f<LT>(buf[a + j0 + e]) : -CUDART_INF_F;
  }
}

// the sum of t[0..P) as a fixed pairwise tree
template <int P>
__device__ __forceinline__ float tree_sum(const float (&t)[P]) {
  float u[P];
#pragma unroll
  for (int e = 0; e < P; ++e) u[e] = t[e];
#pragma unroll
  for (int w = 1; w < P; w *= 2)
#pragma unroll
    for (int e = 0; e + w < P; e += 2 * w) u[e] += u[e + w];
  return u[0];
}

// wmax <- the largest of the warp's 32 values v, kth <- the k-th largest
// (counting repeats); every lane the same
__device__ __forceinline__ void warp_kth_largest(float v, int k, int lane,
                                                 float& wmax, float& kth) {
  wmax = kth = -CUDART_INF_F;
  for (int q = 0; q < k; ++q) {
    kth = topk_lse::warp_max(v);
    if (q == 0) wmax = kth;
    const unsigned hit = __ballot_sync(0xffffffffu, v == kth);
    if (hit != 0u && lane == __ffs(hit) - 1) v = -CUDART_INF_F;
  }
}

// the two halves of a cluster barrier phase: arrive (no ordering of
// earlier memory accesses) and wait; every thread of every block of the
// cluster executes both, once a phase
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One selection round over candidates spread over a warp, P a lane: the
// best candidate strictly after (pv, pi) (any when pi < 0), in every lane;
// (-inf, SENTINEL) when none is left.
template <int P>
__device__ __forceinline__ void warp_next(const float (&cv)[P],
                                          const int (&ci)[P], float pv,
                                          int pi, float& bv, int& bi) {
  bv = -CUDART_INF_F;
  bi = SENTINEL;
#pragma unroll
  for (int p = 0; p < P; ++p)
    topk_lse::consider_after(cv[p], ci[p], pv, pi, bv, bi);
  topk_lse::warp_best(bv, bi);
}

// a warp's (max, sum-exp) pairs folded by a butterfly; every lane ends
// with the same bits
__device__ __forceinline__ void warp_fold(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    topk_lse::fold_stats(m, s, om, os);
  }
}

// the per-thread list length for k: 1, 4, 8 or 16
__host__ __device__ constexpr int list_len(int k) {
  return k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
}

}  // namespace k8

// One cluster of C blocks a row, grid N * C.  KB >= k: the length of the
// per-thread lists.  Dynamic shared memory: CH logits and 16 bytes.
template <typename LT, int KB>
__global__ void __launch_bounds__(k8::THREADS) topk_logits_cluster_kernel(
    const LT* __restrict__ logits, float* __restrict__ out_v,
    int64_t* __restrict__ out_i, float* __restrict__ out_lse, int V, int k,
    int S, int CH) {
  constexpr int VEC = 16 / sizeof(LT);          // logits a 16-byte copy
  constexpr int T = k8::THREADS;
  constexpr int NW = T / 32;
  constexpr int PB = (NW * KB + 31) / 32;       // block merge, a lane
  constexpr int PC = (k8::MAX_CLUSTER * KB + 31) / 32;  // cluster merge
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LT* buf = reinterpret_cast<LT*>(smem_raw);
  __shared__ float w_v[NW * KB], w_m[NW], w_s[NW];
  __shared__ int w_i[NW * KB];
  // rank 0's: every block's result, block r's list at [r * KB, + k)
  __shared__ float c_v[k8::MAX_CLUSTER * KB], c_m[k8::MAX_CLUSTER],
      c_s[k8::MAX_CLUSTER];
  __shared__ int c_i[k8::MAX_CLUSTER * KB];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.dim_blocks().x;
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = rank * S, c1 = min(c0 + S, V);
  const LT* src = logits + row * (size_t)V;
  const int a = (int)(reinterpret_cast<uintptr_t>(src + c0) % 16 /
                      sizeof(LT));
  k8::cluster_arrive_relaxed();  // this block has started

  // the warp's running max of the clamped values (every lane the same) and
  // this lane's sum-exp against it; this lane's top-k list
  float m = -FLT_MAX, s = 0.0f;
  float tv[KB];
  int ti[KB];
#pragma unroll
  for (int q = 0; q < KB; ++q) {
    tv[q] = -CUDART_INF_F;
    ti[q] = SENTINEL;
  }
  for (int g0 = c0; g0 < c1; g0 += CH) {
    // chunk [g0, g0 + len): CH % VEC == 0, so every chunk of the slice
    // starts `a` logits past a 16-byte boundary, as the slice does;
    // column g0 + j lands at buf[a + j]
    const int len = min(CH, c1 - g0);
    const LT* gp = src + g0;
    const int head = min((VEC - a) % VEC, len);
    const int nvec = (len - head) / VEC;
    const int tail0 = head + nvec * VEC;
    for (int q = tid; q < nvec; q += T)
      pk::cp_async16(buf + a + head + q * VEC, gp + head + q * VEC, 16);
    pk::cp_async_commit();
    if (tid < head)
      buf[a + tid] = gp[tid];
    else if (tid >= VEC && tid - VEC < len - tail0)
      buf[a + tail0 + tid - VEC] = gp[tail0 + tid - VEC];
    pk::cp_async_wait<0>();
    __syncthreads();
    // thread t takes the groups of VEC columns g = t, t + T, ...: first
    // their max, then the warp's k-th largest lane max (no logit below it
    // can be among the warp's k best), then their sum-exp
    const int ngroups = (len + VEC - 1) / VEC;
    float lmax = -CUDART_INF_F;
#pragma unroll 2
    for (int g = tid; g < ngroups; g += T) {
      float x[VEC];
      k8::load_group<LT>(buf, a, g * VEC, len, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e) lmax = fmaxf(lmax, x[e]);
    }
    float wmax, thr;
    k8::warp_kth_largest(lmax, k, lane, wmax, thr);
    // max over the clamped values == max(max over the values, -FLT_MAX)
    const float nm = fmaxf(m, fmaxf(wmax, -FLT_MAX));
    float cs = 0.0f;
#pragma unroll 2
    for (int g = tid; g < ngroups; g += T) {
      const int j0 = g * VEC, n = min(VEC, len - j0);
      float x[VEC], t[VEC];
      k8::load_group<LT>(buf, a, j0, len, x);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        t[e] = e < n ? k8::ex2((fmaxf(x[e], -FLT_MAX) - nm) * k8::LOG2E)
                     : 0.0f;
      cs += k8::tree_sum<VEC>(t);
    }
    s = s * expf(m - nm) + cs;
    m = nm;
    // only a lane whose max reaches the threshold holds logits that do:
    // those lanes (about k a warp) scan their groups again for the list
    thr = fmaxf(thr, tv[KB - 1]);
    if (lmax >= thr) {
      for (int g = tid; g < ngroups; g += T) {
        const int j0 = g * VEC, n = min(VEC, len - j0);
        float x[VEC];
        k8::load_group<LT>(buf, a, j0, len, x);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (e < n && x[e] >= thr) {
            k8::insert<KB>(tv, ti, x[e], g0 + j0 + e);
            thr = fmaxf(thr, tv[KB - 1]);
          }
      }
    }
    __syncthreads();  // buf read by every thread before the next chunk
  }
  s = topk_lse::warp_sum(s);

  // warp: k rounds of the lanes' list heads (the winning lane drops its
  // head)
  for (int q = 0; q < k; ++q) {
    float bv = tv[0];
    int bi = ti[0];
    topk_lse::warp_best(bv, bi);
    if (bi != SENTINEL && ti[0] == bi) k8::pop<KB>(tv, ti);
    if (lane == 0) {
      w_v[warp * KB + q] = bv;
      w_i[warp * KB + q] = bi;
    }
  }
  if (lane == 0) {
    w_m[warp] = m;
    w_s[warp] = s;
  }
  __syncthreads();

  // block: warp 0 merges the warps' lists and statistics; lane q < k
  // keeps the block's q-th best
  float ov = -CUDART_INF_F, bm = -FLT_MAX, bs = 0.0f;
  int oi = SENTINEL;
  if (warp == 0) {
    float cv[PB];
    int ci[PB];
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      const int e = lane + 32 * p;
      const bool ok = e < NW * KB && e % KB < k;
      cv[p] = ok ? w_v[e] : -CUDART_INF_F;
      ci[p] = ok ? w_i[e] : SENTINEL;
    }
    if (lane < NW) {
      bm = w_m[lane];
      bs = w_s[lane];
    }
    k8::warp_fold(bm, bs);
    float pv = 0.0f;
    int pi = -1;
    for (int q = 0; q < k; ++q) {
      k8::warp_next<PB>(cv, ci, pv, pi, pv, pi);
      if (lane == q) {
        ov = pv;
        oi = pi;
      }
    }
  }

  // cluster: every block's warp 0 writes its result into rank 0's shared
  // memory (slot `rank`), once every block has started; after the
  // cluster's barrier rank 0's warp 0 merges them and writes the row
  k8::cluster_wait();
  if (warp == 0) {
    if (lane < k) {
      cluster.map_shared_rank(&c_v[0], 0)[rank * KB + lane] = ov;
      cluster.map_shared_rank(&c_i[0], 0)[rank * KB + lane] = oi;
    }
    if (lane == 0) {
      cluster.map_shared_rank(&c_m[0], 0)[rank] = bm;
      cluster.map_shared_rank(&c_s[0], 0)[rank] = bs;
    }
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;
  float cv[PC];
  int ci[PC];
#pragma unroll
  for (int p = 0; p < PC; ++p) {
    const int e = lane + 32 * p, r = e / KB, q = e % KB;
    const bool ok = r < C && q < k;
    cv[p] = ok ? c_v[e] : -CUDART_INF_F;
    ci[p] = ok ? c_i[e] : SENTINEL;
  }
  float rm = lane < C ? c_m[lane] : -FLT_MAX;
  float rs = lane < C ? c_s[lane] : 0.0f;
  k8::warp_fold(rm, rs);
  float pv = 0.0f;
  int pi = -1;
  for (int q = 0; q < k; ++q) {
    k8::warp_next<PC>(cv, ci, pv, pi, pv, pi);
    if (lane == q) {
      ov = pv;
      oi = pi;
    }
  }
  if (lane < k) {
    out_v[row * k + lane] = ov;
    out_i[row * k + lane] = oi;
  }
  if (lane == 0) out_lse[row] = rm + logf(rs);
}

template <typename LT, int KB>
int launch(const LT* logits, float* out_v, int64_t* out_i, float* out_lse,
           int N, int V, int k, int C, int S, int CH, cudaStream_t stream) {
  // the opt-in to more than 48 KB of dynamic shared memory, once per device
  static bool opted_in[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(topk_logits_cluster_kernel<LT, KB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             k8::MAX_CHUNK_BYTES + 16);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)N * (unsigned)C);
  cfg.blockDim = dim3(k8::THREADS);
  cfg.dynamicSmemBytes = (size_t)CH * sizeof(LT) + 16;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, topk_logits_cluster_kernel<LT, KB>,
                                 logits, out_v, out_i, out_lse, V, k, S, CH);
}

template <typename LT>
int topk_logits_impl(const LT* logits, float* out_v, int64_t* out_i,
                     float* out_lse, int N, int V, int k, int C, int S,
                     int CH, cudaStream_t stream) {
  // the plan's invariants: C blocks cover [0, V) with no empty slice, the
  // slice and chunk lengths are multiples of ALIGN, the chunk fits
  if (k < 1 || k > MAXK || V < k || N < 0 || C < 1 ||
      C > k8::MAX_CLUSTER || S < 1 || S % k8::ALIGN != 0 || CH < 1 ||
      CH % k8::ALIGN != 0 || (long long)C * S < V ||
      (long long)(C - 1) * S >= V ||
      (long long)CH * sizeof(LT) > k8::MAX_CHUNK_BYTES ||
      (long long)N * C > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  switch (k8::list_len(k)) {
    case 1:
      return launch<LT, 1>(logits, out_v, out_i, out_lse, N, V, k, C, S, CH,
                           stream);
    case 4:
      return launch<LT, 4>(logits, out_v, out_i, out_lse, N, V, k, C, S, CH,
                           stream);
    case 8:
      return launch<LT, 8>(logits, out_v, out_i, out_lse, N, V, k, C, S, CH,
                           stream);
    default:
      return launch<LT, 16>(logits, out_v, out_i, out_lse, N, V, k, C, S, CH,
                            stream);
  }
}

template <typename LT>
const void* kernel_for(int k) {
  switch (k8::list_len(k)) {
    case 1: return (const void*)topk_logits_cluster_kernel<LT, 1>;
    case 4: return (const void*)topk_logits_cluster_kernel<LT, 4>;
    case 8: return (const void*)topk_logits_cluster_kernel<LT, 8>;
    default: return (const void*)topk_logits_cluster_kernel<LT, 16>;
  }
}

}  // namespace

// logits [N, V] (f32 or bf16, rows contiguous, the base 4- or 2-byte
// aligned); outputs vals [N, k] f32, idx [N, k] i64, lse [N] f32; the plan
// (C blocks a row, slice S, chunk CH) from _k8_plan.
#define TOPK_LOGITS_ENTRY(NAME, LT)                                          \
  extern "C" int NAME(const void* logits, void* out_v, void* out_i,          \
                      void* out_lse, int N, int V, int k, int C, int S,      \
                      int CH, void* stream) {                                \
    return topk_logits_impl<LT>((const LT*)logits, (float*)out_v,            \
                                (int64_t*)out_i, (float*)out_lse, N, V, k,   \
                                C, S, CH, (cudaStream_t)stream);             \
  }

TOPK_LOGITS_ENTRY(topk_lse_logits_f32, float)
TOPK_LOGITS_ENTRY(topk_lse_logits_bf16, __nv_bfloat16)

// registers a thread, local (spilled) bytes a thread and static shared
// bytes a block of the kernel for (bf16 or f32, k)
extern "C" int topk_lse_logits_info(int bf16, int k, int* regs,
                                    int* local_bytes, int* smem_bytes) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  const void* fn = bf16 ? kernel_for<__nv_bfloat16>(k) : kernel_for<float>(k);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  *smem_bytes = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

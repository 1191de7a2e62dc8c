// Row logsumexp in one pass over the logits, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas_kernels.py::logsumexp_rows_pallas (the
// _lse_kernel body), which the reference's readout + CE reaches through
// ops/losses.py::_ce_readout_fused when _USE_PALLAS_LSE_READOUT is on.
//
// Computes lse[n] = m + log(sum_v exp(x[n, v] - m)), m = max_v x[n, v], in
// float32 over x [N, V] in float32 or bfloat16, as _lse_kernel does: a row
// whose max is -inf (all -inf) or +inf, or that holds a nan, gives nan,
// since the reference's x - m is then nan somewhere (-inf - -inf,
// inf - inf).
//
// What bounds it on this card: bytes.  Each logit is read once and costs
// one exp; at the training readout (N = 12288, V = 30000, bf16) the read is
// 737 MB, 0.22 ms at 3.35 TB/s, while the 369 M exps take well under that
// on the SFUs.
//
// Design: one warp per row (8 rows a block), no shared memory and no block
// barrier.  Each lane keeps an online (max, sum of exp(x - max)) over its
// share of the row in float32, reading 16 bytes a load (8 bf16 or 4 f32
// values) with four loads in flight; lanes merge with shuffles.  The
// TPU kernel holds a [row_tile, V] block in VMEM and needs N % row_tile ==
// 0; here any N works.  A row that is not 16-byte aligned (V * itemsize
// not a multiple of 16, e.g. V = 50 in bf16) is read with a scalar head up
// to the first aligned element, the aligned vector body, and a scalar
// tail, so the logits are never padded or copied.  The running max starts
// at -FLT_MAX, so a -inf logit adds exp(-inf) == 0 and never a nan; the
// all -inf row (sum 0) and the +inf max are mapped to nan at the end, the
// reference's answer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int WARPS = 8;  // rows per block
constexpr int UNROLL = 4;  // 16-byte loads in flight per lane

struct Stat {
  float m, s;  // running max, sum of exp(x - m)
};

__device__ __forceinline__ void add(Stat& st, float x) {
  if (x > st.m) {
    st.s = st.s * expf(st.m - x) + 1.0f;
    st.m = x;
  } else {
    st.s += expf(x - st.m);  // a nan x makes s nan
  }
}

// n values at once: one rescale for the group's max
template <int n>
__device__ __forceinline__ void add_group(Stat& st, const float (&v)[n]) {
  float vm = v[0];
#pragma unroll
  for (int i = 1; i < n; ++i) vm = fmaxf(vm, v[i]);
  if (vm > st.m) {
    st.s *= expf(st.m - vm);
    st.m = vm;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) st.s += expf(v[i] - st.m);
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one 16-byte vector as float32 values
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of a float32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) lse_rows_kernel(
    const T* __restrict__ x, float* __restrict__ lse, int N, int V) {
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= N) return;  // a whole warp leaves together
  const T* p = x + (size_t)row * V;
  Stat st{-FLT_MAX, 0.0f};
  // scalar head up to the first 16-byte aligned element
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  int head = (int)(((16 - addr % 16) % 16) / sizeof(T));
  if (addr % sizeof(T) != 0 || head > V) head = V;  // no aligned body
  for (int k = lane; k < head; k += 32) add(st, to_f<T>(p[k]));
  const int nvec = (V - head) / VN;
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  int i = lane;
  for (; i + 32 * (UNROLL - 1) < nvec; i += 32 * UNROLL) {
    uint4 r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) r[u] = __ldg(pv + i + 32 * u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float v[VN];
      Vec<T>::widen(r[u], v);
      add_group<VN>(st, v);
    }
  }
  for (; i < nvec; i += 32) {
    float v[VN];
    Vec<T>::widen(__ldg(pv + i), v);
    add_group<VN>(st, v);
  }
  // scalar tail
  for (int k = head + nvec * VN + lane; k < V; k += 32) {
    add(st, to_f<T>(p[k]));
  }
  // merge the lanes
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, st.m, off);
    const float os = __shfl_xor_sync(0xffffffffu, st.s, off);
    const float nm = fmaxf(st.m, om);
    st.s = st.s * expf(st.m - nm) + os * expf(om - nm);
    st.m = nm;
  }
  if (lane == 0) {
    lse[row] = (st.s == 0.0f || isinf(st.m)) ? CUDART_NAN_F
                                              : st.m + logf(st.s);
  }
}

template <typename T>
int lse_rows(const void* x, void* lse, int N, int V, void* stream) {
  if (N < 0 || V < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid((N + WARPS - 1) / WARPS);
  lse_rows_kernel<T><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)x, (float*)lse, N, V);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, V] contiguous (float32 or bfloat16), lse [N] f32 out.  Returns a
// cudaError_t.
extern "C" int logsumexp_rows_f32(const void* x, void* lse, int N, int V,
                                  void* stream) {
  return lse_rows<float>(x, lse, N, V, stream);
}

extern "C" int logsumexp_rows_bf16(const void* x, void* lse, int N, int V,
                                   void* stream) {
  return lse_rows<__nv_bfloat16>(x, lse, N, V, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

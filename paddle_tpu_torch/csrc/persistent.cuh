// Building blocks of the port's persistent kernels, one cooperative launch
// whose blocks stay resident on the SMs for a whole time loop (K9's and
// K10's LSTM loops, lstm_forward.cu and lstm_backward.cu), and the cp.async
// copies they and K6's products (attn_dec_bwd.cu) stream tiles with.
//
// - grid_sync: a grid-wide barrier over co-resident blocks.  An arrival
//   counter in device memory, zero at launch, that only grows: barrier n
//   waits for n * gridDim.x arrivals, so it needs no reset between
//   barriers.  A wait of more than ~2^35 cycles traps, so a fault ends in
//   a CUDA error, never a hung card.
// - cp_async16 / cp_async4 / cp_async_commit / cp_async_wait: 16-byte
//   global -> shared copies that skip L1 (so a block never reads another
//   block's writes from a stale L1 line), 4-byte ones for unaligned rows,
//   grouped and waited for in order.
// - cooperative_launch: the launch, refused (cudaErrorCooperativeLaunch
//   TooLarge) when the card cannot hold every block at once, because the
//   barrier would then wait for a block that never starts.
// - mma_bf16 / pack_b_fragments / warp_product: a warp's tensor-core
//   product of a 16-row bf16 tile, read from L2, with a weight slice held
//   in shared memory in the mma's B-fragment order (K5's products and K3's,
//   attn_dec_fwd.cu and gru_common.cuh; K9 uses mma_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pk {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Grid-wide barrier over co-resident blocks: *bar counts arrivals (zero at
// launch) and only grows, so barrier n waits for n * gridDim.x of them; a
// wait of more than ~2^35 cycles traps.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    while (ld_acquire(bar) < target)
      if (clock64() - t0 > (1ll << 35)) __trap();
    __threadfence();
  }
  __syncthreads();
}

// 16 bytes global -> shared, skipping L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, for rows that are not 16-byte aligned;
// src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One cooperative launch of `kernel` over `blocks` blocks of `threads`,
// with `smem` bytes of dynamic shared memory each; refused unless the card
// holds every block at once.
template <typename Kernel>
int cooperative_launch(Kernel kernel, void** args, int blocks, int threads,
                       size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  // every block must be resident at once, or the barrier would wait forever
  if (!coop || per_sm * sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                          dim3(threads), args, smem, stream);
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A weight slice [K, NT * 8] into B fragments wf [K / 16][NT][32 lanes]
// (8 bytes a lane), by the block's threads: lane l of n8 tile nt at k16
// step ks holds column n = 8 nt + l / 4, rows k = 32 (ks / 2) + 8 (l % 4)
// + 4 (ks % 2) + {0, 1} and + {2, 3}, the order warp_product reads its
// operand in.  col(n, ld) gives column n's first element and sets its row
// stride ld.  K % 32 == 0.
template <typename Col>
__device__ __forceinline__ void pack_b_fragments(uint2* wf, int K, int NT,
                                                 Col col) {
  for (int e = threadIdx.x; e < K / 16 * NT * 32; e += blockDim.x) {
    const int l = e % 32, nt = e / 32 % NT, ks = e / 32 / NT;
    const int k = ks / 2 * 32 + 8 * (l % 4) + 4 * (ks % 2);
    int ld;
    const __nv_bfloat16* w = col(nt * 8 + l / 4, ld);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = (uint32_t)__bfloat16_as_ushort(w[(size_t)(k + i) * ld]);
    wf[e] = make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
  }
}

// acc[nt] += A[rows row0 .. row0 + 15, :K] @ W for the NT n8 tiles of the
// fragments wf, A bf16 with row stride lda (rows at or past nrows read as
// 0), written by other blocks in this launch (read through L2).  The depth
// is taken 32 at a time; lane (g, c) loads the 16 bytes at k = 8c .. 8c + 7
// of rows g and g + 8, which the fragments' packing maps onto the mma's k
// order (k16 step j of the 32 takes k = 8c + 4j + {0, 1} as its k pair 2c
// and 8c + 4j + {2, 3} as its pair 2c + 8): every k order depends on K
// alone.  The loads run one group of four 32-deep pieces ahead of the
// products.
template <int NT>
__device__ __forceinline__ void warp_product(
    const __nv_bfloat16* __restrict__ A, int lda, int row0, int nrows, int K,
    const uint2* __restrict__ wf, float (&acc)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  const bool ok0 = row0 + g < nrows, ok1 = row0 + g + 8 < nrows;
  const __nv_bfloat16* p0 = A + (size_t)(row0 + g) * lda + 8 * c;
  const __nv_bfloat16* p1 = p0 + (size_t)8 * lda;
  const int nk = K / 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 nlo[4], nhi[4];
  auto load = [&](int kb) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = kb + u < nk;
      nlo[u] = in && ok0 ? __ldcg(reinterpret_cast<const uint4*>(
                               p0 + (size_t)(kb + u) * 32))
                         : zero;
      nhi[u] = in && ok1 ? __ldcg(reinterpret_cast<const uint4*>(
                               p1 + (size_t)(kb + u) * 32))
                         : zero;
    }
  };
  load(0);
  for (int kb = 0; kb < nk; kb += 4) {
    uint4 lo[4], hi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      lo[u] = nlo[u];
      hi[u] = nhi[u];
    }
    if (kb + 4 < nk) load(kb + 4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (kb + u >= nk) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t a[4] = {j ? lo[u].z : lo[u].x, j ? hi[u].z : hi[u].x,
                               j ? lo[u].w : lo[u].y, j ? hi[u].w : hi[u].y};
        const uint2* wk = wf + (size_t)((kb + u) * 2 + j) * NT * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 bv = wk[nt * 32];
          mma_bf16(acc[nt], a, bv.x, bv.y);
        }
      }
    }
  }
}

}  // namespace pk

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

#pragma once

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

}  // namespace pk

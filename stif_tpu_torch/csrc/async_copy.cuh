// Asynchronous copies into shared memory on Hopper (sm_90a): cp.async,
// mbarriers and the bulk copy of the TMA engine without a tensor map
// (cp.async.bulk), shared by the port's kernels (siren_fused.cu,
// deform_conv.cu).
//
// The pattern: one thread arms a stage's mbarrier with the bytes it expects
// (mbar_arrive_expect) and starts bulk copies that complete against it; the
// block waits on the barrier's phase parity before reading the stage. A
// stage filled by ordinary cp.async instead is armed by one plain arrive,
// and every thread waits for its own copies (cp_async_wait_all) before the
// block synchronises.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

// Orders this thread's earlier ordinary accesses of shared memory before
// later copies of the async proxy into it.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned `src` to 16-byte aligned
// shared `dst`, completing against `bar`, with no fence: for a stage whose
// earlier reads a barrier of the block has ordered before the copy.
__device__ __forceinline__ void bulk_copy_unfenced(float* dst,
                                                   const float* src,
                                                   int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same after this thread's ordinary accesses of shared memory.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  proxy_fence();
  bulk_copy_unfenced(dst, src, bytes, bar);
}

// 1-D bulk copies from global to shared memory (cp.async.bulk, sm_90) that
// complete on an mbarrier, shared by K1 (bsr_spmv.cu) and K2's float32 body
// (bsr_spmm.cu). One thread posts the byte count a stage expects and issues
// the copies; every thread waits on the stage's phase.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace bulk {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A barrier of one arrival a phase; then fence, before any thread uses it.
__device__ __forceinline__ void init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of a stage's phase, expecting `bytes` from bulk copies.
// The fence orders the threads' earlier reads of the stage (joined by a
// barrier before it) before the copies that overwrite it.
__device__ __forceinline__ void expect(uint64_t* bar, unsigned bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Blocks until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completing on the barrier.
__device__ __forceinline__ void copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace bulk

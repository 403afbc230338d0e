// bench_ops.cuh -- single 32-bit integer instructions as inline PTX, for
// the measurement kernels K7a (roofline.cu) and K7c (issue_rates.cu).
//
// Each op is its own asm volatile statement on registers whose values come
// from the kernel's inputs, so nvcc can neither fold, strength-reduce nor
// drop it, and every result flows into what the kernel writes.  ptxas
// still schedules the SASS freely.  Each op has a plain counterpart in
// libff_tpu_torch/roofline.py or issue_rates.py, over int64 tensors masked
// to 32 bits, which the card's results are held against bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lff {

__device__ __forceinline__ uint32_t op_mul_lo(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t op_mul_hi(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("mul.hi.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

// lo(x * y) + c
__device__ __forceinline__ uint32_t op_mad_lo(uint32_t x, uint32_t y,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(x), "r"(y), "r"(c));
  return r;
}

// hi(x * y) + c
__device__ __forceinline__ uint32_t op_mad_hi(uint32_t x, uint32_t y,
                                              uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.u32 %0, %1, %2, %3;"
               : "=r"(r)
               : "r"(x), "r"(y), "r"(c));
  return r;
}

__device__ __forceinline__ uint32_t op_add(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("add.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t op_sub(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("sub.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t op_and(uint32_t x, uint32_t y) {
  uint32_t r;
  asm volatile("and.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t op_shr(uint32_t x, uint32_t s) {
  uint32_t r;
  asm volatile("shr.u32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

}  // namespace lff

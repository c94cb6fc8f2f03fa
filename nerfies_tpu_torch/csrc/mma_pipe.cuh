// Building blocks of the pipelined kernels (fused_mlp_bwd.cu,
// weight_grad.cu): cp.async copies into shared memory, bulk copies out of
// it, ldmatrix loads of mma fragments, and mma.sync.m16n8k16 bf16
// products with f32 accumulators.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): for
// lane l, g = l / 4 and q = l % 4,
//   A (16 x 16, row-major):  a0 (g, 2q..2q+1), a1 (g + 8, 2q..),
//                            a2 (g, 8 + 2q..), a3 (g + 8, 8 + 2q..);
//   B (16 x 8, k x n):       b0 (k 2q..2q+1, n g), b1 (k 8 + 2q.., n g);
//   C (16 x 8, f32):         c0, c1 (g, 2q..2q+1), c2, c3 (g + 8, 2q..).
// ldmatrix hands lane l row l / 4, columns 2 (l % 4) .. + 1 of each 8 x 8
// matrix whose 8 row addresses lanes 8i .. 8i + 7 give; .trans hands the
// transposed element. So a B fragment comes from a (k, n) tile stored
// with n contiguous through .trans, and from an (n, k) tile stored with k
// contiguous without it: the weights' (in, out) layout serves both the
// product with W and the product with W^T.
//
// Everything below the includes lies in an anonymous namespace, so each
// file that includes this header has its own copy with internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; zeros when !pred
// (the source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, run by the copy engine (sm_90);
// commit and wait as for cp.async, in their own groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::);
}

// Waits until this thread's bulk copies are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Waits until this thread's bulk copies have read their shared-memory
// sources, which may then be overwritten; their global writes may still
// be in flight.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's earlier shared-memory writes before later reads of
// the copy engine (the async proxy); a barrier must follow.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same between the copy engine's completed writes and this thread's
// later accesses, in any state space (global memory too).
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a @ b, one m16n8k16 bf16 product with f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row and column (within a 16-row, 8-column output tile) of accumulator
// element e (0..3) of this lane.
__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int lane, int e) {
  return 2 * (lane & 3) + (e & 1);
}

}  // namespace

// Building blocks of the training warp trunk's forward (fused_warp.cu: the
// primal and tangent chains): row tiles in shared memory, weight slices
// streamed from L2, nvcuda::wmma bf16 products with f32 accumulators, and
// the epilogue that writes f32 head outputs. The serving forwards
// (fused_mlp.cu) and the backward row passes use row_pass.cuh instead.
//
// Layout conventions. A block of NTHREADS = 256 threads (8 warps) owns BM =
// 64 rows. Warp w owns the 16 rows 16*(w%4) .. +16 of every product and the
// 16-column tiles w/4, w/4 + 2, ... of its output. Activation tiles live in
// shared memory with SPAD elements of padding per row; weights are
// row-major (Flax's (in, out) layout) in global memory, and every product
// here streams them as they are.
//
// Everything below the includes lies in an anonymous namespace, so each
// file that includes this header has its own copy with internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;          // rows per block
constexpr int NTHREADS = 256;   // 8 warps: 4 row groups x 2 column groups
constexpr int BK = 32;          // weight rows staged per slice
constexpr int SPAD = 8;         // shared-memory row padding (bf16 elements)
constexpr int CPAD = 64;        // input columns, zero-padded
constexpr int LDX = CPAD + SPAD;
constexpr int HEAD = 16;        // head columns, zero-padded
constexpr int LDG = HEAD + SPAD;
constexpr int OUT_COLS = 8;     // head columns written out
constexpr int MAXD = 16;        // most trunk layers

template <int N>
struct Acc {
  static constexpr int TILES = N / 16;
  static constexpr int PER_WARP = (TILES + 1) / 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[PER_WARP];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < PER_WARP; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
};

// acc += A[BM x K] @ W[K x N]. A lies in shared memory with row stride
// lda; W is row-major in global memory, K a multiple of 16, N a multiple
// of 16. Every thread of the block calls it.
template <int N>
__device__ void accumulate(Acc<N>& acc, const bf16* a_s, int lda, int k,
                           const bf16* __restrict__ w_g, bf16* w_s) {
  constexpr int LDW = N + SPAD;
  constexpr int VPR = N / 8;  // 16-byte vectors per weight row
  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3, cg = warp >> 2;
  for (int k0 = 0; k0 < k; k0 += BK) {
    const int kk = min(BK, k - k0);
    __syncthreads();  // the previous slice (or layer) is consumed
    for (int v = threadIdx.x; v < kk * VPR; v += NTHREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      *reinterpret_cast<uint4*>(w_s + r * LDW + c) =
          *reinterpret_cast<const uint4*>(w_g + (size_t)(k0 + r) * N + c);
    }
    __syncthreads();
    for (int ks = 0; ks < kk; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_s + rg * 16 * lda + k0 + ks, lda);
#pragma unroll
      for (int j = 0; j < Acc<N>::PER_WARP; ++j) {
        const int t = cg + 2 * j;
        if (t < Acc<N>::TILES) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w_s + ks * LDW + t * 16, LDW);
          wmma::mma_sync(acc.f[j], a, b, acc.f[j]);
        }
      }
    }
  }
}

// acc[c] += A_c[BM x K] @ W[K x N] for C chains that share W: each staged
// weight slice and each loaded B fragment serves every chain. It holds all
// of a step's B fragments in registers, which `accumulate` does not: for a
// single 256-wide chain that would cost 64 more registers a thread.
template <int N, int C>
__device__ void accumulate_chains(Acc<N> (&acc)[C],
                                  const bf16* const (&a_s)[C], int lda,
                                  int k, const bf16* __restrict__ w_g,
                                  bf16* w_s) {
  constexpr int LDW = N + SPAD;
  constexpr int VPR = N / 8;
  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3, cg = warp >> 2;
  for (int k0 = 0; k0 < k; k0 += BK) {
    const int kk = min(BK, k - k0);
    __syncthreads();
    for (int v = threadIdx.x; v < kk * VPR; v += NTHREADS) {
      const int r = v / VPR, c = (v % VPR) * 8;
      *reinterpret_cast<uint4*>(w_s + r * LDW + c) =
          *reinterpret_cast<const uint4*>(w_g + (size_t)(k0 + r) * N + c);
    }
    __syncthreads();
    for (int ks = 0; ks < kk; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[Acc<N>::PER_WARP];
#pragma unroll
      for (int j = 0; j < Acc<N>::PER_WARP; ++j) {
        const int t = cg + 2 * j;
        if (t < Acc<N>::TILES)
          wmma::load_matrix_sync(b[j], w_s + ks * LDW + t * 16, LDW);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, a_s[c] + rg * 16 * lda + k0 + ks, lda);
#pragma unroll
        for (int j = 0; j < Acc<N>::PER_WARP; ++j) {
          if (cg + 2 * j < Acc<N>::TILES)
            wmma::mma_sync(acc[c].f[j], a, b[j], acc[c].f[j]);
        }
      }
    }
  }
}

// out[rows_valid x OUT_COLS] (global, f32) = acc + bias, for a HEAD-wide
// product: one 16-column tile, held by the warps of column group 0. bias
// may be null (a tangent chain's head has none).
__device__ void epilogue_head(Acc<HEAD>& acc, const bf16* __restrict__ bias,
                              int rows_valid, float* __restrict__ out,
                              float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, cg = warp >> 2;
  if (cg != 0) return;
  float* s = scratch + warp * 256;
  wmma::store_matrix_sync(s, acc.f[0], 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = rg * 16 + (e >> 4), c = e & 15;
    if (c < OUT_COLS && r < rows_valid)
      out[(size_t)r * OUT_COLS + c] =
          s[e] + (bias != nullptr ? __bfloat162float(bias[c]) : 0.0f);
  }
  __syncwarp();
}

// src rows row0 .. row0 + BM (global f32, row stride c_src) -> a bf16 tile
// of COLS zero-padded columns in shared memory (row stride ld).
template <int COLS>
__device__ void load_tile(const float* __restrict__ src, int c_src, int row0,
                          int rows_valid, bf16* dst, int ld) {
  for (int e = threadIdx.x; e < BM * COLS; e += NTHREADS) {
    const int r = e / COLS, c = e % COLS;
    float v = 0.0f;
    if (r < rows_valid && c < c_src) v = src[(size_t)(row0 + r) * c_src + c];
    dst[r * ld + c] = __float2bfloat16(v);
  }
}

template <typename Kernel, typename Args>
cudaError_t launch_rows(Kernel kernel, const Args& a, int rows, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + BM - 1) / BM;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

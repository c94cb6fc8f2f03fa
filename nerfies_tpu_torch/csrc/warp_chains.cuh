// The warp trunk's chains stacked in one row tile, shared by its forward
// (fused_warp.cu) and its backward's row pass (fused_warp_bwd.cu): the
// stacking, the loads of every chain's input, the terms of a layer's
// product, the forward epilogue with its rounding points and the f32
// outputs written per chain.
//
// The primal chain and 0 or 3 tangent chains (d pe / d x_j) run through
// one RBM-row tile of row_pass.cuh's engine. A block owns RC = RBM / C rows
// of each of its C chains, stacked so that a warp's MT m16 tiles hold the
// same 16 rows of every chain in turn: m-tile mt belongs to chain mt % C.
// So each weight slice streamed from L2 serves RBM chain-rows, a layer of
// all chains is one product, and one lane holds the same element of every
// chain: the primal's ReLU mask passes to the tangents in registers.
//
// Rounding points (nerfies_tpu/ops/fused_warp.py _fwd_tile): bf16
// operands (x, the metadata embedding, the tangents, every activation),
// f32 sums with the bias added in f32, the mask taken from the primal's
// f32 pre-activation and passed to the tangents, which take no bias; f32
// head outputs, the head's bias on the primal only.
//
// Everything below the includes lies in an anonymous namespace, so each
// file that includes this header has its own copy with internal linkage.

#pragma once

#include "row_pass.cuh"

namespace {

constexpr int MAXT = 3;       // most tangent chains

// The stacking of C chains in an RBM-row tile whose warps own MT m16 tiles
// each: stacked 16-row group q holds chain q % C's local rows (q / C) * 16
// .. + 16, so a warp's m-tile mt belongs to chain mt % C, and the C m-tiles
// p * C .. + C hold the same rows of every chain.
template <int C, int MT>
struct Chains {
  static_assert(MT % C == 0, "a warp's m-tiles cover every chain alike");
  static constexpr int RC = RBM / C;  // rows of each chain
  __device__ static int chain(int s) { return (s >> 4) % C; }
  __device__ static int local(int s) { return (s >> 4) / C * 16 + (s & 15); }
  // The local row of this warp's first m-tile of each chain.
  __device__ static int warp_local0() {
    return (Frag<16, MT>::row0() >> 4) / C * 16;
  }
};

// The stacked tile of COLS bf16 columns (shared, row stride ld) from one
// f32 source per chain (global, the chain's first row of the block, row
// stride c_src; null: zeros), zero past c_src columns and rows_valid rows.
template <int COLS, int THREADS, int C, int MT>
__device__ void load_chains(const float* const (&src)[C], int c_src,
                            int rows_valid, bf16* dst, int ld) {
  using Ch = Chains<C, MT>;
  constexpr int PER_THREAD = RBM * COLS / THREADS;
  float v[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int s = e / COLS, c = e % COLS;
    const int ch = Ch::chain(s), l = Ch::local(s);
    const float* p = src[0];
#pragma unroll
    for (int k = 1; k < C; ++k)
      if (ch == k) p = src[k];
    v[i] = p != nullptr && l < rows_valid && c < c_src
               ? p[(size_t)l * c_src + c]
               : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    dst[(e / COLS) * ld + e % COLS] = __float2bfloat16(v[i]);
  }
}

// The terms of trunk layer i's product over every chain (a: the kernel's
// arguments, with w, wx, we and skip_mask): the layer input's (xs at layer
// 0, else the activations h, row stride W + RPAD), the encoding's at a
// skip, and the embedding's (es, zero in the tangents' rows) at layer 0 and
// at a skip.
template <int W, class Args>
__device__ __forceinline__ void layer_terms(const Args& a, int i,
                                            const bf16* xs, const bf16* es,
                                            const bf16* h, Seg (&s)[3]) {
  const bool skip = i > 0 && ((a.skip_mask >> i) & 1);
  s[0] = i == 0 ? Seg{xs, LDX, CPAD, a.w[0]} : Seg{h, W + RPAD, W, a.w[i]};
  s[1] = Seg{xs, LDX, skip ? CPAD : 0, a.wx[i]};
  s[2] = Seg{es, LDG, i == 0 || skip ? HEAD : 0, a.we[i]};
}

// Bit of a thread's mask word for element (2h, 2h + 1) of n8 tile j of its
// p-th primal m-tile: the low one of the pair.
template <int NTW>
__device__ __forceinline__ int mask_bit(int p, int j, int h) {
  return ((p * NTW + j) * 2 + h) * 2;
}

// A trunk layer's epilogue (out: shared, row stride ldo, in place): the
// primal's m-tiles take bf16(ReLU(acc + bias)), each tangent's m-tile
// bf16(acc) under the primal's f32 mask. With MASKS, *mask_word receives
// the backward's mask of this thread's primal elements: bf16 activation
// > 0; without, mask_word is not used.
template <int C, bool MASKS = true, int N, int MT>
__device__ void epi_fwd(const Frag<N, MT>& acc, const bf16* bias, bf16* out,
                        int ldo, uint32_t* mask_word) {
  constexpr int NTW = Frag<N, MT>::NTW;
  static_assert(!MASKS || MT / C * NTW * 4 <= 32,
                "one word holds a thread's mask");
  const int lane = threadIdx.x & 31;
  const int wm = Frag<N, MT>::row0(), c0 = Frag<N, MT>::col0() + 2 * (lane & 3);
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + c0 + j * 8));
#pragma unroll
    for (int p = 0; p < MT / C; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mt = p * C;
        const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
        const float v0 = acc.c[mt][j][2 * h] + b.x;
        const float v1 = acc.c[mt][j][2 * h + 1] + b.y;
        const bool on0 = v0 > 0.0f, on1 = v1 > 0.0f;
        const __nv_bfloat162 hv =
            __floats2bfloat162_rn(on0 ? v0 : 0.0f, on1 ? v1 : 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c0 + j * 8) = hv;
        if constexpr (MASKS) {
          const int bit = mask_bit<NTW>(p, j, h);
          bits |= (uint32_t)(__low2float(hv) > 0.0f) << bit;
          bits |= (uint32_t)(__high2float(hv) > 0.0f) << (bit + 1);
        }
#pragma unroll
        for (int c = 1; c < C; ++c)
          *reinterpret_cast<__nv_bfloat162*>(out + (r + c * 16) * ldo + c0 +
                                             j * 8) =
              __floats2bfloat162_rn(on0 ? acc.c[mt + c][j][2 * h] : 0.0f,
                                    on1 ? acc.c[mt + c][j][2 * h + 1] : 0.0f);
      }
    schedule_fence();
  }
  if constexpr (MASKS) *mask_word = bits;
}

// out[c][l, col] (global f32, chain c's first row of the block, row stride
// ld; null: chain c is left out) = (add ? out : 0) + bias[col] (primal
// chain only; bf16, N columns, or null) + acc, for the valid local rows l
// and the first ncols columns. The same thread writes and later re-reads
// each element.
template <int C, int N, int MT>
__device__ void epi_f32_chains(const Frag<N, MT>& acc, float* const (&out)[C],
                               int ld, int ncols, int rows_valid, bool add,
                               const bf16* bias = nullptr) {
  constexpr int NTW = Frag<N, MT>::NTW;
  const int lane = threadIdx.x & 31;
  const int nb0 = Frag<N, MT>::col0();
  if (nb0 >= N) return;
  const int l0 = Chains<C, MT>::warp_local0();
  float prev[NTW][MT][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* o = out[mt % C];
        const int r = l0 + mt / C * 16 + frag_row(lane, e);
        const int c = nb0 + j * 8 + frag_col(lane, e);
        float v = add && o != nullptr && c < ncols && r < rows_valid
                      ? o[(size_t)r * ld + c]
                      : 0.0f;
        if (bias != nullptr && mt % C == 0) v += __bfloat162float(bias[c]);
        prev[j][mt][e] = v;
      }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* o = out[mt % C];
        const int r = l0 + mt / C * 16 + frag_row(lane, e);
        const int c = nb0 + j * 8 + frag_col(lane, e);
        if (o != nullptr && c < ncols && r < rows_valid)
          o[(size_t)r * ld + c] = prev[j][mt][e] + acc.c[mt][j][e];
      }
}

}  // namespace

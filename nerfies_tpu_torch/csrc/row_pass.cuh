// The product engine of the pipelined row passes (fused_mlp_bwd.cu, the
// NeRF MLP's backward, and fused_warp_bwd.cu, the warp trunk's) and of the
// serving forwards (fused_mlp.cu): a block of RBM rows, mma.sync.m16n8k16
// bf16 products with f32 accumulators in registers fed by ldmatrix, weight
// slices streamed through a ring of cp.async stages with one barrier per
// slice, products of up to a few terms (A_i @ B_i) in one slice stream, B
// = W or W^T read from the weight's (in, out) layout without a transposed
// copy, epilogues that write in place after a product's closing barrier,
// and workspace tiles sent out as bulk copies.
//
// Everything below the includes lies in an anonymous namespace, so each
// file that includes this header has its own copy with internal linkage.

#pragma once

#include "mma_pipe.cuh"

namespace {

constexpr int RBM = 128;        // rows per block

// Threads of a block whose warps own mt m16 tiles of rows (mt * 16 rows)
// and a quarter of the columns of every product each.
__host__ __device__ constexpr int threads_for(int mt) {
  return RBM / (mt * 16) * 4 * 32;
}

// A warp owns MT m16 tiles of rows (MT * 16 rows) and a quarter of the
// columns of every product of a NeRF MLP of width W: MT = 4, 8 warps, at
// width 256, where a thread's 128 accumulators leave no room for a second
// warp's worth of state; MT = 2, 16 warps, below, for twice the warps to
// hide latency.
template <int W>
__host__ __device__ constexpr int mtiles() { return W > 128 ? 4 : 2; }

constexpr int RPAD = 8;         // shared row padding (bf16 elements)
constexpr int CPAD = 64;        // input columns, zero-padded
constexpr int LDX = CPAD + RPAD;
constexpr int HEAD = 16;        // head columns, zero-padded
constexpr int LDG = HEAD + RPAD;
constexpr int OUT_COLS = 8;     // head columns of g_alpha and g_rgb
constexpr int MAXD = 16;        // most trunk layers

// The accumulators of one warp for an RBM x N product: MT m16 tiles by NTW
// n8 tiles, the warp's column quarter (for N = 16, warps of quarters 2 and
// 3 hold none).
template <int N, int MT_>
struct Frag {
  static constexpr int MT = MT_;
  static constexpr int ROW_GROUPS = RBM / (MT * 16);
  static constexpr int NT = N / 8;
  static constexpr int NTW = NT >= 4 ? NT / 4 : 1;
  float c[MT][NTW][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][j][e] = 0.0f;
  }
  __device__ static int row0() {
    return ((threadIdx.x >> 5) % ROW_GROUPS) * MT * 16;
  }
  __device__ static int col0() {
    return ((threadIdx.x >> 5) / ROW_GROUPS) * NTW * 8;
  }
};

// The weight ring: STAGES stages of STAGE bf16 elements, each holding KS
// rows (k) of a weight slice. READS_BACK: the kernel reads workspace rows
// that its own bulk stores wrote (a side copy does), so a product waits
// for those stores to complete; otherwise only for them to have read
// their shared-memory tiles, which is much sooner.
template <int KS_, int STAGES_, int STAGE_, bool READS_BACK_ = true>
struct Pipe {
  static constexpr int KS = KS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int STAGE = STAGE_;
  static constexpr bool READS_BACK = READS_BACK_;
};

// A tile that a product copies into shared memory beside its weight
// slices: RBM rows of COLS bf16 columns (a multiple of 8), row stride COLS
// at src (global) and LDD at dst (shared). The strides are constants, to
// spare registers where a thread holds 128 accumulators; COLS = 0: none.
template <int COLS_, int LDD_>
struct Side {
  static constexpr int COLS = COLS_;
  static constexpr int LDD = LDD_;
  const bf16* src;
  bf16* dst;
};
using NoSide = Side<0, 0>;

// One term of a product: A[RBM x k] in shared memory (row stride lda)
// times k rows of B taken from w. A product sums its terms in one set of
// accumulators, their weight slices one stream; k = 0 leaves a term out.
struct Seg {
  const bf16* a;
  int lda;
  int k;            // a multiple of 16, or 0
  const bf16* w;
};

// The weight slice that step t of a product streams.
struct Slice {
  const bf16* a;    // A at the slice's first column
  int lda;
  const bf16* w;
  int k, k0, kk;    // the term's depth, the slice's offset and depth
};

template <class P, int NSEG>
__device__ __forceinline__ int slice_count(const Seg (&s)[NSEG]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < NSEG; ++i) n += (s[i].k + P::KS - 1) / P::KS;
  return n;
}

template <class P, int NSEG>
__device__ __forceinline__ Slice slice_at(const Seg (&s)[NSEG], int t) {
  Slice r = {nullptr, 0, nullptr, 0, 0, 0};
  int first = 0;
#pragma unroll
  for (int i = 0; i < NSEG; ++i) {
    const int n = (s[i].k + P::KS - 1) / P::KS;
    if (t >= first && t < first + n) {
      r.k0 = (t - first) * P::KS;
      r.kk = min(P::KS, s[i].k - r.k0);
      r.a = s[i].a + r.k0;
      r.lda = s[i].lda;
      r.w = s[i].w;
      r.k = s[i].k;
    }
    first += n;
  }
  return r;
}

// Stages slice r of B: for B = W (W: k x N) its rows k0 .. k0 + kk, stored
// (k, n); for B = W^T (TRANS, W: N x k) columns k0 .. k0 + kk of every row
// of W, stored (n, k).
template <int N, bool TRANS, class P>
__device__ __forceinline__ void load_slice(const Slice& r, bf16* stage) {
  constexpr int LDW = TRANS ? P::KS + RPAD : N + RPAD;
  const int tid = threadIdx.x;
  if constexpr (!TRANS) {
    for (int v = tid; v < r.kk * (N / 8); v += blockDim.x) {
      const int i = v / (N / 8), c = (v % (N / 8)) * 8;
      cp_async16(stage + i * LDW + c, r.w + (size_t)(r.k0 + i) * N + c, true);
    }
  } else {
    const int vpr = r.kk / 8;
    for (int v = tid; v < N * vpr; v += blockDim.x) {
      const int i = v / vpr, c = (v % vpr) * 8;
      cp_async16(stage + i * LDW + c, r.w + (size_t)i * r.k + r.k0 + c, true);
    }
  }
}

// Issues a product's first STAGES - 1 weight slices. Every thread calls it,
// after the previous product's closing barrier: the ring is free then, and
// the slices land while the previous epilogue runs.
template <int N, bool TRANS, class P, int NSEG>
__device__ void begin(const Seg (&s)[NSEG], bf16* ring) {
  const int steps = slice_count<P>(s);
#pragma unroll
  for (int i = 0; i < P::STAGES - 1; ++i) {
    if (i < steps)
      load_slice<N, TRANS, P>(slice_at<P>(s, i), ring + i * P::STAGE);
    cp_async_commit();
  }
}

// acc += sum over terms of A @ B, with B = W or, when TRANS, W^T: the rest
// of a product whose `begin` ran. Every thread calls it. Slices flow
// through a ring of P::STAGES cp.async stages, one barrier per slice; the
// side copy, if any, is spread over the slices. It ends with a barrier,
// after which the ring, every A and the side copy's tile may be written or
// read by any thread, and this block's bulk stores have read their tiles
// (with P::READS_BACK, are complete and visible to its reads).
template <int N, bool TRANS, class P, int NSEG, int MT, class S = NoSide>
__device__ void run(Frag<N, MT>& acc, const Seg (&s)[NSEG], bf16* ring,
                    const S& side = S{nullptr, nullptr}) {
  constexpr int NTW = Frag<N, MT>::NTW;
  constexpr int LDW = TRANS ? P::KS + RPAD : N + RPAD;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wm = Frag<N, MT>::row0(), nb0 = Frag<N, MT>::col0();
  const int steps = slice_count<P>(s);
  constexpr int SIDE_VPR = S::COLS / 8;  // 16-byte vectors per row
  const int side_vecs = side.src != nullptr ? RBM * SIDE_VPR : 0;
  const int side_step = steps > 0 ? (side_vecs + steps - 1) / steps : 0;

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<P::STAGES - 2>();
    __syncthreads();  // slice t has landed; slice t - 1 is consumed
    if (t + P::STAGES - 1 < steps)
      load_slice<N, TRANS, P>(slice_at<P>(s, t + P::STAGES - 1),
                              ring + ((t + P::STAGES - 1) % P::STAGES) *
                                         P::STAGE);
    if constexpr (S::COLS > 0) {
      const int v_end = min(side_vecs, (t + 1) * side_step);
      for (int v = t * side_step + tid; v < v_end; v += blockDim.x) {
        const int i = v / SIDE_VPR, c = (v % SIDE_VPR) * 8;
        cp_async16(side.dst + i * S::LDD + c,
                   side.src + (size_t)i * S::COLS + c, true);
      }
    }
    cp_async_commit();
    if (nb0 >= N) continue;
    const Slice r = slice_at<P>(s, t);
    const bf16* ws = ring + (t % P::STAGES) * P::STAGE;
#pragma unroll
    for (int ks = 0; ks < P::KS; ks += 16) {
      if (ks >= r.kk) break;
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], r.a + (wm + mt * 16 + (lane & 15)) * r.lda + ks +
                            ((lane >> 4) << 3));
      if constexpr (NTW >= 2) {
#pragma unroll
        for (int jp = 0; jp < NTW / 2; ++jp) {
          const int nb = nb0 + jp * 16;
          uint32_t b[4];
          if constexpr (!TRANS)
            ldsm_x4_t(b, ws + (ks + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                  LDW +
                             nb + ((lane >> 4) << 3));
          else
            ldsm_x4(b, ws + (nb + (lane & 7) + ((lane >> 4) << 3)) * LDW +
                           ks + (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16816(acc.c[mt][2 * jp], af[mt], b[0], b[1]);
            mma16816(acc.c[mt][2 * jp + 1], af[mt], b[2], b[3]);
          }
        }
      } else {
        const int l16 = lane & 15;
        uint32_t b[2];
        if constexpr (!TRANS)
          ldsm_x2_t(b, ws + (ks + (l16 & 7) + ((l16 >> 3) << 3)) * LDW + nb0);
        else
          ldsm_x2(b, ws + (nb0 + (l16 & 7)) * LDW + ks + ((l16 >> 3) << 3));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(acc.c[mt][0], af[mt], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (P::READS_BACK) {
    bulk_wait();
    fence_async_all();
  } else {
    bulk_wait_read();
  }
  __syncthreads();
}

// begin and run for a product whose terms `make` writes into a list made
// on the spot.
template <int N, bool TRANS, class P, int NSEG, class Make>
__device__ __forceinline__ void begin_with(Make make, bf16* ring) {
  Seg s[NSEG];
  make(s);
  begin<N, TRANS, P>(s, ring);
}

template <int N, bool TRANS, class P, int NSEG, class Make, int MT,
          class S = NoSide>
__device__ __forceinline__ void run_with(Frag<N, MT>& acc, Make make,
                                         bf16* ring,
                                         const S& side = S{nullptr, nullptr}) {
  Seg s[NSEG];
  make(s);
  run<N, TRANS, P>(acc, s, ring, side);
}

// Runs an epilogue and the next product's `begin`: the begin first where
// EARLY, so that its slices land during the epilogue.
template <bool EARLY, class Begin, class Epilogue>
__device__ __forceinline__ void then(Begin begin_next, Epilogue epilogue) {
  if constexpr (EARLY) begin_next();
  epilogue();
  if constexpr (!EARLY) begin_next();
}

// The epilogues below read a column pair's bias, or a row's masks,
// before they use any of it, so that each pays one load latency
// per step: all warps of the block reach an epilogue together, and
// nothing else would hide it. schedule_fence() ends a step, so that the
// compiler does not hoist every step's loads at once, which costs
// registers a thread with 128 accumulators does not have.

// Keeps the compiler from moving memory accesses across it.
__device__ __forceinline__ void schedule_fence() {
  asm volatile("" ::: "memory");
}

// out (shared, row stride ldo) = bf16(act(acc + bias + row_bias)), with
// row_bias (global, the block's first row, row stride N; only when
// ROW_BIAS, and then possibly null) added on the valid rows and the ReLU
// when `relu`. Without ROW_BIAS no registers go to row biases.
template <int N, bool ROW_BIAS = false, int MT>
__device__ void epi_act(const Frag<N, MT>& acc, const bf16* __restrict__ bias,
                        const bf16* __restrict__ row_bias, int rows_valid,
                        bool relu, bf16* out, int ldo) {
  constexpr int NTW = Frag<N, MT>::NTW;
  const int lane = threadIdx.x & 31;
  const int wm = Frag<N, MT>::row0(), nb0 = Frag<N, MT>::col0();
  if (nb0 >= N) return;
  const int c0 = nb0 + 2 * (lane & 3);
  float2 rb[ROW_BIAS ? MT : 1][2][ROW_BIAS ? NTW : 1];
  if constexpr (ROW_BIAS) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
          rb[mt][h][j] = row_bias != nullptr && r < rows_valid
                             ? __bfloat1622float2(
                                   *reinterpret_cast<const __nv_bfloat162*>(
                                       row_bias + (size_t)r * N + c0 + j * 8))
                             : make_float2(0.0f, 0.0f);
        }
  }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(bias + c0 + j * 8));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
        float v0 = acc.c[mt][j][2 * h] + b.x;
        float v1 = acc.c[mt][j][2 * h + 1] + b.y;
        if constexpr (ROW_BIAS) {
          v0 += rb[mt][h][j].x;
          v1 += rb[mt][h][j].y;
        }
        if (relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c0 + j * 8) =
            __floats2bfloat162_rn(v0, v1);
      }
    schedule_fence();
  }
}

// A cotangent product rounded to bf16, zeroed where mask <= 0 (mask: the
// layer's bf16 activation, the block's first row, row stride ldm, in
// shared or global memory, or null), to shared memory (out, row stride
// ldo) and as f32 to f32_out (global, the block's first row, row stride
// N, valid rows only, or null). The mask is read a row at a time.
template <int N, int MT>
__device__ void epi_grad(const Frag<N, MT>& acc, const bf16* mask, int ldm,
                         bf16* out, int ldo, float* __restrict__ f32_out,
                         int rows_valid) {
  constexpr int NTW = Frag<N, MT>::NTW;
  const int lane = threadIdx.x & 31;
  const int wm = Frag<N, MT>::row0(), nb0 = Frag<N, MT>::col0();
  if (nb0 >= N) return;
  const int c0 = nb0 + 2 * (lane & 3);
  const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
      __nv_bfloat162 m[NTW];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        m[j] = mask != nullptr ? *reinterpret_cast<const __nv_bfloat162*>(
                                     mask + (size_t)r * ldm + c0 + j * 8)
                               : __floats2bfloat162_rn(1.0f, 1.0f);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int c = c0 + j * 8;
        __nv_bfloat162 v = __floats2bfloat162_rn(acc.c[mt][j][2 * h],
                                                 acc.c[mt][j][2 * h + 1]);
        if (!(__low2float(m[j]) > 0.0f)) v.x = zero;
        if (!(__high2float(m[j]) > 0.0f)) v.y = zero;
        *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c) = v;
        if (f32_out != nullptr && r < rows_valid)
          *reinterpret_cast<float2*>(f32_out + (size_t)r * N + c) =
              make_float2(__low2float(v), __high2float(v));
      }
      schedule_fence();
    }
}

// out[r, c] (global f32, the block's first row, row stride ld) =
// (add ? out[r, c] : 0) + bias[c] + acc, for the valid rows and the first
// ncols columns; bias (bf16, N columns) may be null. The same thread
// writes and later re-reads each element.
template <int N, int MT>
__device__ void epi_f32(const Frag<N, MT>& acc, float* __restrict__ out, int ld,
                        int ncols, int rows_valid, bool add,
                        const bf16* bias = nullptr) {
  constexpr int NTW = Frag<N, MT>::NTW;
  const int lane = threadIdx.x & 31;
  const int wm = Frag<N, MT>::row0(), nb0 = Frag<N, MT>::col0();
  if (nb0 >= N) return;
  float prev[NTW][MT][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + mt * 16 + frag_row(lane, e);
        const int c = nb0 + j * 8 + frag_col(lane, e);
        prev[j][mt][e] = (add && c < ncols && r < rows_valid
                              ? out[(size_t)r * ld + c]
                              : 0.0f) +
                         (bias != nullptr ? __bfloat162float(bias[c]) : 0.0f);
      }
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + mt * 16 + frag_row(lane, e);
        const int c = nb0 + j * 8 + frag_col(lane, e);
        if (c < ncols && r < rows_valid)
          out[(size_t)r * ld + c] = prev[j][mt][e] + acc.c[mt][j][e];
      }
}

// src (global f32, the block's first row, row stride c_src) -> a bf16 tile
// of COLS columns in shared memory (row stride ld), zero past c_src
// columns and rows_valid rows.
template <int COLS, int THREADS>
__device__ void load_tile(const float* __restrict__ src, int c_src,
                          int rows_valid, bf16* dst, int ld) {
  constexpr int PER_THREAD = RBM * COLS / THREADS;
  float v[PER_THREAD];
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / COLS, c = e % COLS;
    v[i] = r < rows_valid && c < c_src ? src[(size_t)r * c_src + c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int e = threadIdx.x + i * THREADS;
    dst[(e / COLS) * ld + e % COLS] = __float2bfloat16(v[i]);
  }
}

// The block's RBM x COLS bf16 tile from shared memory (row stride lds) to
// the workspace (row stride COLS), as one bulk copy per row that the copy
// engine runs while the block goes on. Every thread calls it after the
// barrier that follows the tile's writes, each having fenced its own
// writes (fence_async); `run` waits for the copies before the tile can
// change again.
template <int COLS>
__device__ void store_tile(const bf16* src, int lds, bf16* __restrict__ dst) {
  if (threadIdx.x < RBM) {
    bulk_store(dst + (size_t)threadIdx.x * COLS, src + threadIdx.x * lds,
               COLS * sizeof(bf16));
    bulk_commit();
  }
}

// A ring stage holds KS rows of a (K x L) W or L rows of KS columns of an
// (L x K) one.
template <int L, int KS>
__host__ __device__ constexpr int ring_stage() {
  return KS * (L + RPAD) > L * (KS + RPAD) ? KS * (L + RPAD)
                                           : L * (KS + RPAD);
}

// A ring stage of a product that streams W only, never W^T: KS rows of a
// (K x L) weight.
template <int L, int KS>
__host__ __device__ constexpr int w_stage() { return KS * (L + RPAD); }

}  // namespace

// Backward of the fused NeRF MLP, for sm_90a: the row pass.
//
// Replaces nerfies_tpu/ops/fused_mlp.py:432 _nerf_train_bwd (kernel body
// :460), the custom VJP of nerf_mlp_train, with the same rounding points:
// the activations are recomputed from x in bf16 exactly as the forward
// kernel makes them; every cotangent that feeds a product is rounded to
// bf16 (g_alpha, g_rgb, gy, g_bt, the trunk's g_h), ReLU masks compare the
// bf16 activation with 0 in f32, and dx sums the skip layer's and layer
// 0's f32 products in that order. drb is gy in f32.
//
// The Pallas kernel forms every dW = src^T @ g_pre inside its body and
// adds it into one resident f32 block, since its grid runs in order. Here
// this row pass stores each layer's bf16 input activation and bf16
// pre-activation cotangent to a workspace (chunk-local rows), and
// weight_grad.cu forms the dW from it in a fixed order.
//
// Bound on an H100 SXM: 3 x 583,808 multiply-adds per row at the bench
// widths (the recompute, the input cotangents and the dW, 2/3 of them
// here), 1.84 TFLOP at 786,432 rows, and 9,920 bytes per row of workspace
// written here (7.8 GB) and read by weight_grad.cu: 2.3 ms of device
// memory against 1.9 ms of tensor rate, so bytes by a little. In practice
// such a pass is held back by latency and synchronisation long before
// either: weight slices that land between barriers instead of ahead of
// them, epilogues that wait on global memory, register spills.
//
// Design. A block owns RBM = 128 rows, so each weight byte streamed from
// L2 serves 128 rows. Each warp computes 64 rows (8 warps, at width 256)
// or 32 rows (16 warps, below) and a quarter of the columns of every
// product, as mma.sync.m16n8k16 bf16 tiles with f32 accumulators in
// registers, fed by ldmatrix, with no spills. Weight slices of KS rows (32
// at width 256, 64 below) flow through a ring of 3 cp.async stages, one
// barrier per slice. A product sums up to three terms (A_i @ B_i, as the
// skip layer and the head cotangents need) in one slice stream; where the
// registers allow (16 warps), its first slices are issued before the
// previous product's epilogue, so that they land while it runs. Weights
// stay in Flax's (in, out) layout: a product with W stages row slices and
// reads B fragments with ldmatrix.trans; a product with W^T (the
// cotangents) stages column slices and reads them with plain ldmatrix, so
// no transposed copy exists.
//
// Shared memory (227 KB at width 256, with the layers' biases where they
// fit): the encoding tile, two activation buffers b0 / b1 of max(W, RW)
// columns, the bf16 head cotangents and the ring. Each product's
// accumulators are complete before its epilogue, so epilogues write in
// place after the product's closing barrier: the trunk recompute runs in
// b0; the backward keeps the running cotangent in b1, while b0 receives,
// beside the weight slices, the activation tile whose ReLU mask the next
// epilogue needs. Each finished tile goes to the workspace as bulk copies
// (one per row) that the copy engine runs while the block goes on.

#include "mma_pipe.cuh"

namespace {

constexpr int RBM = 128;        // rows per block
// A warp owns MT m16 tiles of rows (MT * 16 rows) and a quarter of the
// columns of every product: MT = 4, 8 warps, at width 256, where a
// thread's 128 accumulators leave no room for a second warp's worth of
// state; MT = 2, 16 warps, below, for twice the warps to hide latency.
template <int W>
__host__ __device__ constexpr int mtiles() { return W > 128 ? 4 : 2; }

__host__ __device__ constexpr int threads_for(int mt) {
  return RBM / (mt * 16) * 4 * 32;
}
constexpr int RPAD = 8;         // shared row padding (bf16 elements)
constexpr int CPAD = 64;        // input columns, zero-padded
constexpr int LDX = CPAD + RPAD;
constexpr int HEAD = 16;        // head columns, zero-padded
constexpr int LDG = HEAD + RPAD;
constexpr int OUT_COLS = 8;     // head columns of g_alpha and g_rgb
constexpr int MAXD = 16;        // most trunk layers

enum { HAS_BOTTLENECK = 1, ALPHA_FROM_BT = 2, RGB_FROM_BT = 4 };

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
// rows (k) of a weight slice.
template <int KS_, int STAGES_, int STAGE_>
struct Pipe {
  static constexpr int KS = KS_;
  static constexpr int STAGES = STAGES_;
  static constexpr int STAGE = STAGE_;
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
// read by any thread, and this block's bulk stores are complete.
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
  bulk_wait();
  fence_async_all();
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
// (add ? out[r, c] : 0) + acc, for the valid rows and the first ncols
// columns. The same thread writes and later re-reads each element.
template <int N, int MT>
__device__ void epi_f32(const Frag<N, MT>& acc, float* __restrict__ out, int ld,
                        int ncols, int rows_valid, bool add) {
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
        prev[j][mt][e] = add && c < ncols && r < rows_valid
                             ? out[(size_t)r * ld + c]
                             : 0.0f;
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

struct NerfBwdArgs {
  const float* x;          // (n, c_in)
  const bf16* row_bias;    // (n, RW) or null
  const float* g_alpha;    // (n, OUT_COLS)
  const float* g_rgb;      // (n, OUT_COLS)
  float* dx;               // (n, c_in)
  float* drb;              // (n, RW) or null
  const bf16* w[MAXD];     // layer 0: (CPAD, W); others (W, W)
  const bf16* wx[MAXD];    // skip layers: (CPAD, W)
  const bf16* b[MAXD];
  const bf16* bot_w;       // (W, W)
  const bf16* bot_b;
  const bf16* al_w;        // (W, HEAD)
  const bf16* rh_w;        // (W, RW)
  const bf16* rh_b;
  const bf16* rl_w;        // (RW, HEAD)
  // Workspace, chunk-local rows (a multiple of RBM); each row stride is
  // its width.
  bf16* ws_x;              // (R, CPAD)
  bf16* ws_h[MAXD];        // (R, W)
  bf16* ws_bt;             // (R, W), with a bottleneck
  bf16* ws_y;              // (R, RW)
  bf16* ws_gp[MAXD];       // (R, W)
  bf16* ws_gbt;            // (R, W), with a bottleneck
  bf16* ws_gy;             // (R, RW)
  bf16* ws_ga;             // (R, HEAD)
  bf16* ws_gr;             // (R, HEAD)
  int row0, rows, c_in, depth, skip_mask, flags;
  int bias_in_smem;        // the biases fit beside the tiles (see below)
};

// Widest product: the activation buffers' columns and the ring's size.
template <int W, int RW>
__host__ __device__ constexpr int bwd_cols() {
  return W > RW ? (W > CPAD ? W : CPAD) : (RW > CPAD ? RW : CPAD);
}

// A ring stage holds KS rows of a (K x L) W or L rows of KS columns of an
// (L x K) one.
template <int L, int KS>
__host__ __device__ constexpr int ring_stage() {
  return KS * (L + RPAD) > L * (KS + RPAD) ? KS * (L + RPAD)
                                           : L * (KS + RPAD);
}

template <int W, int RW, int KS, int STAGES>
constexpr size_t bwd_smem_bytes() {
  constexpr int L = bwd_cols<W, RW>();
  return sizeof(bf16) * (RBM * LDX + 2 * RBM * (L + RPAD) + 2 * RBM * LDG +
                         STAGES * ring_stage<L, KS>());
}

// The biases' copy in shared memory, after the tiles and the ring: each
// trunk layer's, the bottleneck's and the rgb hidden layer's.
__host__ __device__ constexpr int bias_elems(int depth, int w, int rw) {
  return (depth + 1) * w + rw;
}

template <int W, int RW, int KS, int STAGES>
__global__ void __launch_bounds__(threads_for(mtiles<W>()), 1)
    nerf_bwd_rows_kernel(const __grid_constant__ NerfBwdArgs a) {
  constexpr int MT = mtiles<W>();
  constexpr int THREADS = threads_for(MT);
  // Where the registers allow (MT = 2), a product's first slices are
  // issued before the previous product's epilogue, to land while it runs;
  // at MT = 4 after it, with the accumulators no longer live.
  constexpr bool EARLY = MT == 2;
  constexpr int L = bwd_cols<W, RW>();
  constexpr int LDB = L + RPAD;
  using P = Pipe<KS, STAGES, ring_stage<L, KS>()>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* b0 = xs + RBM * LDX;
  bf16* b1 = b0 + RBM * LDB;
  bf16* gr_s = b1 + RBM * LDB;
  bf16* ga_s = gr_s + RBM * LDG;
  bf16* ring = ga_s + RBM * LDG;
  bf16* bias_s = ring + STAGES * P::STAGE;

  const size_t lr = (size_t)blockIdx.x * RBM;  // chunk-local first row
  const int grow = a.row0 + (int)lr;           // global first row
  const int rows_valid = min(RBM, a.row0 + a.rows - grow);
  const bool has_bt = a.flags & HAS_BOTTLENECK;
  const bool alpha_bt = a.flags & ALPHA_FROM_BT;
  const bool rgb_bt = a.flags & RGB_FROM_BT;
  const int depth = a.depth, last = depth - 1;
  auto skip = [&](int i) { return i > 0 && ((a.skip_mask >> i) & 1); };

  // The products, as lists of terms (Seg), in the order they run. The
  // forward: trunk layer i (its skip term, if any, second), the bottleneck
  // and the rgb hidden layer y. The backward: gy, g_bt, the last trunk
  // layer's g_h, then per trunk layer i from the last the skip layer's dx
  // term and layer i's g_h (layer 0's dx).
  auto fwd_layer = [&](int i, Seg (&s)[2]) {
    s[0] = i == 0 ? Seg{xs, LDX, CPAD, a.w[0]} : Seg{b0, LDB, W, a.w[i]};
    s[1] = Seg{xs, LDX, skip(i) ? CPAD : 0, a.wx[i]};
  };
  // Each list is made where it is used (from the kernel's parameters), so
  // that none holds registers between its products.
  auto bot_p = [&](Seg (&s)[1]) { s[0] = Seg{b0, LDB, W, a.bot_w}; };
  auto y_p = [&](Seg (&s)[1]) {
    s[0] = Seg{rgb_bt ? b1 : b0, LDB, W, a.rh_w};
  };
  auto gy_p = [&](Seg (&s)[1]) { s[0] = Seg{gr_s, LDG, HEAD, a.rl_w}; };
  auto gbt_p = [&](Seg (&s)[2]) {
    s[0] = Seg{b0, LDB, rgb_bt ? RW : 0, a.rh_w};
    s[1] = Seg{ga_s, LDG, alpha_bt ? HEAD : 0, a.al_w};
  };
  auto gh_p = [&](Seg (&s)[3]) {
    s[0] = Seg{b0, LDB, has_bt && rgb_bt ? 0 : RW, a.rh_w};
    s[1] = Seg{ga_s, LDG, has_bt && alpha_bt ? 0 : HEAD, a.al_w};
    s[2] = Seg{b1, LDB, has_bt ? W : 0, a.bot_w};
  };
  // The backward trunk's products read b1 (layer i's g_pre).
  auto bwd_dx_skip = [&](int i, Seg (&s)[1]) {
    s[0] = Seg{b1, LDB, W, a.wx[i]};
  };
  auto bwd_layer = [&](int i, Seg (&s)[1]) {
    s[0] = Seg{b1, LDB, W, a.w[i]};
  };
  // Begins the first product of backward trunk layer i.
  auto begin_bwd_layer = [&](int i) {
    Seg s[1];
    if (skip(i)) {
      bwd_dx_skip(i, s);
      begin<CPAD, true, P>(s, ring);
    } else {
      bwd_layer(i, s);
      if (i == 0)
        begin<CPAD, true, P>(s, ring);
      else
        begin<W, true, P>(s, ring);
    }
  };

  {
    Seg s[2];
    fwd_layer(0, s);
    begin<W, false, P>(s, ring);
  }
  // The biases, where they fit, as one more cp.async group: the first
  // product's closing wait covers it.
  if (a.bias_in_smem) {
    const int nvec = bias_elems(depth, W, RW) / 8;
    for (int v = threadIdx.x; v < nvec; v += THREADS) {
      const int e = v * 8;
      const bf16* src = e < depth * W ? a.b[e / W] + e % W
                        : e < (depth + 1) * W ? a.bot_b + (e - depth * W)
                                              : a.rh_b + (e - (depth + 1) * W);
      const bool ok = e < depth * W || e >= (depth + 1) * W || has_bt;
      cp_async16(bias_s + e, ok ? src : a.rh_b, ok);
    }
  }
  cp_async_commit();
  auto layer_bias = [&](int i) {
    return a.bias_in_smem ? bias_s + i * W : a.b[i];
  };
  load_tile<CPAD, THREADS>(a.x + (size_t)grow * a.c_in, a.c_in, rows_valid, xs, LDX);
  load_tile<HEAD, THREADS>(a.g_rgb + (size_t)grow * OUT_COLS, OUT_COLS, rows_valid,
                  gr_s, LDG);
  load_tile<HEAD, THREADS>(a.g_alpha + (size_t)grow * OUT_COLS, OUT_COLS, rows_valid,
                  ga_s, LDG);
  fence_async();
  __syncthreads();
  store_tile<CPAD>(xs, LDX, a.ws_x + lr * CPAD);
  store_tile<HEAD>(gr_s, LDG, a.ws_gr + lr * HEAD);
  store_tile<HEAD>(ga_s, LDG, a.ws_ga + lr * HEAD);

  // ---- forward recompute, in place in b0, saving every activation.
  for (int i = 0; i < depth; ++i) {
    Frag<W, MT> acc;
    acc.zero();
    {
      Seg s[2];
      fwd_layer(i, s);
      run<W, false, P>(acc, s, ring);
    }
    then<EARLY>(
        [&] {
          if (i < last) {
            Seg s[2];
            fwd_layer(i + 1, s);
            begin<W, false, P>(s, ring);
          } else if (has_bt) {
            begin_with<W, false, P, 1>(bot_p, ring);
          } else {
            begin_with<RW, false, P, 1>(y_p, ring);
          }
        },
        [&] {
          epi_act<W>(acc, layer_bias(i), nullptr, rows_valid, true, b0,
                     LDB);
        });
    fence_async();
    __syncthreads();
    store_tile<W>(b0, LDB, a.ws_h[i] + lr * W);
  }
  if (has_bt) {
    Frag<W, MT> acc;
    acc.zero();
    run_with<W, false, P, 1>(acc, bot_p, ring);
    then<EARLY>([&] { begin_with<RW, false, P, 1>(y_p, ring); },
                [&] {
                  epi_act<W>(acc,
                             a.bias_in_smem ? bias_s + depth * W : a.bot_b,
                             nullptr, rows_valid, false, b1, LDB);
                });
    fence_async();
    __syncthreads();
    store_tile<W>(b1, LDB, a.ws_bt + lr * W);
  }
  {  // y = relu(bt or h @ rh_w + rh_b + row_bias), into b0
    Frag<RW, MT> acc;
    acc.zero();
    run_with<RW, false, P, 1>(acc, y_p, ring);
    then<EARLY>(
        [&] { begin_with<RW, true, P, 1>(gy_p, ring); },
        [&] {
          epi_act<RW, true>(
              acc, a.bias_in_smem ? bias_s + (depth + 1) * W : a.rh_b,
              a.row_bias != nullptr ? a.row_bias + (size_t)grow * RW
                                    : nullptr,
              rows_valid, true, b0, LDB);
        });
    fence_async();
    __syncthreads();
    store_tile<RW>(b0, LDB, a.ws_y + lr * RW);
  }

  // ---- backward. gy = bf16(g_rgb @ rgb_logit^T), masked by y > 0, in
  // place over y; drb = gy in f32.
  {
    Frag<RW, MT> acc;
    acc.zero();
    run_with<RW, true, P, 1>(acc, gy_p, ring);
    then<EARLY>(
        [&] {
          if (has_bt)
            begin_with<W, true, P, 2>(gbt_p, ring);
          else
            begin_with<W, true, P, 3>(gh_p, ring);
        },
        [&] {
          epi_grad<RW>(acc, b0, LDB, b0, LDB,
                       a.drb != nullptr ? a.drb + (size_t)grow * RW
                                        : nullptr,
                       rows_valid);
        });
    fence_async();
    __syncthreads();
    store_tile<RW>(b0, LDB, a.ws_gy + lr * RW);
  }
  // g_bt, into b1: the head input cotangents routed to the bottleneck.
  if (has_bt) {
    Frag<W, MT> acc;
    acc.zero();
    run_with<W, true, P, 2>(acc, gbt_p, ring);
    then<EARLY>([&] { begin_with<W, true, P, 3>(gh_p, ring); },
                [&] { epi_grad<W>(acc, nullptr, 0, b1, LDB, nullptr,
                                  rows_valid); });
    fence_async();
    __syncthreads();
    store_tile<W>(b1, LDB, a.ws_gbt + lr * W);
  }
  // g_h of the last trunk layer: the rest of the head cotangents plus the
  // bottleneck's input cotangent; masked, it is that layer's g_pre, in b1.
  // With gy consumed (it fed g_bt), b0 receives the mask tile during the
  // product; otherwise the epilogue reads it from the workspace.
  {
    Frag<W, MT> acc;
    acc.zero();
    const bf16* h_last = a.ws_h[last] + lr * W;
    const bool side = has_bt && rgb_bt;
    run_with<W, true, P, 3>(
        acc, gh_p, ring,
        Side<W, LDB>{side ? h_last : nullptr, b0});
    then<EARLY>([&] { begin_bwd_layer(last); },
                [&] {
                  epi_grad<W>(acc, side ? b0 : h_last, side ? LDB : W, b1,
                              LDB, nullptr, rows_valid);
                });
    fence_async();
    __syncthreads();
  }
  // The trunk, last layer first: b1 holds layer i's g_pre, b0 receives
  // layer i - 1's activation for the next mask. dx = (skip products) +
  // (layer-0 product): a product adds to dx where a skip layer above it
  // wrote first. (dx and that flag are made where used, not carried
  // through the loop, for the registers.)
  auto dx = [&] { return a.dx + (size_t)grow * a.c_in; };
  auto dx_written = [&](int i) { return (a.skip_mask >> (i + 1)) != 0; };
  for (int i = last; i >= 0; --i) {
    store_tile<W>(b1, LDB, a.ws_gp[i] + lr * W);
    if (skip(i)) {
      Frag<CPAD, MT> acc;
      acc.zero();
      Seg s[1];
      bwd_dx_skip(i, s);
      run<CPAD, true, P>(acc, s, ring);
      then<EARLY>(
          [&] {
            bwd_layer(i, s);
            begin<W, true, P>(s, ring);
          },
          [&] {
            epi_f32<CPAD>(acc, dx(), a.c_in, a.c_in, rows_valid,
                          dx_written(i));
          });
    }
    Seg s[1];
    bwd_layer(i, s);
    if (i == 0) {
      Frag<CPAD, MT> acc;
      acc.zero();
      run<CPAD, true, P>(acc, s, ring);
      epi_f32<CPAD>(acc, dx(), a.c_in, a.c_in, rows_valid, dx_written(0));
    } else {
      Frag<W, MT> acc;
      acc.zero();
      run<W, true, P>(acc, s, ring,
                      Side<W, LDB>{a.ws_h[i - 1] + lr * W, b0});
      then<EARLY>([&] { begin_bwd_layer(i - 1); },
                  [&] { epi_grad<W>(acc, b0, LDB, b1, LDB, nullptr,
                                    rows_valid); });
      fence_async();
      __syncthreads();
    }
  }
  bulk_wait();
}

// KS and STAGES per width: 32-row slices at width 256, where shared
// memory allows no more; 64-row slices (half the barriers) below.
template <int W, int RW, int KS = (W > 128 ? 32 : 64), int STAGES = 3>
cudaError_t launch_bwd(NerfBwdArgs a, int device, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  size_t smem = bwd_smem_bytes<W, RW, KS, STAGES>();
  const size_t bias_bytes = sizeof(bf16) * bias_elems(a.depth, W, RW);
  a.bias_in_smem = smem + bias_bytes <= (size_t)max_smem;
  if (a.bias_in_smem) smem += bias_bytes;
  err = cudaFuncSetAttribute(nerf_bwd_rows_kernel<W, RW, KS, STAGES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.rows + RBM - 1) / RBM;
  nerf_bwd_rows_kernel<W, RW, KS, STAGES>
      <<<grid, threads_for(mtiles<W>()), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk of rows [row0, row0 + rows) of the NeRF MLP backward's row
// pass; the workspace holds a multiple of 128 chunk-local rows. p (device
// pointers, null where absent): x, row_bias, g_alpha, g_rgb, dx, drb,
// w[MAXD], wx[MAXD], b[MAXD], bot_w, bot_b, al_w, rh_w, rh_b, rl_w,
// ws_x, ws_h[MAXD], ws_bt, ws_y, ws_gp[MAXD], ws_gbt, ws_gy, ws_ga, ws_gr.
// Returns the launch's cudaError_t.
int nerf_mlp_backward_rows(void* const* p, int row0, int rows, int c_in,
                           int depth, int skip_mask, int flags, int width,
                           int rgb_width, int device, void* stream) {
  if (rows <= 0 || c_in < 1 || c_in > CPAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  NerfBwdArgs a = {};
  int k = 0;
  a.x = (const float*)p[k++];
  a.row_bias = (const bf16*)p[k++];
  a.g_alpha = (const float*)p[k++];
  a.g_rgb = (const float*)p[k++];
  a.dx = (float*)p[k++];
  a.drb = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.w[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wx[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.b[i] = (const bf16*)p[k++];
  a.bot_w = (const bf16*)p[k++];
  a.bot_b = (const bf16*)p[k++];
  a.al_w = (const bf16*)p[k++];
  a.rh_w = (const bf16*)p[k++];
  a.rh_b = (const bf16*)p[k++];
  a.rl_w = (const bf16*)p[k++];
  a.ws_x = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_h[i] = (bf16*)p[k++];
  a.ws_bt = (bf16*)p[k++];
  a.ws_y = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_gp[i] = (bf16*)p[k++];
  a.ws_gbt = (bf16*)p[k++];
  a.ws_gy = (bf16*)p[k++];
  a.ws_ga = (bf16*)p[k++];
  a.ws_gr = (bf16*)p[k++];
  a.row0 = row0;
  a.rows = rows;
  a.c_in = c_in;
  a.depth = depth;
  a.skip_mask = skip_mask;
  a.flags = flags;
  cudaStream_t s = (cudaStream_t)stream;
  // The widths of ops/fused_mlp.py _NERF_WIDTHS.
  if (width == 256 && rgb_width == 128)
    return (int)launch_bwd<256, 128>(a, device, s);
  if (width == 128 && rgb_width == 128)
    return (int)launch_bwd<128, 128>(a, device, s);
  if (width == 32 && rgb_width == 128)
    return (int)launch_bwd<32, 128>(a, device, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

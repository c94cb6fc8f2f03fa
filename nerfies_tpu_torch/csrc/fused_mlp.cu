// Fused MLP stacks for serving: the NeRF MLP and the warp trunk, for sm_90a.
//
// Replaces two Pallas kernels of the JAX package:
//   nerf_mlp_kernel   <- nerfies_tpu/ops/fused_mlp.py:78  nerf_mlp_forward
//                        (pallas_call :234)
//   warp_trunk_kernel <- nerfies_tpu/ops/fused_mlp.py:645 warp_trunk_forward
//                        (pallas_call :736)
// with the same numeric contract: bf16 operands, f32 accumulation, bf16
// biases added in f32, per-row biases rounded to bf16 then added in f32,
// ReLU in f32 with the result stored as bf16, f32 head outputs (8 columns
// written).
//
// Bound on an H100 SXM. Per row the NeRF MLP does 583,808 multiply-adds at
// the bench widths (1.17 MFLOP) against a few hundred bytes of encoding,
// row bias and heads: bound by the bf16 tensor rate (989 TFLOP/s dense),
// 1.24 ms at 1,048,576 rows. The warp trunk does 92,672 (0.19 MFLOP)
// against ~700 bytes (the encoding, two 128-wide bf16 row biases, the
// head): its bytes at 3.35 TB/s and its operations take about the same
// time, ~0.2 ms at 1,048,576 rows. Both are held back long before either
// bound by latency (weight slices, epilogues, the row tile's load) and by
// the L2 traffic of streaming every weight once per block of rows.
//
// Design: the product engine of the backward row passes (row_pass.cuh),
// with no stores to a workspace. A block owns RBM = 128 rows from the
// encoding to the heads, so each weight byte streamed from L2 serves 128
// rows: ~9.5 GB of L2 reads per 1,048,576-row NeRF launch (the NeRF
// MLP's weights are 1.16 MB of bf16). Each warp computes MT m16 tiles of
// rows and a quarter of the columns of every product, as mma.sync.m16n8k16
// bf16 tiles with f32 accumulators in registers, fed by ldmatrix, so that
// each B fragment serves MT row tiles. Weight slices of 64 rows flow
// through a ring of cp.async stages with one barrier per slice; a head's
// weight (at most 256 x 16) lands as one slice. A skip layer is one
// product of two terms (the hidden state's, then the encoding's). The
// first layer's slices and the biases are in flight while the block loads
// its encoding tile. Each product's accumulators are complete before its
// epilogue, which writes in place: the trunk runs in one activation
// buffer, the biases are read from shared memory and a row bias as bf16
// pairs, and a head goes to its f32 output straight from the fragments.
// No product waits for stores: the kernels issue none.
//
// Layouts (warps, MT, ring, registers from ptxas, shared memory):
// - NeRF MLP at width 256: 8 warps of MT = 4, one block a SM; 128
//   accumulators a thread (186 registers), so a product's first slices
//   are issued after the previous epilogue. Two activation buffers of 256
//   columns (the heads may read the trunk and the bottleneck) leave room
//   for 2 ring stages: 226 KB at depth 8.
// - NeRF MLP at widths 128 and 32: 16 warps of MT = 2 (at most 87
//   registers), one block a SM, 3 stages; a product's first slices are
//   issued before the previous epilogue, to land while it runs. 140 KB.
// - Warp trunk: 8 warps of MT = 4 (122 registers) and two blocks a SM
//   (107 KB each), so that one block's epilogues, row-bias loads and tile
//   load overlap the other's products; its blocks are short (92,672
//   multiply-adds a row). 3 stages, slices issued before each epilogue.
//
// Built by ops/_build.py into a plain C shared library and called through
// ctypes (ops/fused_mlp.py).

#include "row_pass.cuh"

namespace {

constexpr int KS = 64;  // weight rows per ring slice

// Ring stages: 3, or 2 where the activation buffers are 256 wide and
// shared memory holds no more. 64-row slices in 2 stages ran ~10% faster
// there than 32-row slices in 3 (half the barriers).
template <int L>
__host__ __device__ constexpr int ring_stages() { return L > 128 ? 2 : 3; }

// The warp trunk's layout: 8 warps of MT = 4 and two blocks a SM, so that
// one block's epilogues and waits overlap the other's products.
constexpr int WARP_MT = 4;

// Columns of the activation buffers: the widest product's.
template <int W, int RW>
__host__ __device__ constexpr int fwd_cols() {
  return W > RW ? (W > CPAD ? W : CPAD) : (RW > CPAD ? RW : CPAD);
}

template <int L>
constexpr size_t fwd_smem_bytes(int buffers, int bias_elems) {
  return sizeof(bf16) * (RBM * LDX + buffers * RBM * (L + RPAD) +
                         ring_stages<L>() * w_stage<L, KS>() + bias_elems);
}

// Copies n bf16 (a multiple of 8) from global src to shared dst as
// cp.async vectors of the calling thread's share; src may be null.
__device__ __forceinline__ void copy_bias(bf16* dst, const bf16* src, int n) {
  if (src == nullptr) return;
  for (int v = threadIdx.x; v < n / 8; v += blockDim.x)
    cp_async16(dst + v * 8, src + v * 8, true);
}

enum { HAS_BOTTLENECK = 1, ALPHA_FROM_BT = 2, RGB_FROM_BT = 4,
       HAS_RGB_HIDDEN = 8 };

struct NerfArgs {
  const float* x;          // (n, c_in)
  const bf16* row_bias;    // (n, RW) or null
  float* alpha;            // (n, OUT_COLS)
  float* rgb;              // (n, OUT_COLS)
  const bf16* w[MAXD];     // layer 0: (CPAD, W); others (W, W)
  const bf16* wx[MAXD];    // skip layers: (CPAD, W)
  const bf16* b[MAXD];
  const bf16* bot_w;       // (W, W) or null
  const bf16* bot_b;
  const bf16* al_w;        // (W, HEAD)
  const bf16* al_b;        // (HEAD,)
  const bf16* rh_w;        // (W, RW) or null
  const bf16* rh_b;
  const bf16* rl_w;        // (RW or W, HEAD)
  const bf16* rl_b;        // (HEAD,)
  int n, c_in, depth, skip_mask, flags;
};

// The biases' copy in shared memory, after the ring: each trunk layer's,
// the bottleneck's, the rgb hidden layer's and the two heads'.
__host__ __device__ constexpr int nerf_bias_elems(int depth, int w, int rw) {
  return (depth + 1) * w + rw + 2 * HEAD;
}

template <int W, int RW>
__global__ void __launch_bounds__(threads_for(mtiles<W>()), 1)
    nerf_mlp_kernel(const __grid_constant__ NerfArgs a) {
  constexpr int MT = mtiles<W>();
  constexpr int THREADS = threads_for(MT);
  // At MT = 4 a product's first slices are issued after the previous
  // epilogue, with its 128 accumulators no longer live.
  constexpr bool EARLY = MT == 2;
  constexpr int L = fwd_cols<W, RW>();
  constexpr int LDB = L + RPAD;
  constexpr int STAGES = ring_stages<L>();
  using P = Pipe<KS, STAGES, w_stage<L, KS>(), false>;
  using PH = Pipe<L, STAGES, P::STAGE, false>;  // heads: one slice
  static_assert(L * (HEAD + RPAD) <= P::STAGE, "a head fits in one stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* b0 = xs + RBM * LDX;
  bf16* b1 = b0 + RBM * LDB;
  bf16* ring = b1 + RBM * LDB;
  bf16* bias_s = ring + STAGES * P::STAGE;

  const int row0 = blockIdx.x * RBM;
  const int rows_valid = min(RBM, a.n - row0);
  const bool has_bt = a.flags & HAS_BOTTLENECK;
  const bool has_rh = a.flags & HAS_RGB_HIDDEN;
  const int depth = a.depth;
  const int bot_off = depth * W, rh_off = bot_off + W, al_off = rh_off + RW,
            rl_off = al_off + HEAD;
  // The trunk runs in place in b0; the bottleneck goes to b1.
  bf16* const alpha_src = (a.flags & ALPHA_FROM_BT) ? b1 : b0;
  bf16* const rgb_src = (a.flags & RGB_FROM_BT) ? b1 : b0;
  auto fwd_layer = [&](int i, Seg (&s)[2]) {
    const bool skip = i > 0 && ((a.skip_mask >> i) & 1);
    s[0] = i == 0 ? Seg{xs, LDX, CPAD, a.w[0]} : Seg{b0, LDB, W, a.w[i]};
    s[1] = Seg{xs, LDX, skip ? CPAD : 0, a.wx[i]};
  };
  auto bot_p = [&](Seg (&s)[1]) { s[0] = Seg{b0, LDB, W, a.bot_w}; };
  auto al_p = [&](Seg (&s)[1]) { s[0] = Seg{alpha_src, LDB, W, a.al_w}; };
  auto rh_p = [&](Seg (&s)[1]) { s[0] = Seg{rgb_src, LDB, W, a.rh_w}; };
  // The rgb head reads y, written in place over its source.
  auto rl_p = [&](Seg (&s)[1]) {
    s[0] = Seg{rgb_src, LDB, has_rh ? RW : W, a.rl_w};
  };
  auto begin_rgb = [&] {
    if (has_rh)
      begin_with<RW, false, P, 1>(rh_p, ring);
    else
      begin_with<HEAD, false, PH, 1>(rl_p, ring);
  };

  {
    Seg s[2];
    fwd_layer(0, s);
    begin<W, false, P>(s, ring);
  }
  // The biases as one more cp.async group: the first product's closing
  // wait covers it.
  for (int i = 0; i < depth; ++i) copy_bias(bias_s + i * W, a.b[i], W);
  copy_bias(bias_s + bot_off, a.bot_b, W);
  copy_bias(bias_s + rh_off, a.rh_b, RW);
  copy_bias(bias_s + al_off, a.al_b, HEAD);
  copy_bias(bias_s + rl_off, a.rl_b, HEAD);
  cp_async_commit();
  load_tile<CPAD, THREADS>(a.x + (size_t)row0 * a.c_in, a.c_in, rows_valid,
                           xs, LDX);

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
          if (i < depth - 1) {
            Seg s[2];
            fwd_layer(i + 1, s);
            begin<W, false, P>(s, ring);
          } else if (has_bt) {
            begin_with<W, false, P, 1>(bot_p, ring);
          } else {
            begin_with<HEAD, false, PH, 1>(al_p, ring);
          }
        },
        [&] {
          epi_act<W>(acc, bias_s + i * W, nullptr, rows_valid, true, b0, LDB);
        });
  }
  if (has_bt) {
    Frag<W, MT> acc;
    acc.zero();
    run_with<W, false, P, 1>(acc, bot_p, ring);
    then<EARLY>([&] { begin_with<HEAD, false, PH, 1>(al_p, ring); },
                [&] {
                  epi_act<W>(acc, bias_s + bot_off, nullptr, rows_valid,
                             false, b1, LDB);
                });
  }
  {
    Frag<HEAD, MT> acc;
    acc.zero();
    run_with<HEAD, false, PH, 1>(acc, al_p, ring);
    then<EARLY>(begin_rgb, [&] {
      epi_f32<HEAD>(acc, a.alpha + (size_t)row0 * OUT_COLS, OUT_COLS,
                    OUT_COLS, rows_valid, false, bias_s + al_off);
    });
  }
  if (has_rh) {  // y = relu(src @ rh_w + rh_b + row_bias), over src
    Frag<RW, MT> acc;
    acc.zero();
    run_with<RW, false, P, 1>(acc, rh_p, ring);
    then<EARLY>([&] { begin_with<HEAD, false, PH, 1>(rl_p, ring); },
                [&] {
                  epi_act<RW, true>(
                      acc, bias_s + rh_off,
                      a.row_bias != nullptr
                          ? a.row_bias + (size_t)row0 * RW
                          : nullptr,
                      rows_valid, true, rgb_src, LDB);
                });
  }
  Frag<HEAD, MT> acc;
  acc.zero();
  run_with<HEAD, false, PH, 1>(acc, rl_p, ring);
  epi_f32<HEAD>(acc, a.rgb + (size_t)row0 * OUT_COLS, OUT_COLS, OUT_COLS,
                rows_valid, false, bias_s + rl_off);
}

struct WarpArgs {
  const float* x;          // (n, c_in)
  float* out;              // (n, OUT_COLS)
  const bf16* w[MAXD];     // layer 0: (CPAD, W); others (W, W)
  const bf16* wx[MAXD];    // skip layers: (CPAD, W)
  const bf16* b[MAXD];
  const bf16* head_w;      // (W, HEAD)
  const bf16* head_b;      // (HEAD,)
  const bf16* rb[MAXD];    // (n, W) row biases, or null
  int n, c_in, depth, skip_mask;
};

template <int W>
__global__ void __launch_bounds__(threads_for(WARP_MT), 2)
    warp_trunk_kernel(const __grid_constant__ WarpArgs a) {
  constexpr int MT = WARP_MT;
  constexpr int THREADS = threads_for(MT);
  constexpr bool EARLY = true;  // 122 registers: room for a begin
  constexpr int L = W > CPAD ? W : CPAD;
  constexpr int LDB = L + RPAD;
  constexpr int STAGES = ring_stages<L>();
  using P = Pipe<KS, STAGES, w_stage<L, KS>(), false>;
  using PH = Pipe<L, STAGES, P::STAGE, false>;
  static_assert(L * (HEAD + RPAD) <= P::STAGE, "the head fits in one stage");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* h = xs + RBM * LDX;
  bf16* ring = h + RBM * LDB;
  bf16* bias_s = ring + STAGES * P::STAGE;

  const int row0 = blockIdx.x * RBM;
  const int rows_valid = min(RBM, a.n - row0);
  const int depth = a.depth;
  auto layer = [&](int i, Seg (&s)[2]) {
    const bool skip = i > 0 && ((a.skip_mask >> i) & 1);
    s[0] = i == 0 ? Seg{xs, LDX, CPAD, a.w[0]} : Seg{h, LDB, W, a.w[i]};
    s[1] = Seg{xs, LDX, skip ? CPAD : 0, a.wx[i]};
  };
  auto head_p = [&](Seg (&s)[1]) { s[0] = Seg{h, LDB, W, a.head_w}; };

  {
    Seg s[2];
    layer(0, s);
    begin<W, false, P>(s, ring);
  }
  for (int i = 0; i < depth; ++i) copy_bias(bias_s + i * W, a.b[i], W);
  copy_bias(bias_s + depth * W, a.head_b, HEAD);
  cp_async_commit();
  load_tile<CPAD, THREADS>(a.x + (size_t)row0 * a.c_in, a.c_in, rows_valid,
                           xs, LDX);

  for (int i = 0; i < depth; ++i) {
    Frag<W, MT> acc;
    acc.zero();
    {
      Seg s[2];
      layer(i, s);
      run<W, false, P>(acc, s, ring);
    }
    then<EARLY>(
        [&] {
          if (i < depth - 1) {
            Seg s[2];
            layer(i + 1, s);
            begin<W, false, P>(s, ring);
          } else {
            begin_with<HEAD, false, PH, 1>(head_p, ring);
          }
        },
        [&] {
          const bf16* rb = a.rb[i];
          if (rb != nullptr)
            epi_act<W, true>(acc, bias_s + i * W, rb + (size_t)row0 * W,
                             rows_valid, true, h, LDB);
          else
            epi_act<W>(acc, bias_s + i * W, nullptr, rows_valid, true, h,
                       LDB);
        });
  }
  Frag<HEAD, MT> acc;
  acc.zero();
  run_with<HEAD, false, PH, 1>(acc, head_p, ring);
  epi_f32<HEAD>(acc, a.out + (size_t)row0 * OUT_COLS, OUT_COLS, OUT_COLS,
                rows_valid, false, bias_s + depth * W);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n + RBM - 1) / RBM;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int W, int RW>
cudaError_t launch_nerf(const NerfArgs& a, cudaStream_t stream) {
  constexpr int L = fwd_cols<W, RW>();
  return launch(nerf_mlp_kernel<W, RW>, a, threads_for(mtiles<W>()),
                fwd_smem_bytes<L>(2, nerf_bias_elems(a.depth, W, RW)),
                stream);
}

}  // namespace

extern "C" {

// p: x, row_bias, alpha, rgb, w[MAXD], wx[MAXD], b[MAXD], bot_w, bot_b,
// al_w, al_b, rh_w, rh_b, rl_w, rl_b (device pointers, null where absent).
// Returns the launch's cudaError_t.
int nerf_mlp_forward(void* const* p, int n, int c_in, int depth,
                     int skip_mask, int flags, int width, int rgb_width,
                     int device, void* stream) {
  if (n <= 0 || c_in < 1 || c_in > CPAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  NerfArgs a = {};
  int k = 0;
  a.x = (const float*)p[k++];
  a.row_bias = (const bf16*)p[k++];
  a.alpha = (float*)p[k++];
  a.rgb = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.w[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wx[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.b[i] = (const bf16*)p[k++];
  a.bot_w = (const bf16*)p[k++];
  a.bot_b = (const bf16*)p[k++];
  a.al_w = (const bf16*)p[k++];
  a.al_b = (const bf16*)p[k++];
  a.rh_w = (const bf16*)p[k++];
  a.rh_b = (const bf16*)p[k++];
  a.rl_w = (const bf16*)p[k++];
  a.rl_b = (const bf16*)p[k++];
  a.n = n;
  a.c_in = c_in;
  a.depth = depth;
  a.skip_mask = skip_mask;
  a.flags = flags;
  cudaStream_t s = (cudaStream_t)stream;
  // The widths of ops/fused_mlp.py _NERF_WIDTHS.
  if (width == 256 && rgb_width == 128)
    return (int)launch_nerf<256, 128>(a, s);
  if (width == 128 && rgb_width == 128)
    return (int)launch_nerf<128, 128>(a, s);
  if (width == 32 && rgb_width == 128)
    return (int)launch_nerf<32, 128>(a, s);
  return (int)cudaErrorInvalidValue;
}

// p: x, out, w[MAXD], wx[MAXD], b[MAXD], head_w, head_b, rb[MAXD].
int warp_trunk_forward(void* const* p, int n, int c_in, int depth,
                       int skip_mask, int width, int device, void* stream) {
  if (n <= 0 || c_in < 1 || c_in > CPAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpArgs a = {};
  int k = 0;
  a.x = (const float*)p[k++];
  a.out = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.w[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wx[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.b[i] = (const bf16*)p[k++];
  a.head_w = (const bf16*)p[k++];
  a.head_b = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.rb[i] = (const bf16*)p[k++];
  a.n = n;
  a.c_in = c_in;
  a.depth = depth;
  a.skip_mask = skip_mask;
  if (width == 128) {
    constexpr int L = 128;
    return (int)launch(warp_trunk_kernel<128>, a, threads_for(WARP_MT),
                       fwd_smem_bytes<L>(1, depth * 128 + HEAD),
                       (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

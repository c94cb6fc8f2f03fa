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

#include "row_pass.cuh"

namespace {

enum { HAS_BOTTLENECK = 1, ALPHA_FROM_BT = 2, RGB_FROM_BT = 4 };

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

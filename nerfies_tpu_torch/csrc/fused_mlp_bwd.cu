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
// weight_grad.cu forms the dW from it in a fixed order. A 64-row tile of
// every trunk activation (8 x 256 bf16, 256 KB) does not fit in 227 KB of
// shared memory; the workspace holds them instead, and the backward reads
// each layer's activation back only for its ReLU mask.
//
// Per block (64 rows, 8 warps): the forward recompute as in fused_mlp.cu,
// writing each layer's output to the workspace; then, in shared memory, the
// head cotangents and one running cotangent buffer pair (2 x 64 x 256
// bf16), with each product streaming its transposed weight from L2 in
// 32-row slices. 108 KB of shared memory, two blocks per SM.
//
// Bound on an H100 SXM: 3 x 583,808 multiply-adds per row (the recompute,
// the input cotangents and the dW), so the tensor rate; the workspace adds
// ~10 KB per row written here and read by weight_grad.cu.

#include "mlp_common.cuh"

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
  const bf16* wt[MAXD];    // transposes: layer 0 (W, CPAD); others (W, W)
  const bf16* wxt[MAXD];   // (W, CPAD)
  const bf16* bot_w;
  const bf16* bot_b;
  const bf16* bot_wt;
  const bf16* al_w;        // (W, HEAD)
  const bf16* al_b;
  const bf16* al_wt;       // (HEAD, W)
  const bf16* rh_w;        // (W, RW)
  const bf16* rh_b;
  const bf16* rh_wt;       // (RW, W)
  const bf16* rl_w;        // (RW, HEAD)
  const bf16* rl_b;
  const bf16* rl_wt;       // (HEAD, RW)
  // Workspace, chunk-local rows; each row stride is its width.
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
};

template <int W>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (BM * LDX + 2 * BM * (W + SPAD) + 2 * BM * LDG +
                         BK * (W + SPAD)) +
         sizeof(float) * (NTHREADS / 32) * 256;
}

template <int W, int RW>
__global__ void __launch_bounds__(NTHREADS, 2)
    nerf_bwd_rows_kernel(const __grid_constant__ NerfBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = W + SPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* h0 = xs + BM * LDX;
  bf16* h1 = h0 + BM * LDH;
  bf16* gr_s = h1 + BM * LDH;
  bf16* ga_s = gr_s + BM * LDG;
  bf16* w_s = ga_s + BM * LDG;
  float* scratch = reinterpret_cast<float*>(w_s + BK * LDH);

  const size_t lr = (size_t)blockIdx.x * BM;  // chunk-local first row
  const int grow = a.row0 + (int)lr;          // global first row
  const int rows_valid = min(BM, a.row0 + a.rows - grow);
  const bool has_bt = a.flags & HAS_BOTTLENECK;
  const bool alpha_bt = a.flags & ALPHA_FROM_BT;
  const bool rgb_bt = a.flags & RGB_FROM_BT;
  const int last = a.depth - 1;

  // ---- forward recompute, saving every activation to the workspace.
  load_tile<CPAD>(a.x, a.c_in, grow, rows_valid, xs, LDX, a.ws_x + lr * CPAD);
  const bf16* cur = xs;
  int ldc = LDX, kc = CPAD;
  bf16* h = h0;
  for (int i = 0; i < a.depth; ++i) {
    Acc<W> acc;
    acc.zero();
    accumulate<W>(acc, cur, ldc, kc, a.w[i], w_s);
    if (i > 0 && ((a.skip_mask >> i) & 1))
      accumulate<W>(acc, xs, LDX, CPAD, a.wx[i], w_s);
    h = (i & 1) ? h1 : h0;
    epilogue_bf16<W>(acc, a.b[i], nullptr, rows_valid, true, h, LDH, scratch,
                     a.ws_h[i] + lr * W);
    cur = h;
    ldc = LDH;
    kc = W;
  }
  bf16* other = (h == h0) ? h1 : h0;
  const bf16* bt = h;
  if (has_bt) {
    Acc<W> acc;
    acc.zero();
    accumulate<W>(acc, h, LDH, W, a.bot_w, w_s);
    epilogue_bf16<W>(acc, a.bot_b, nullptr, rows_valid, false, other, LDH,
                     scratch, a.ws_bt + lr * W);
    bt = other;
  }
  {
    const bf16* src = rgb_bt ? bt : h;
    bf16* y = (src == h0) ? h1 : h0;
    Acc<RW> acc;
    acc.zero();
    accumulate<RW>(acc, src, LDH, W, a.rh_w, w_s);
    const bf16* rb =
        a.row_bias != nullptr ? a.row_bias + (size_t)grow * RW : nullptr;
    epilogue_bf16<RW>(acc, a.rh_b, rb, rows_valid, true, y, LDH, scratch,
                      a.ws_y + lr * RW);
  }

  // ---- backward. Head cotangents, rounded to bf16.
  load_tile<HEAD>(a.g_rgb, OUT_COLS, grow, rows_valid, gr_s, LDG,
                  a.ws_gr + lr * HEAD);
  load_tile<HEAD>(a.g_alpha, OUT_COLS, grow, rows_valid, ga_s, LDG,
                  a.ws_ga + lr * HEAD);
  // gy = bf16(g_rgb @ rgb_logit^T), masked by y > 0; drb = gy in f32.
  bf16* gy = h0;
  {
    Acc<RW> acc;
    acc.zero();
    accumulate<RW>(acc, gr_s, LDG, HEAD, a.rl_wt, w_s);
    __syncthreads();
    epilogue_grad<RW>(acc, a.ws_y + lr * RW, gy, LDH, a.ws_gy + lr * RW,
                      a.drb != nullptr ? a.drb + (size_t)grow * RW : nullptr,
                      rows_valid, scratch);
  }
  // g_bt: the head input cotangents routed to the bottleneck.
  bf16* gbt = h1;
  if (has_bt) {
    Acc<W> acc;
    acc.zero();
    if (rgb_bt) accumulate<W>(acc, gy, LDH, RW, a.rh_wt, w_s);
    if (alpha_bt) accumulate<W>(acc, ga_s, LDG, HEAD, a.al_wt, w_s);
    __syncthreads();
    epilogue_grad<W>(acc, nullptr, gbt, LDH, a.ws_gbt + lr * W, nullptr,
                     rows_valid, scratch);
  }
  // g_h of the last trunk layer: the rest of the head cotangents plus the
  // bottleneck's input cotangent; masked, it is that layer's g_pre.
  bf16* p = h0;
  bf16* q = h1;
  {
    Acc<W> acc;
    acc.zero();
    if (!(has_bt && rgb_bt)) accumulate<W>(acc, gy, LDH, RW, a.rh_wt, w_s);
    if (!(has_bt && alpha_bt))
      accumulate<W>(acc, ga_s, LDG, HEAD, a.al_wt, w_s);
    if (has_bt) accumulate<W>(acc, gbt, LDH, W, a.bot_wt, w_s);
    __syncthreads();
    epilogue_grad<W>(acc, a.ws_h[last] + lr * W, p, LDH,
                     a.ws_gp[last] + lr * W, nullptr, rows_valid, scratch);
  }
  // The trunk, last layer first. dx = (skip product) + (layer-0 product).
  float* dx = a.dx + (size_t)grow * a.c_in;
  bool dx_written = false;
  for (int i = last; i >= 0; --i) {
    if (i > 0 && ((a.skip_mask >> i) & 1)) {
      Acc<CPAD> acc;
      acc.zero();
      accumulate<CPAD>(acc, p, LDH, W, a.wxt[i], w_s);
      epilogue_f32<CPAD>(acc, dx, a.c_in, a.c_in, rows_valid, dx_written,
                         scratch);
      dx_written = true;
    }
    if (i == 0) {
      Acc<CPAD> acc;
      acc.zero();
      accumulate<CPAD>(acc, p, LDH, W, a.wt[0], w_s);
      epilogue_f32<CPAD>(acc, dx, a.c_in, a.c_in, rows_valid, dx_written,
                         scratch);
    } else {
      Acc<W> acc;
      acc.zero();
      accumulate<W>(acc, p, LDH, W, a.wt[i], w_s);
      __syncthreads();
      epilogue_grad<W>(acc, a.ws_h[i - 1] + lr * W, q, LDH,
                       a.ws_gp[i - 1] + lr * W, nullptr, rows_valid, scratch);
      bf16* t = p;
      p = q;
      q = t;
    }
  }
}

}  // namespace

extern "C" {

// One chunk of rows [row0, row0 + rows) of the NeRF MLP backward's row
// pass. p (device pointers, null where absent): x, row_bias, g_alpha,
// g_rgb, dx, drb, w[MAXD], wx[MAXD], b[MAXD], wt[MAXD], wxt[MAXD], bot_w,
// bot_b, bot_wt, al_w, al_b, al_wt, rh_w, rh_b, rh_wt, rl_w, rl_b, rl_wt,
// ws_x, ws_h[MAXD], ws_bt, ws_y, ws_gp[MAXD], ws_gbt, ws_gy, ws_ga, ws_gr.
// Returns the launch's cudaError_t.
int nerf_mlp_backward_rows(void* const* p, int row0, int rows, int c_in,
                           int depth, int skip_mask, int flags, int width,
                           int rgb_width, int device, void* stream) {
  if (rows <= 0 || c_in > CPAD || depth < 1 || depth > MAXD)
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
  for (int i = 0; i < MAXD; ++i) a.wt[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wxt[i] = (const bf16*)p[k++];
  a.bot_w = (const bf16*)p[k++];
  a.bot_b = (const bf16*)p[k++];
  a.bot_wt = (const bf16*)p[k++];
  a.al_w = (const bf16*)p[k++];
  a.al_b = (const bf16*)p[k++];
  a.al_wt = (const bf16*)p[k++];
  a.rh_w = (const bf16*)p[k++];
  a.rh_b = (const bf16*)p[k++];
  a.rh_wt = (const bf16*)p[k++];
  a.rl_w = (const bf16*)p[k++];
  a.rl_b = (const bf16*)p[k++];
  a.rl_wt = (const bf16*)p[k++];
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
  if (width == 256 && rgb_width == 128)
    return (int)launch_rows(nerf_bwd_rows_kernel<256, 128>, a, rows,
                            bwd_smem_bytes<256>(), (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// The warp trunk of training, for sm_90a: primal and tangent chains.
//
// Replaces two Pallas kernels of the JAX package:
//   warp_fwd_kernel       <- nerfies_tpu/ops/fused_warp.py:147 _warp_fwd
//                            (kernel body :168)
//   warp_bwd_rows_kernel  <- nerfies_tpu/ops/fused_warp.py:207 _warp_bwd
//                            (kernel body :237), with weight_grad.cu
// with the same rounding points: bf16 operands (x, the metadata embedding,
// the tangents, every activation and every cotangent that feeds a
// product), f32 sums, the bias added in f32, the ReLU mask taken from the
// primal's f32 pre-activation in the forward and from its bf16 activation
// in the backward (as each Pallas kernel does), f32 head outputs.
//
// The trunk (6 x 128 with a skip at 4 on the bench model) reads the
// encoding at layer 0 and at each skip, and the metadata embedding (F = 8
// columns, padded to 16 for the MMA's k) at the same layers, as a product
// with its own weight rows. 0 or 3 tangent chains (d pe / d x_j) run beside
// the primal: they take the same weight products without bias and the
// primal's ReLU mask, and their heads give the Jacobian columns.
//
// Design. One block of 8 warps owns 64 rows of every chain. The chains
// share each streamed weight slice and each B fragment (accumulate_chains
// in mlp_common.cuh), so a 4-chain layer costs one weight stream and four
// times the MMAs. Each chain keeps one activation buffer in shared memory,
// overwritten in place after a barrier. The mask travels from the primal's
// epilogue to the tangents' as 8 bits per lane: a lane handles the same 8
// elements of every chain's 16 x 16 tile.
//
// The backward's row pass recomputes the forward, saving every chain's
// activations to a chunk-local workspace (chains stacked, chain c at rows
// c * R), then backpropagates all chains through the transposed weights,
// writing d_embed, dx and d_tangents (when asked for) and each layer's
// bf16 g_pre to the workspace; weight_grad.cu forms the dW from it, one
// job per weight summing the chains (the embedding rows and the biases
// see the primal chain only).
//
// Bound on an H100 SXM: per row and chain, 92,672 multiply-adds forward
// and 3x that backward (recompute, input cotangents, dW); the tensor rate,
// against a few hundred bytes per row of inputs and outputs.

#include "mlp_common.cuh"

namespace {

constexpr int MAXT = 3;  // most tangent chains

struct WarpFwdArgs {
  const float* x;          // (n, c_in)
  const float* e;          // (n, f)
  const float* t[MAXT];    // (n, c_in)
  float* out;              // (n, OUT_COLS)
  float* jout[MAXT];       // (n, OUT_COLS)
  const bf16* w[MAXD];     // layer 0: (CPAD, W); others (W, W)
  const bf16* wx[MAXD];    // skip layers: (CPAD, W)
  const bf16* we[MAXD];    // layer 0 and skip layers: (HEAD, W)
  const bf16* b[MAXD];
  const bf16* head_w;      // (W, HEAD)
  const bf16* head_b;      // (HEAD,)
  int n, c_in, f, depth, skip_mask;
};

struct WarpBwdArgs {
  WarpFwdArgs fwd;         // inputs and weights; out/jout unused
  const float* g_out;      // (n, OUT_COLS)
  const float* g_jout[MAXT];
  float* d_embed;          // (n, f)
  float* dx;               // (n, c_in) or null
  float* dt[MAXT];         // (n, c_in) or null
  const bf16* wt[MAXD];    // transposes: layer 0 (W, CPAD); others (W, W)
  const bf16* wxt[MAXD];   // (W, CPAD)
  const bf16* wet[MAXD];   // (W, HEAD)
  const bf16* head_wt;     // (HEAD, W)
  // Workspace, chunk-local rows, chains stacked (chain c at rows c * R).
  bf16* ws_in;             // (C * R, CPAD): x, then each tangent
  bf16* ws_e;              // (R, HEAD)
  bf16* ws_h[MAXD];        // (C * R, W)
  bf16* ws_gh;             // (C * R, HEAD): g_out, then each g_jout
  bf16* ws_gp[MAXD];       // (C * R, W)
  int row0, rows, rows_alloc;
};

template <int W, int C, bool BWD>
constexpr size_t warp_smem_bytes() {
  return sizeof(bf16) * (C * BM * LDX + BM * LDG + C * BM * (W + SPAD) +
                         (BWD ? C * BM * LDG : 0) + BK * (W + SPAD)) +
         sizeof(float) * (NTHREADS / 32) * 256;
}

// act[c] = chain c's activation: the primal's ReLU of (acc + bias) and the
// tangents' acc under the primal's f32 mask, each rounded to bf16, to
// shared memory (row stride ldo) and, if ws[0] is not null, to the
// workspace (row stride N).
template <int N, int C>
__device__ void epilogue_chains(Acc<N> (&acc)[C], const bf16* __restrict__ bias,
                                bf16* const (&out)[C], int ldo,
                                bf16* const (&ws)[C], float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, cg = warp >> 2;
  float* s = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < Acc<N>::PER_WARP; ++j) {
    const int t = cg + 2 * j;
    if (t >= Acc<N>::TILES) continue;
    unsigned bits = 0;
    wmma::store_matrix_sync(s, acc[0].f[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int e = lane + 32 * k;
      const int r = rg * 16 + (e >> 4), c = t * 16 + (e & 15);
      const float v = s[e] + __bfloat162float(bias[c]);
      const bool on = v > 0.0f;
      bits |= (unsigned)on << k;
      const bf16 h = __float2bfloat16(on ? v : 0.0f);
      out[0][r * ldo + c] = h;
      if (ws[0] != nullptr) ws[0][(size_t)r * N + c] = h;
    }
    __syncwarp();
#pragma unroll
    for (int ch = 1; ch < C; ++ch) {
      wmma::store_matrix_sync(s, acc[ch].f[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = lane + 32 * k;
        const int r = rg * 16 + (e >> 4), c = t * 16 + (e & 15);
        const bf16 h = __float2bfloat16(((bits >> k) & 1) ? s[e] : 0.0f);
        out[ch][r * ldo + c] = h;
        if (ws[ch] != nullptr) ws[ch][(size_t)r * N + c] = h;
      }
      __syncwarp();
    }
  }
}

// The forward over one block's rows of all C chains; the last layer's
// activations stay in hs[c]. ws_h (null in the forward kernel) receives
// every layer's activations, chain c at rows c * rows_alloc.
template <int W, int C>
__device__ void warp_forward_tile(const WarpFwdArgs& a, bf16* const (&in)[C],
                                  const bf16* es, bf16* const (&hs)[C],
                                  bf16* w_s, float* scratch,
                                  bf16* const* ws_h, size_t lr,
                                  size_t rows_alloc) {
  const bf16* in_c[C];
  const bf16* h_c[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    in_c[c] = in[c];
    h_c[c] = hs[c];
  }
  for (int i = 0; i < a.depth; ++i) {
    Acc<W> acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c].zero();
    if (i == 0) {
      accumulate_chains<W, C>(acc, in_c, LDX, CPAD, a.w[0], w_s);
      accumulate<W>(acc[0], es, LDG, HEAD, a.we[0], w_s);
    } else {
      accumulate_chains<W, C>(acc, h_c, W + SPAD, W, a.w[i], w_s);
      if ((a.skip_mask >> i) & 1) {
        accumulate_chains<W, C>(acc, in_c, LDX, CPAD, a.wx[i], w_s);
        accumulate<W>(acc[0], es, LDG, HEAD, a.we[i], w_s);
      }
    }
    __syncthreads();  // every chain's reads of hs are done
    bf16* ws[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      ws[c] = ws_h != nullptr ? ws_h[i] + ((size_t)c * rows_alloc + lr) * W
                              : nullptr;
    epilogue_chains<W, C>(acc, a.b[i], hs, W + SPAD, ws, scratch);
  }
}

template <int W, int NT>
__global__ void __launch_bounds__(NTHREADS, 1)
    warp_fwd_kernel(const __grid_constant__ WarpFwdArgs a) {
  constexpr int C = NT + 1;
  constexpr int LDH = W + SPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* in[C];
  bf16* hs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) in[c] = base + c * BM * LDX;
  bf16* es = base + C * BM * LDX;
#pragma unroll
  for (int c = 0; c < C; ++c) hs[c] = es + BM * LDG + c * BM * LDH;
  bf16* w_s = es + BM * LDG + C * BM * LDH;
  float* scratch = reinterpret_cast<float*>(w_s + BK * LDH);

  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, a.n - row0);
  load_tile<CPAD>(a.x, a.c_in, row0, rows_valid, in[0], LDX, nullptr);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    load_tile<CPAD>(a.t[j], a.c_in, row0, rows_valid, in[1 + j], LDX,
                    nullptr);
  load_tile<HEAD>(a.e, a.f, row0, rows_valid, es, LDG, nullptr);
  warp_forward_tile<W, C>(a, in, es, hs, w_s, scratch, nullptr, 0, 0);

  Acc<HEAD> acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c].zero();
  const bf16* h_c[C];
#pragma unroll
  for (int c = 0; c < C; ++c) h_c[c] = hs[c];
  accumulate_chains<HEAD, C>(acc, h_c, LDH, W, a.head_w, w_s);
  epilogue_head(acc[0], a.head_b, rows_valid,
                a.out + (size_t)row0 * OUT_COLS, scratch);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    epilogue_head(acc[1 + j], nullptr, rows_valid,
                  a.jout[j] + (size_t)row0 * OUT_COLS, scratch);
}

template <int W, int NT, bool NEED_DX>
__global__ void __launch_bounds__(NTHREADS, 1)
    warp_bwd_rows_kernel(const __grid_constant__ WarpBwdArgs a) {
  constexpr int C = NT + 1;
  constexpr int LDH = W + SPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  const WarpFwdArgs& f = a.fwd;
  bf16* base = reinterpret_cast<bf16*>(smem);
  bf16* in[C];
  bf16* hs[C];
  bf16* gs[C];
#pragma unroll
  for (int c = 0; c < C; ++c) in[c] = base + c * BM * LDX;
  bf16* es = base + C * BM * LDX;
#pragma unroll
  for (int c = 0; c < C; ++c) hs[c] = es + BM * LDG + c * BM * LDH;
#pragma unroll
  for (int c = 0; c < C; ++c) gs[c] = es + BM * LDG + C * BM * LDH + c * BM * LDG;
  bf16* w_s = es + BM * LDG + C * BM * LDH + C * BM * LDG;
  float* scratch = reinterpret_cast<float*>(w_s + BK * LDH);

  const size_t lr = (size_t)blockIdx.x * BM;
  const size_t R = a.rows_alloc;
  const int grow = a.row0 + (int)lr;
  const int rows_valid = min(BM, a.row0 + a.rows - grow);
  const int last = f.depth - 1;

  // ---- forward recompute, every chain's activations to the workspace.
  load_tile<CPAD>(f.x, f.c_in, grow, rows_valid, in[0], LDX,
                  a.ws_in + lr * CPAD);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    load_tile<CPAD>(f.t[j], f.c_in, grow, rows_valid, in[1 + j], LDX,
                    a.ws_in + ((1 + j) * R + lr) * CPAD);
  load_tile<HEAD>(f.e, f.f, grow, rows_valid, es, LDG, a.ws_e + lr * HEAD);
  warp_forward_tile<W, C>(f, in, es, hs, w_s, scratch, a.ws_h, lr, R);

  // ---- backward. Head cotangents, rounded to bf16.
  load_tile<HEAD>(a.g_out, OUT_COLS, grow, rows_valid, gs[0], LDG,
                  a.ws_gh + lr * HEAD);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    load_tile<HEAD>(a.g_jout[j], OUT_COLS, grow, rows_valid, gs[1 + j], LDG,
                    a.ws_gh + ((1 + j) * R + lr) * HEAD);
  const bf16* mask = a.ws_h[last] + lr * W;  // the primal's, for all chains
  {
    Acc<W> acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c].zero();
    const bf16* g_c[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g_c[c] = gs[c];
    accumulate_chains<W, C>(acc, g_c, LDG, HEAD, a.head_wt, w_s);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c)
      epilogue_grad<W>(acc[c], mask, hs[c], LDH,
                       a.ws_gp[last] + (c * R + lr) * W, nullptr, rows_valid,
                       scratch);
  }
  // The trunk, last layer first; hs[c] holds chain c's g_pre. d_embed and
  // dx / d_tangents sum the skip layers' and layer 0's f32 products.
  const bf16* p_c[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p_c[c] = hs[c];
  float* d_embed = a.d_embed + (size_t)grow * f.f;
  bool written = false;
  for (int i = last; i >= 0; --i) {
    const bool skip = i > 0 && ((f.skip_mask >> i) & 1);
    if (skip || i == 0) {
      {
        Acc<HEAD> acc;
        acc.zero();
        accumulate<HEAD>(acc, hs[0], LDH, W, a.wet[i], w_s);
        epilogue_f32<HEAD>(acc, d_embed, f.f, f.f, rows_valid, written,
                           scratch);
      }
      if (NEED_DX) {
        Acc<CPAD> acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c].zero();
        accumulate_chains<CPAD, C>(acc, p_c, LDH, W,
                                   i == 0 ? a.wt[0] : a.wxt[i], w_s);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float* d = (c == 0 ? a.dx : a.dt[c - 1]) + (size_t)grow * f.c_in;
          epilogue_f32<CPAD>(acc[c], d, f.c_in, f.c_in, rows_valid, written,
                             scratch);
        }
      }
      written = true;
    }
    if (i > 0) {
      Acc<W> acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c].zero();
      accumulate_chains<W, C>(acc, p_c, LDH, W, a.wt[i], w_s);
      __syncthreads();
      const bf16* m = a.ws_h[i - 1] + lr * W;
#pragma unroll
      for (int c = 0; c < C; ++c)
        epilogue_grad<W>(acc[c], m, hs[c], LDH,
                         a.ws_gp[i - 1] + (c * R + lr) * W, nullptr,
                         rows_valid, scratch);
    }
  }
}

void read_fwd_args(WarpFwdArgs& a, void* const* p, int& k) {
  a.x = (const float*)p[k++];
  a.e = (const float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.t[j] = (const float*)p[k++];
  a.out = (float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.jout[j] = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.w[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wx[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.we[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.b[i] = (const bf16*)p[k++];
  a.head_w = (const bf16*)p[k++];
  a.head_b = (const bf16*)p[k++];
}

}  // namespace

extern "C" {

// p (device pointers, null where absent): x, e, t[3], out, jout[3],
// w[MAXD], wx[MAXD], we[MAXD], b[MAXD], head_w, head_b.
int warp_train_forward(void* const* p, int n, int c_in, int f, int depth,
                       int skip_mask, int nt, int width, int device,
                       void* stream) {
  if (n <= 0 || c_in > CPAD || f > HEAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpFwdArgs a = {};
  int k = 0;
  read_fwd_args(a, p, k);
  a.n = n;
  a.c_in = c_in;
  a.f = f;
  a.depth = depth;
  a.skip_mask = skip_mask;
  cudaStream_t s = (cudaStream_t)stream;
  if (width == 128 && nt == 0)
    return (int)launch_rows(warp_fwd_kernel<128, 0>, a, n,
                            warp_smem_bytes<128, 1, false>(), s);
  if (width == 128 && nt == 3)
    return (int)launch_rows(warp_fwd_kernel<128, 3>, a, n,
                            warp_smem_bytes<128, 4, false>(), s);
  return (int)cudaErrorInvalidValue;
}

// One chunk of rows [row0, row0 + rows) of the warp backward's row pass;
// the workspace holds rows_alloc rows per chain. p: the forward's list
// (out and jout null), then g_out, g_jout[3], d_embed, dx, dt[3],
// wt[MAXD], wxt[MAXD], wet[MAXD], head_wt, ws_in, ws_e, ws_h[MAXD], ws_gh,
// ws_gp[MAXD].
int warp_train_backward_rows(void* const* p, int n, int row0, int rows,
                             int rows_alloc, int c_in, int f, int depth,
                             int skip_mask, int nt, int need_dx, int width,
                             int device, void* stream) {
  if (rows <= 0 || row0 + rows > n || rows > rows_alloc || c_in > CPAD ||
      f > HEAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpBwdArgs a = {};
  int k = 0;
  read_fwd_args(a.fwd, p, k);
  a.fwd.n = n;
  a.fwd.c_in = c_in;
  a.fwd.f = f;
  a.fwd.depth = depth;
  a.fwd.skip_mask = skip_mask;
  a.g_out = (const float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.g_jout[j] = (const float*)p[k++];
  a.d_embed = (float*)p[k++];
  a.dx = (float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.dt[j] = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wt[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wxt[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wet[i] = (const bf16*)p[k++];
  a.head_wt = (const bf16*)p[k++];
  a.ws_in = (bf16*)p[k++];
  a.ws_e = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_h[i] = (bf16*)p[k++];
  a.ws_gh = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_gp[i] = (bf16*)p[k++];
  a.row0 = row0;
  a.rows = rows;
  a.rows_alloc = rows_alloc;
  cudaStream_t s = (cudaStream_t)stream;
  if (width != 128) return (int)cudaErrorInvalidValue;
  constexpr size_t s1 = warp_smem_bytes<128, 1, true>();
  constexpr size_t s4 = warp_smem_bytes<128, 4, true>();
  if (nt == 0 && !need_dx)
    return (int)launch_rows(warp_bwd_rows_kernel<128, 0, false>, a, rows, s1, s);
  if (nt == 0 && need_dx)
    return (int)launch_rows(warp_bwd_rows_kernel<128, 0, true>, a, rows, s1, s);
  if (nt == 3 && !need_dx)
    return (int)launch_rows(warp_bwd_rows_kernel<128, 3, false>, a, rows, s4, s);
  if (nt == 3 && need_dx)
    return (int)launch_rows(warp_bwd_rows_kernel<128, 3, true>, a, rows, s4, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Backward of the warp trunk of training, for sm_90a: the row pass.
//
// Replaces nerfies_tpu/ops/fused_warp.py:207 _warp_bwd (kernel body :237),
// the custom VJP of warp_mlp_train, together with weight_grad.cu, with the
// rounding points of fused_warp.cu's forward: bf16 operands (x, the
// metadata embedding, the tangents, every activation and every cotangent
// that feeds a product), f32 sums, the bias added in f32; the recompute's
// ReLU mask taken from the primal's f32 pre-activation and the backward's
// from its bf16 activation, as each Pallas kernel does. The tangent chains
// (d pe / d x_j) take the primal's mask and no bias; the embedding rows
// and the biases see the primal chain only; d_embed, dx and d_tangents
// sum the skip layers' and layer 0's f32 products, the last layer first.
// The elastic loss differentiates through the Jacobian, so the tangent
// chains' backward is exact, not an approximation.
//
// The Pallas kernel forms every dW inside its body. Here this row pass
// recomputes the forward, stores each chain's bf16 layer inputs and
// pre-activation cotangents to a chunk-local workspace (chain c at rows
// c * R), and writes d_embed, dx and d_tangents; weight_grad.cu forms the
// dW from the workspace, one job per weight summing the chains.
//
// Bound on an H100 SXM, at the bench widths (6 x 128, skip 4) with 3
// tangents: 2 x 92,672 multiply-adds per row and chain for the recompute
// and the input cotangents (1.17 TFLOP at 786,432 rows, 1.2 ms at the
// tensor rate) against 12,960 bytes per row of workspace written here and
// about 800 of inputs and outputs (10.8 GB, 3.2 ms of device memory): so
// bytes, and the workspace write above all. With 0 tangents the workspace
// is 3,264 bytes a row.
//
// Design: the NeRF backward's product engine (row_pass.cuh), chains stacked in
// one 128-row tile as in the forward (warp_chains.cuh holds the stacking,
// the loads, the layer terms and the recompute's epilogue for both). A
// block owns RC = 128 / C rows of each of its C chains (C = 1 or 4),
// stacked so that a warp's MT m16 tiles hold the same 16 rows of every
// chain in turn: m-tile mt belongs to chain mt % C. So:
// - each weight slice streamed from L2 serves 128 chain-rows, and a layer
//   of all chains is one product of the engine (mma.sync fed by ldmatrix,
//   a 3-stage cp.async ring of 64-row slices, W and W^T both read from the
//   (in, out) layout, so no transposed copies);
// - one lane holds the same element of every chain, so the primal's mask
//   passes to the tangents in registers, and each thread keeps the
//   backward's masks (its primal elements' bf16 activation > 0, one bit
//   each) in one 32-bit word per layer in shared memory: the backward
//   reads no activation back for its masks, and one activation buffer,
//   overwritten in place after each product's closing barrier, serves the
//   whole pass;
// - the embedding is an ordinary k = 16 term whose A tile is zero in the
//   tangents' rows, and the biases and d_embed touch the primal's m-tiles
//   only;
// - every tile leaves for the workspace as bulk copies, one per row, each
//   to its chain's offset, while the block goes on; nothing reads the
//   workspace back, so a product waits only until the copies have read
//   b0, not until their writes land.
// C = 1 (the fine level, the background): 16 warps of 32 rows (MT = 2), as
// the NeRF row pass at width 128. C = 4 (the coarse level): 8 warps of 64
// stacked rows (MT = 4, one m16 tile per chain), 64 accumulators a thread;
// 16 warps of 2 m-tiles, handing the primal's mask between warps through
// shared memory, ran slower.

#include "warp_chains.cuh"

namespace {

constexpr int WKS = 64;       // weight rows per ring stage
constexpr int WSTAGES = 3;

// m16 tiles of rows per warp: one per chain with tangents, two without.
template <int C>
__host__ __device__ constexpr int warp_mtiles() { return C == 1 ? 2 : C; }

struct WarpBwdArgs {
  const float* x;          // (n, c_in)
  const float* e;          // (n, f)
  const float* t[MAXT];    // (n, c_in)
  const float* g_out;      // (n, OUT_COLS)
  const float* g_jout[MAXT];
  float* d_embed;          // (n, f)
  float* dx;               // (n, c_in) or null
  float* dt[MAXT];         // (n, c_in) or null
  const bf16* w[MAXD];     // layer 0: (CPAD, W); others (W, W)
  const bf16* wx[MAXD];    // skip layers: (CPAD, W)
  const bf16* we[MAXD];    // layer 0 and skip layers: (HEAD, W)
  const bf16* b[MAXD];
  const bf16* head_w;      // (W, HEAD)
  // Workspace, chunk-local rows, chains stacked (chain c at rows c * R).
  bf16* ws_in;             // (C * R, CPAD): x, then each tangent
  bf16* ws_e;              // (R, HEAD)
  bf16* ws_h[MAXD];        // (C * R, W)
  bf16* ws_gh;             // (C * R, HEAD): g_out, then each g_jout
  bf16* ws_gp[MAXD];       // (C * R, W)
  int row0, rows, rows_alloc, c_in, f, depth, skip_mask;
};

// The stacked RBM x COLS tile (shared, row stride lds) to the workspace,
// chain c's local row l at dst + (c * R + l) * COLS (dst: the block's
// first row of chain 0), for the first `chains` chains: one bulk copy per
// row, as store_tile.
template <int COLS, int C, int MT>
__device__ void store_chains(const bf16* src, int lds, bf16* __restrict__ dst,
                             size_t R, int chains) {
  using Ch = Chains<C, MT>;
  const int s = threadIdx.x;
  if (s < RBM && Ch::chain(s) < chains) {
    bulk_store(dst + ((size_t)Ch::chain(s) * R + Ch::local(s)) * COLS,
               src + s * lds, COLS * sizeof(bf16));
    bulk_commit();
  }
}

// A pre-activation cotangent of every chain (out: shared, row stride ldo,
// in place): bf16(acc), zeroed where the primal's mask bit is off.
template <int C, int N, int MT>
__device__ void epi_gpre(const Frag<N, MT>& acc, uint32_t bits, bf16* out,
                         int ldo) {
  constexpr int NTW = Frag<N, MT>::NTW;
  const int lane = threadIdx.x & 31;
  const int wm = Frag<N, MT>::row0(), c0 = Frag<N, MT>::col0() + 2 * (lane & 3);
  const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int p = 0; p < MT / C; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int bit = mask_bit<NTW>(p, j, h);
        const bool on0 = (bits >> bit) & 1, on1 = (bits >> (bit + 1)) & 1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int mt = p * C + c;
          const int r = wm + mt * 16 + (lane >> 2) + 8 * h;
          __nv_bfloat162 v = __floats2bfloat162_rn(acc.c[mt][j][2 * h],
                                                   acc.c[mt][j][2 * h + 1]);
          if (!on0) v.x = zero;
          if (!on1) v.y = zero;
          *reinterpret_cast<__nv_bfloat162*>(out + r * ldo + c0 + j * 8) = v;
        }
      }
}

template <int W, int C>
size_t warp_bwd_smem_bytes(int depth) {
  constexpr int MT = warp_mtiles<C>();
  return sizeof(bf16) * (RBM * LDX + 2 * RBM * LDG + RBM * (W + RPAD) +
                         WSTAGES * ring_stage<W, WKS>() + depth * W) +
         sizeof(uint32_t) * depth * threads_for(MT);
}

template <int W, int C, bool NEED_DX>
__global__ void __launch_bounds__(threads_for(warp_mtiles<C>()), 1)
    warp_bwd_rows_kernel(const __grid_constant__ WarpBwdArgs a) {
  constexpr int MT = warp_mtiles<C>();
  constexpr int THREADS = threads_for(MT);
  using Ch = Chains<C, MT>;
  constexpr int RC = Ch::RC;
  constexpr int LDB = W + RPAD;
  // Nothing reads the workspace back: a product waits only until the bulk
  // stores have read b0, not until they complete.
  using P = Pipe<WKS, WSTAGES, ring_stage<W, WKS>(), false>;
  // A product's first slices are issued before the previous product's
  // epilogue, to land while it runs.
  constexpr bool EARLY = true;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // every chain's input
  bf16* es = xs + RBM * LDX;                 // the primal's embedding
  bf16* gs = es + RBM * LDG;                 // every chain's head cotangent
  bf16* b0 = gs + RBM * LDG;                 // activations, then cotangents
  bf16* ring = b0 + RBM * LDB;
  bf16* bias_s = ring + WSTAGES * P::STAGE;  // depth x W
  uint32_t* masks =                          // depth x THREADS
      reinterpret_cast<uint32_t*>(bias_s + a.depth * W) + threadIdx.x;

  const int lr = blockIdx.x * RC;  // chunk-local first row of each chain
  const int grow = a.row0 + lr;    // global first row
  const int rows_valid = max(0, min(RC, a.rows - lr));
  const size_t R = a.rows_alloc;
  const int depth = a.depth, last = depth - 1;
  auto skip = [&](int i) { return i > 0 && ((a.skip_mask >> i) & 1); };

  // The products, as lists of terms (Seg). The recompute of layer i: its
  // input's term, the encoding's at a skip, the embedding's at layer 0 and
  // at a skip. The backward reads b0 (a layer's g_pre): the head's
  // cotangent product, then per layer from the last d_embed's term at
  // layer 0 and at a skip, dx's (with need_dx), and the layer's g_h.
  auto fwd_layer = [&](int i, Seg (&s)[3]) {
    layer_terms<W>(a, i, xs, es, b0, s);
  };
  auto head_p = [&](Seg (&s)[1]) { s[0] = Seg{gs, LDG, HEAD, a.head_w}; };
  auto embed_p = [&](int i, Seg (&s)[1]) { s[0] = Seg{b0, LDB, W, a.we[i]}; };
  auto dx_p = [&](int i, Seg (&s)[1]) {
    s[0] = Seg{b0, LDB, W, i == 0 ? a.w[0] : a.wx[i]};
  };
  auto layer_p = [&](int i, Seg (&s)[1]) { s[0] = Seg{b0, LDB, W, a.w[i]}; };
  // Begins the product that follows backward product `k` of layer i
  // (0: d_embed's, 1: dx's, 2: g_h's), if any.
  auto begin_after = [&](int i, int k) {
    Seg s[1];
    const bool io = i == 0 || skip(i);
    if (k < 1 && io && NEED_DX) {
      dx_p(i, s);
      begin<CPAD, true, P>(s, ring);
    } else if (k < 2 && i > 0) {
      layer_p(i, s);
      begin<W, true, P>(s, ring);
    } else if (i > 0) {
      const int n = i - 1;
      if (n == 0 || skip(n)) {
        embed_p(n, s);
        begin<HEAD, true, P>(s, ring);
      } else {
        layer_p(n, s);
        begin<W, true, P>(s, ring);
      }
    }
  };

  {
    Seg s[3];
    fwd_layer(0, s);
    begin<W, false, P>(s, ring);
  }
  // The biases as one more cp.async group: the first product's closing
  // wait covers it.
  for (int v = threadIdx.x; v < depth * W / 8; v += THREADS)
    cp_async16(bias_s + v * 8, a.b[v * 8 / W] + v * 8 % W, true);
  cp_async_commit();
  {
    // The primal first, then each tangent; the embedding is the primal's.
    const float* x_src[C] = {a.x + (size_t)grow * a.c_in};
    const float* e_src[C] = {a.e + (size_t)grow * a.f};
    const float* g_src[C] = {a.g_out + (size_t)grow * OUT_COLS};
#pragma unroll
    for (int c = 1; c < C; ++c) {
      x_src[c] = a.t[c - 1] + (size_t)grow * a.c_in;
      g_src[c] = a.g_jout[c - 1] + (size_t)grow * OUT_COLS;
    }
    load_chains<CPAD, THREADS, C, MT>(x_src, a.c_in, rows_valid, xs, LDX);
    load_chains<HEAD, THREADS, C, MT>(e_src, a.f, rows_valid, es, LDG);
    load_chains<HEAD, THREADS, C, MT>(g_src, OUT_COLS, rows_valid, gs, LDG);
  }
  fence_async();
  __syncthreads();
  store_chains<CPAD, C, MT>(xs, LDX, a.ws_in + (size_t)lr * CPAD, R, C);
  store_chains<HEAD, C, MT>(es, LDG, a.ws_e + (size_t)lr * HEAD, R, 1);
  store_chains<HEAD, C, MT>(gs, LDG, a.ws_gh + (size_t)lr * HEAD, R, C);

  // ---- forward recompute, in place in b0, saving every activation.
  for (int i = 0; i < depth; ++i) {
    Frag<W, MT> acc;
    acc.zero();
    {
      Seg s[3];
      fwd_layer(i, s);
      run<W, false, P>(acc, s, ring);
    }
    then<EARLY>(
        [&] {
          if (i < last) {
            Seg s[3];
            fwd_layer(i + 1, s);
            begin<W, false, P>(s, ring);
          } else {
            begin_with<W, true, P, 1>(head_p, ring);
          }
        },
        [&] { epi_fwd<C>(acc, bias_s + i * W, b0, LDB, masks + i * THREADS); });
    fence_async();
    __syncthreads();
    store_chains<W, C, MT>(b0, LDB, a.ws_h[i] + (size_t)lr * W, R, C);
  }

  // ---- backward. The last layer's g_pre: the head cotangents times
  // head_w^T, rounded to bf16 and masked.
  {
    Frag<W, MT> acc;
    acc.zero();
    run_with<W, true, P, 1>(acc, head_p, ring);
    then<EARLY>(
        [&] {
          Seg s[1];
          if (last == 0 || skip(last)) {
            embed_p(last, s);
            begin<HEAD, true, P>(s, ring);
          } else {
            layer_p(last, s);
            begin<W, true, P>(s, ring);
          }
        },
        [&] { epi_gpre<C>(acc, masks[last * THREADS], b0, LDB); });
    fence_async();
    __syncthreads();
  }
  // The trunk, last layer first: b0 holds layer i's g_pre of every chain.
  // d_embed and dx / d_tangents are written first by the highest layer
  // that feeds them and added to below it (flags made where used, for the
  // registers).
  auto written = [&](int i) { return (a.skip_mask >> (i + 1)) != 0; };
  for (int i = last; i >= 0; --i) {
    store_chains<W, C, MT>(b0, LDB, a.ws_gp[i] + (size_t)lr * W, R, C);
    if (i == 0 || skip(i)) {
      {
        Frag<HEAD, MT> acc;
        acc.zero();
        Seg s[1];
        embed_p(i, s);
        run<HEAD, true, P>(acc, s, ring);
        then<EARLY>([&] { begin_after(i, 0); },
                    [&] {
                      float* out[C] = {a.d_embed + (size_t)grow * a.f};
                      epi_f32_chains<C>(acc, out, a.f, a.f, rows_valid,
                                        written(i));
                    });
      }
      if (NEED_DX) {
        Frag<CPAD, MT> acc;
        acc.zero();
        Seg s[1];
        dx_p(i, s);
        run<CPAD, true, P>(acc, s, ring);
        then<EARLY>([&] { begin_after(i, 1); },
                    [&] {
                      float* out[C] = {a.dx + (size_t)grow * a.c_in};
#pragma unroll
                      for (int c = 1; c < C; ++c)
                        out[c] = a.dt[c - 1] + (size_t)grow * a.c_in;
                      epi_f32_chains<C>(acc, out, a.c_in, a.c_in, rows_valid,
                                        written(i));
                    });
      }
    }
    if (i > 0) {
      Frag<W, MT> acc;
      acc.zero();
      Seg s[1];
      layer_p(i, s);
      run<W, true, P>(acc, s, ring);
      then<EARLY>([&] { begin_after(i, 2); },
                  [&] { epi_gpre<C>(acc, masks[(i - 1) * THREADS], b0, LDB); });
      fence_async();
      __syncthreads();
    }
  }
  bulk_wait();
}

template <int W, int C, bool NEED_DX>
cudaError_t launch_warp_bwd(const WarpBwdArgs& a, cudaStream_t stream) {
  const size_t smem = warp_bwd_smem_bytes<W, C>(a.depth);
  cudaError_t err = cudaFuncSetAttribute(
      warp_bwd_rows_kernel<W, C, NEED_DX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  warp_bwd_rows_kernel<W, C, NEED_DX>
      <<<a.rows_alloc / (RBM / C), threads_for(warp_mtiles<C>()), smem,
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk of rows [row0, row0 + rows) of the warp backward's row pass;
// the workspace holds rows_alloc rows per chain, a multiple of the rows
// per chain of a block (128 / (nt + 1)), every one of them written. p
// (device pointers, null where absent): x, e, t[3], g_out, g_jout[3],
// d_embed, dx, dt[3], w[MAXD], wx[MAXD], we[MAXD], b[MAXD], head_w, ws_in,
// ws_e, ws_h[MAXD], ws_gh, ws_gp[MAXD]. Returns the launch's cudaError_t.
int warp_train_backward_rows(void* const* p, int n, int row0, int rows,
                             int rows_alloc, int c_in, int f, int depth,
                             int skip_mask, int nt, int need_dx, int width,
                             int device, void* stream) {
  if ((nt != 0 && nt != MAXT) || width != 128 || rows <= 0 || row0 < 0 ||
      row0 + rows > n || rows > rows_alloc ||
      rows_alloc % (RBM / (nt + 1)) != 0 || c_in < 1 || c_in > CPAD ||
      f < 1 || f > HEAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpBwdArgs a = {};
  int k = 0;
  a.x = (const float*)p[k++];
  a.e = (const float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.t[j] = (const float*)p[k++];
  a.g_out = (const float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.g_jout[j] = (const float*)p[k++];
  a.d_embed = (float*)p[k++];
  a.dx = (float*)p[k++];
  for (int j = 0; j < MAXT; ++j) a.dt[j] = (float*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.w[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.wx[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.we[i] = (const bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.b[i] = (const bf16*)p[k++];
  a.head_w = (const bf16*)p[k++];
  a.ws_in = (bf16*)p[k++];
  a.ws_e = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_h[i] = (bf16*)p[k++];
  a.ws_gh = (bf16*)p[k++];
  for (int i = 0; i < MAXD; ++i) a.ws_gp[i] = (bf16*)p[k++];
  a.row0 = row0;
  a.rows = rows;
  a.rows_alloc = rows_alloc;
  a.c_in = c_in;
  a.f = f;
  a.depth = depth;
  a.skip_mask = skip_mask;
  cudaStream_t s = (cudaStream_t)stream;
  if (nt == 0)
    return (int)(need_dx ? launch_warp_bwd<128, 1, true>(a, s)
                         : launch_warp_bwd<128, 1, false>(a, s));
  return (int)(need_dx ? launch_warp_bwd<128, 4, true>(a, s)
                       : launch_warp_bwd<128, 4, false>(a, s));
}

}  // extern "C"

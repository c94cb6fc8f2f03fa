// The warp trunk of training, for sm_90a: the forward of the primal and
// tangent chains.
//
// Replaces nerfies_tpu/ops/fused_warp.py:147 _warp_fwd (kernel body :168,
// pallas_call :194), with the same rounding points (warp_chains.cuh):
// bf16 operands (x, the metadata embedding, the tangents, every
// activation), f32 sums, the bias added in f32, the ReLU mask taken from
// the primal's f32 pre-activation and passed to the tangents, which take
// no bias, f32 head outputs with the head's bias on the primal only. Its
// VJP is fused_warp_bwd.cu's row pass with weight_grad.cu.
//
// The trunk (6 x 128 with a skip at 4 on the bench model) reads the
// encoding at layer 0 and at each skip, and the metadata embedding (F = 8
// columns, padded to 16 for the MMA's k) at the same layers, as a product
// with its own weight rows. 0 or 3 tangent chains (d pe / d x_j) run beside
// the primal; their heads give the Jacobian columns.
//
// Bound on an H100 SXM, at the bench widths: 92,672 multiply-adds a row
// and chain (0.75 MFLOP a row with 3 tangents, 0.59 ms at 786,432 rows at
// the bf16 tensor rate) against ~800 bytes a row of inputs and outputs
// (0.19 ms at 3.35 TB/s): operations. What holds it back long before
// either is latency: weight slices streamed from L2 once per block of
// rows, the barriers between them, and the epilogues.
//
// Design: the product engine of the row passes and the serving forwards
// (row_pass.cuh), with the chains stacked in one 128-row tile as in the
// backward's recompute (warp_chains.cuh), and no stores to a workspace:
// - a block owns 128 / C rows of each of its C chains (C = 4 with 3
//   tangents, a warp's m-tile mt belonging to chain mt % C; C = 1
//   without), so every weight slice streamed from L2 serves 128
//   chain-rows, and a layer of all chains is one product: the layer
//   input's term, the encoding's at a skip, and the embedding's k = 16
//   term at layer 0 and at a skip, whose A tile is zero in the tangents'
//   rows;
// - mma.sync.m16n8k16 fed by ldmatrix, 64-row weight slices through a
//   3-stage cp.async ring with one barrier a slice, each product's first
//   slices issued before the previous epilogue so that they land while it
//   runs; the head's (128 x 16) weight lands as one slice;
// - epilogues in place, in registers: the primal's f32 mask goes to the
//   tangents in the same lane and is never written out, the biases come
//   from shared memory (one more cp.async group behind the first
//   product's slices), the heads go to their f32 outputs straight from the
//   fragments;
// - 8 warps of MT = 4 m-tiles (64 accumulators a thread) and two blocks a
//   SM, as the serving warp trunk (fused_mlp.cu): one block's tile load,
//   epilogues and barriers overlap the other's products.
//
// Built by ops/_build.py into a plain C shared library and called through
// ctypes (ops/fused_warp.py).

#include "warp_chains.cuh"

namespace {

constexpr int KS = 64;      // weight rows per ring slice
constexpr int STAGES = 3;
constexpr int FWD_MT = 4;   // m16 tiles a warp: 8 warps, two blocks a SM

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

// Every chain's input, the primal's embedding, one activation buffer, the
// ring, and the biases (each layer's, then the head's).
template <int W>
size_t warp_fwd_smem_bytes(int depth) {
  return sizeof(bf16) * (RBM * LDX + RBM * LDG + RBM * (W + RPAD) +
                         STAGES * w_stage<W, KS>() + depth * W + HEAD);
}

template <int W, int C>
__global__ void __launch_bounds__(threads_for(FWD_MT), 2)
    warp_fwd_kernel(const __grid_constant__ WarpFwdArgs a) {
  constexpr int MT = FWD_MT;
  constexpr int THREADS = threads_for(MT);
  using Ch = Chains<C, MT>;
  constexpr int LDB = W + RPAD;
  using P = Pipe<KS, STAGES, w_stage<W, KS>(), false>;
  using PH = Pipe<W, STAGES, P::STAGE, false>;  // the head: one slice
  static_assert(W * (HEAD + RPAD) <= P::STAGE, "the head fits in one stage");
  constexpr bool EARLY = true;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // every chain's input
  bf16* es = xs + RBM * LDX;                 // the primal's embedding
  bf16* h = es + RBM * LDG;                  // every chain's activations
  bf16* ring = h + RBM * LDB;
  bf16* bias_s = ring + STAGES * P::STAGE;   // depth x W, then HEAD

  const int row0 = blockIdx.x * Ch::RC;  // first row of each chain
  const int rows_valid = min(Ch::RC, a.n - row0);
  const int depth = a.depth;
  auto layer = [&](int i, Seg (&s)[3]) { layer_terms<W>(a, i, xs, es, h, s); };
  auto head_p = [&](Seg (&s)[1]) { s[0] = Seg{h, LDB, W, a.head_w}; };

  {
    Seg s[3];
    layer(0, s);
    begin<W, false, P>(s, ring);
  }
  // The biases as one more cp.async group: the first product's closing
  // wait covers it.
  for (int v = threadIdx.x; v < depth * W / 8; v += THREADS)
    cp_async16(bias_s + v * 8, a.b[v * 8 / W] + v * 8 % W, true);
  if (a.head_b != nullptr && threadIdx.x < HEAD / 8)
    cp_async16(bias_s + depth * W + threadIdx.x * 8,
               a.head_b + threadIdx.x * 8, true);
  cp_async_commit();
  {
    // The primal first, then each tangent; the embedding is the primal's.
    const float* x_src[C] = {a.x + (size_t)row0 * a.c_in};
    const float* e_src[C] = {a.e + (size_t)row0 * a.f};
#pragma unroll
    for (int c = 1; c < C; ++c) x_src[c] = a.t[c - 1] + (size_t)row0 * a.c_in;
    load_chains<CPAD, THREADS, C, MT>(x_src, a.c_in, rows_valid, xs, LDX);
    load_chains<HEAD, THREADS, C, MT>(e_src, a.f, rows_valid, es, LDG);
  }

  for (int i = 0; i < depth; ++i) {
    Frag<W, MT> acc;
    acc.zero();
    {
      Seg s[3];
      layer(i, s);
      run<W, false, P>(acc, s, ring);
    }
    then<EARLY>(
        [&] {
          if (i < depth - 1) {
            Seg s[3];
            layer(i + 1, s);
            begin<W, false, P>(s, ring);
          } else {
            begin_with<HEAD, false, PH, 1>(head_p, ring);
          }
        },
        [&] { epi_fwd<C, false>(acc, bias_s + i * W, h, LDB, nullptr); });
  }
  Frag<HEAD, MT> acc;
  acc.zero();
  run_with<HEAD, false, PH, 1>(acc, head_p, ring);
  float* out[C] = {a.out + (size_t)row0 * OUT_COLS};
#pragma unroll
  for (int c = 1; c < C; ++c) out[c] = a.jout[c - 1] + (size_t)row0 * OUT_COLS;
  epi_f32_chains<C>(acc, out, OUT_COLS, OUT_COLS, rows_valid, false,
                    a.head_b != nullptr ? bias_s + depth * W : nullptr);
}

template <int W, int C>
cudaError_t launch_warp_fwd(const WarpFwdArgs& a, cudaStream_t stream) {
  const size_t smem = warp_fwd_smem_bytes<W>(a.depth);
  cudaError_t err = cudaFuncSetAttribute(
      warp_fwd_kernel<W, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int RC = RBM / C;
  warp_fwd_kernel<W, C>
      <<<(a.n + RC - 1) / RC, threads_for(FWD_MT), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p (device pointers, null where absent): x, e, t[3], out, jout[3],
// w[MAXD], wx[MAXD], we[MAXD], b[MAXD], head_w, head_b. Returns the
// launch's cudaError_t.
int warp_train_forward(void* const* p, int n, int c_in, int f, int depth,
                       int skip_mask, int nt, int width, int device,
                       void* stream) {
  if ((nt != 0 && nt != MAXT) || width != 128 || n <= 0 || c_in < 1 ||
      c_in > CPAD || f < 1 || f > HEAD || depth < 1 || depth > MAXD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WarpFwdArgs a = {};
  int k = 0;
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
  a.n = n;
  a.c_in = c_in;
  a.f = f;
  a.depth = depth;
  a.skip_mask = skip_mask;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(nt == 0 ? launch_warp_fwd<128, 1>(a, s)
                       : launch_warp_fwd<128, 4>(a, s));
}

}  // extern "C"

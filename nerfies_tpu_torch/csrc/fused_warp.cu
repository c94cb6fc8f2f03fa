// The warp trunk of training, for sm_90a: the forward of the primal and
// tangent chains.
//
// Replaces nerfies_tpu/ops/fused_warp.py:147 _warp_fwd (kernel body :168),
// with the same rounding points: bf16 operands (x, the metadata embedding,
// the tangents, every activation), f32 sums, the bias added in f32, the
// ReLU mask taken from the primal's f32 pre-activation, f32 head outputs.
// Its VJP is fused_warp_bwd.cu's row pass with weight_grad.cu.
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
// Bound on an H100 SXM: per row and chain, 92,672 multiply-adds: the
// tensor rate, against a few hundred bytes per row of inputs and outputs.

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

template <int W, int C>
constexpr size_t warp_smem_bytes() {
  return sizeof(bf16) * (C * BM * LDX + BM * LDG + C * BM * (W + SPAD) +
                         BK * (W + SPAD)) +
         sizeof(float) * (NTHREADS / 32) * 256;
}

// act[c] = chain c's activation: the primal's ReLU of (acc + bias) and the
// tangents' acc under the primal's f32 mask, each rounded to bf16, to
// shared memory (row stride ldo).
template <int N, int C>
__device__ void epilogue_chains(Acc<N> (&acc)[C], const bf16* __restrict__ bias,
                                bf16* const (&out)[C], int ldo,
                                float* scratch) {
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
      out[0][r * ldo + c] = __float2bfloat16(on ? v : 0.0f);
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
        out[ch][r * ldo + c] =
            __float2bfloat16(((bits >> k) & 1) ? s[e] : 0.0f);
      }
      __syncwarp();
    }
  }
}

// The forward over one block's rows of all C chains; the last layer's
// activations stay in hs[c].
template <int W, int C>
__device__ void warp_forward_tile(const WarpFwdArgs& a, bf16* const (&in)[C],
                                  const bf16* es, bf16* const (&hs)[C],
                                  bf16* w_s, float* scratch) {
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
    epilogue_chains<W, C>(acc, a.b[i], hs, W + SPAD, scratch);
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
  load_tile<CPAD>(a.x, a.c_in, row0, rows_valid, in[0], LDX);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    load_tile<CPAD>(a.t[j], a.c_in, row0, rows_valid, in[1 + j], LDX);
  load_tile<HEAD>(a.e, a.f, row0, rows_valid, es, LDG);
  warp_forward_tile<W, C>(a, in, es, hs, w_s, scratch);

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
  if (width == 128 && nt == 0)
    return (int)launch_rows(warp_fwd_kernel<128, 0>, a, n,
                            warp_smem_bytes<128, 1>(), s);
  if (width == 128 && nt == 3)
    return (int)launch_rows(warp_fwd_kernel<128, 3>, a, n,
                            warp_smem_bytes<128, 4>(), s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

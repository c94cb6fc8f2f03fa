// Fused MLP stacks for serving: the NeRF MLP and the warp trunk, for sm_90a.
//
// Replaces two Pallas kernels of the JAX package:
//   nerf_mlp_kernel   <- nerfies_tpu/ops/fused_mlp.py:78  nerf_mlp_forward
//   warp_trunk_kernel <- nerfies_tpu/ops/fused_mlp.py:645 warp_trunk_forward
// with the same numeric contract: bf16 operands, f32 accumulation, bf16
// biases added in f32, per-row biases rounded to bf16 then added in f32,
// ReLU in f32 with the result stored as bf16, f32 head outputs.
//
// Bound on an H100 SXM. Per row the NeRF MLP does 583,808 MACs (1.17 MFLOP)
// and the warp trunk 92,672 MACs (0.19 MFLOP), while it reads the encoding
// and the row biases and writes 32 B per head: a few hundred bytes per row.
// At ~2,000 FLOP per byte both kernels are bound by the bf16 tensor rate
// (989 TFLOP/s dense), not by the 3.35 TB/s of device memory.
//
// Design. One block of 8 warps owns a tile of 64 rows and keeps it on chip
// from the encoding to the heads: the encoding tile and two activation
// buffers live in shared memory, so per row only the encoding, the row
// biases and the heads cross device memory. The weights (1.25 MB for the
// NeRF MLP) do not fit in shared memory, so each layer streams them from L2
// in slices of 32 input rows, which all 8 warps share. Products are
// nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators held in
// registers; warp w owns rows 16*(w%4) .. +16 and every other 16-column
// tile starting at w/4. An epilogue per warp goes through a 16x16 f32
// scratch tile to add the biases, take the ReLU and store bf16. The skip
// layer accumulates its second product, from the saved encoding tile, into
// the same accumulators. Rows past N are zero on input and never stored.
// What this leaves on the table is pipelining: the slice loads are not
// overlapped with the products (no cp.async, TMA or wgmma yet).
//
// The arguments travel as one __grid_constant__ struct, so the trunk can
// index its per-layer pointer arrays without a copy to local memory.
//
// The building blocks (tiles, weight slices, epilogues) are in
// mlp_common.cuh. Built by ops/_build.py into a plain C shared library and
// called through ctypes (ops/fused_mlp.py).

#include "mlp_common.cuh"

namespace {

// Shared memory of a kernel whose activation buffers and weight slices
// are L columns wide (plus padding): the widest product it runs.
template <int L>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BM * LDX + 2 * BM * (L + SPAD) + BK * (L + SPAD)) +
         sizeof(float) * (NTHREADS / 32) * 256;
}

// The trunk: `depth` layers of width W over the encoding tile xs, with the
// skip layers' second product from xs; h0 and h1 have row stride LDH.
// Returns the buffer holding h.
template <int W, int LDH = W + SPAD>
__device__ bf16* trunk(const bf16* const* w, const bf16* const* wx,
                       const bf16* const* b, const bf16* const* row_bias,
                       int depth, int skip_mask, int row0, int rows_valid,
                       bf16* xs, bf16* h0, bf16* h1, bf16* w_s,
                       float* scratch) {
  const bf16* cur = xs;
  int ldc = LDX, kc = CPAD;
  bf16* h = h0;
  for (int i = 0; i < depth; ++i) {
    Acc<W> acc;
    acc.zero();
    accumulate<W>(acc, cur, ldc, kc, w[i], w_s);
    if (i > 0 && ((skip_mask >> i) & 1))
      accumulate<W>(acc, xs, LDX, CPAD, wx[i], w_s);
    h = (i & 1) ? h1 : h0;
    const bf16* rb = (row_bias != nullptr && row_bias[i] != nullptr)
                         ? row_bias[i] + (size_t)row0 * W
                         : nullptr;
    epilogue_bf16<W>(acc, b[i], rb, rows_valid, true, h, LDH, scratch);
    cur = h;
    ldc = LDH;
    kc = W;
  }
  return h;
}

enum { HAS_BOTTLENECK = 1, ALPHA_FROM_BT = 2, RGB_FROM_BT = 4,
       HAS_RGB_HIDDEN = 8 };

struct NerfArgs {
  const float* x;
  const bf16* row_bias;
  float* alpha;
  float* rgb;
  const bf16* w[MAXD];
  const bf16* wx[MAXD];
  const bf16* b[MAXD];
  const bf16* bot_w;
  const bf16* bot_b;
  const bf16* al_w;
  const bf16* al_b;
  const bf16* rh_w;
  const bf16* rh_b;
  const bf16* rl_w;
  const bf16* rl_b;
  int n, c_in, depth, skip_mask, flags;
};

// The rgb branch's RW-wide tiles share the trunk's buffers and weight
// slice, so every buffer is sized by the wider of W and RW.
template <int W, int RW>
__host__ __device__ constexpr int nerf_cols() { return W > RW ? W : RW; }

template <int W, int RW>
__global__ void __launch_bounds__(NTHREADS, 2) nerf_mlp_kernel(const __grid_constant__ NerfArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = nerf_cols<W, RW>() + SPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* h0 = xs + BM * LDX;
  bf16* h1 = h0 + BM * LDH;
  bf16* w_s = h1 + BM * LDH;
  float* scratch = reinterpret_cast<float*>(w_s + BK * LDH);

  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, a.n - row0);
  load_tile<CPAD>(a.x, a.c_in, row0, rows_valid, xs, LDX);
  bf16* h = trunk<W, LDH>(a.w, a.wx, a.b, nullptr, a.depth, a.skip_mask,
                          row0, rows_valid, xs, h0, h1, w_s, scratch);
  bf16* other = (h == h0) ? h1 : h0;

  const bf16* bt = h;
  if (a.flags & HAS_BOTTLENECK) {
    Acc<W> acc;
    acc.zero();
    accumulate<W>(acc, h, LDH, W, a.bot_w, w_s);
    epilogue_bf16<W>(acc, a.bot_b, nullptr, rows_valid, false, other, LDH,
                     scratch);
    bt = other;
  }

  {
    Acc<HEAD> acc;
    acc.zero();
    accumulate<HEAD>(acc, (a.flags & ALPHA_FROM_BT) ? bt : h, LDH, W,
                     a.al_w, w_s);
    epilogue_head(acc, a.al_b, rows_valid, a.alpha + (size_t)row0 * OUT_COLS,
                  scratch);
  }

  const bf16* src = (a.flags & RGB_FROM_BT) ? bt : h;
  int k_head = W;
  if (a.flags & HAS_RGB_HIDDEN) {
    // y goes to whichever buffer the rgb branch does not read; the alpha
    // head's reads of it finished at the first barrier of this product.
    bf16* y = (src == h0) ? h1 : h0;
    Acc<RW> acc;
    acc.zero();
    accumulate<RW>(acc, src, LDH, W, a.rh_w, w_s);
    const bf16* rb =
        a.row_bias != nullptr ? a.row_bias + (size_t)row0 * RW : nullptr;
    epilogue_bf16<RW>(acc, a.rh_b, rb, rows_valid, true, y, LDH, scratch);
    src = y;
    k_head = RW;
  }
  Acc<HEAD> acc;
  acc.zero();
  accumulate<HEAD>(acc, src, LDH, k_head, a.rl_w, w_s);
  epilogue_head(acc, a.rl_b, rows_valid, a.rgb + (size_t)row0 * OUT_COLS,
                scratch);
}

struct WarpArgs {
  const float* x;
  float* out;
  const bf16* w[MAXD];
  const bf16* wx[MAXD];
  const bf16* b[MAXD];
  const bf16* head_w;
  const bf16* head_b;
  const bf16* rb[MAXD];
  int n, c_in, depth, skip_mask;
};

template <int W>
__global__ void __launch_bounds__(NTHREADS, 2) warp_trunk_kernel(const __grid_constant__ WarpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDH = W + SPAD;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* h0 = xs + BM * LDX;
  bf16* h1 = h0 + BM * LDH;
  bf16* w_s = h1 + BM * LDH;
  float* scratch = reinterpret_cast<float*>(w_s + BK * LDH);

  const int row0 = blockIdx.x * BM;
  const int rows_valid = min(BM, a.n - row0);
  load_tile<CPAD>(a.x, a.c_in, row0, rows_valid, xs, LDX);
  bf16* h = trunk<W>(a.w, a.wx, a.b, a.rb, a.depth, a.skip_mask, row0,
                     rows_valid, xs, h0, h1, w_s, scratch);
  Acc<HEAD> acc;
  acc.zero();
  accumulate<HEAD>(acc, h, LDH, W, a.head_w, w_s);
  epilogue_head(acc, a.head_b, rows_valid, a.out + (size_t)row0 * OUT_COLS,
                scratch);
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& a, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (a.n + BM - 1) / BM;
  kernel<<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p: x, row_bias, alpha, rgb, w[MAXD], wx[MAXD], b[MAXD], bot_w, bot_b,
// al_w, al_b, rh_w, rh_b, rl_w, rl_b (device pointers, null where absent).
// Returns the launch's cudaError_t.
int nerf_mlp_forward(void* const* p, int n, int c_in, int depth,
                     int skip_mask, int flags, int width, int rgb_width,
                     int device, void* stream) {
  if (n <= 0 || c_in > CPAD || depth < 1 || depth > MAXD)
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
    return (int)launch(nerf_mlp_kernel<256, 128>, a,
                       smem_bytes<nerf_cols<256, 128>()>(), s);
  if (width == 128 && rgb_width == 128)
    return (int)launch(nerf_mlp_kernel<128, 128>, a,
                       smem_bytes<nerf_cols<128, 128>()>(), s);
  if (width == 32 && rgb_width == 128)
    return (int)launch(nerf_mlp_kernel<32, 128>, a,
                       smem_bytes<nerf_cols<32, 128>()>(), s);
  return (int)cudaErrorInvalidValue;
}

// p: x, out, w[MAXD], wx[MAXD], b[MAXD], head_w, head_b, rb[MAXD].
int warp_trunk_forward(void* const* p, int n, int c_in, int depth,
                       int skip_mask, int width, int device, void* stream) {
  if (n <= 0 || c_in > CPAD || depth < 1 || depth > MAXD)
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
  if (width == 128)
    return (int)launch(warp_trunk_kernel<128>, a, smem_bytes<128>(),
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

const char* fused_mlp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

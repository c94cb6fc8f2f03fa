// Weight gradients of the fused backward kernels, reduced in a fixed order.
//
// The two Pallas backward kernels (nerfies_tpu/ops/fused_mlp.py:432
// _nerf_train_bwd and nerfies_tpu/ops/fused_warp.py:207 _warp_bwd) form
// every dW = src^T @ g_pre inside their body and add it into one f32 block
// that stays resident across a grid that runs in order. Blocks of a CUDA
// grid run in parallel and in no order, so here the backward is two
// passes per chunk of rows: the row kernels (fused_mlp_bwd.cu,
// fused_warp.cu) store each layer's bf16 input activation and bf16
// pre-activation cotangent to a workspace, and this file forms the
// products:
//
//   dw_partial_kernel  one block per (TM x TN tile of one dW, row split):
//                      the f32 products over the split's rows, plus the
//                      f32 column sums of G (the bias gradient), stored to
//                      the split's own slot;
//   dw_reduce_kernel   out = (accumulate ? out : 0) + sum over splits, in
//                      split order.
//
// No atomics: every sum has one order, so two runs give the same bits.
// A job is one weight: dW (m x n) = A[rows x m]^T @ G[rows x n], A and G
// bf16, row-major, m and n multiples of 16. Rows of a chunk's workspace
// stack the chains of a tangent-carrying kernel one after another, so a
// job over all of them sums the chains' products, and a job over the first
// `rows` of them sees the primal chain only.
//
// Bound on an H100 SXM: bytes. A job reads (m + n) x 2 bytes a row for
// 2 m n FLOP: at most 128 FLOP a byte for a 256 x 256 weight, under the
// ~295 at which the tensor rate would bind. So the design reads each byte
// as few times as it can: a block owns a tall tile, all TN = 256 (or 128)
// columns of G against TM = 128 columns of A, so A is read once and G
// ceil(m / 128) times (twice at width 256); a ring of DW_STAGES cp.async
// stages keeps KR-row strips of both in flight while mma.sync products run
// on the strip that has landed. 16 warps, each a 32 x TN/4 tile of the
// products in registers; A^T's fragments come from the row-major strip
// through ldmatrix.trans, G's likewise. The bias sums run on all threads,
// a column pair and a quarter (or eighth) of each strip apiece.

#include "mma_pipe.cuh"

namespace {

constexpr int DW_THREADS = 512;   // 16 warps: 4 along m x 4 along n
constexpr int TM = 128;           // dW rows (columns of A) per block
constexpr int KR = 64;            // workspace rows per stage
constexpr int DW_STAGES = 3;
constexpr int DPAD = 8;           // shared row padding (bf16 elements)
constexpr int LDA_S = TM + DPAD;
constexpr int MAX_JOBS = 24;

struct DwJob {
  const bf16* a;
  const bf16* g;
  int lda, ldg;     // row strides (elements)
  int m, n;         // dW is m x n
  int rows;         // rows of A and G to reduce over
  int bias_rows;    // column sums of G over its first bias_rows rows; 0: none
  int out;          // offset of dW in the flat f32 output
  int bias_out;     // offset of the bias gradient (n floats)
  int tiles_n;      // ceil(n / TN)
  int tile0;        // first grid tile of this job
};

struct DwArgs {
  DwJob jobs[MAX_JOBS];
  int njobs;
  int splits;
  long long stride;  // floats per split slot
  float* partial;    // splits x stride
};

template <int TN>
__host__ __device__ constexpr int dw_stage_elems() {
  return KR * LDA_S + KR * (TN + DPAD);
}

template <int TN>
constexpr size_t dw_smem_bytes() {
  return sizeof(bf16) * DW_STAGES * dw_stage_elems<TN>();
}

template <int TN>
__global__ void __launch_bounds__(DW_THREADS, 1)
    dw_partial_kernel(const __grid_constant__ DwArgs a) {
  constexpr int LDG_S = TN + DPAD;
  constexpr int SE = dw_stage_elems<TN>();
  constexpr int WN = TN / 4;   // columns per warp
  constexpr int NTW = WN / 8;  // n8 tiles per warp (even)
  // The bias: thread t sums column pair t % PAIRS over rows (t / PAIRS)
  // * ROWS_PER .. + ROWS_PER of each strip.
  constexpr int PAIRS = TN / 2;
  constexpr int GROUPS = DW_THREADS / PAIRS;
  constexpr int ROWS_PER = KR / GROUPS;
  extern __shared__ __align__(128) unsigned char dw_smem[];
  bf16* smem = reinterpret_cast<bf16*>(dw_smem);

  int jb = 0;
  while (jb + 1 < a.njobs && (int)blockIdx.x >= a.jobs[jb + 1].tile0) ++jb;
  const DwJob& job = a.jobs[jb];
  const int tile = blockIdx.x - job.tile0;
  const int m0 = (tile / job.tiles_n) * TM;
  const int n0 = (tile % job.tiles_n) * TN;
  const int split = blockIdx.y;
  const int per = ((job.rows + a.splits - 1) / a.splits + KR - 1) / KR * KR;
  const int r_begin = min(job.rows, split * per);
  const int r_end = min(job.rows, r_begin + per);
  const int steps = (r_end - r_begin + KR - 1) / KR;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp & 3) * 32;     // this warp's first row of the tile
  const int wn = (warp >> 2) * WN;    // and first column
  const bool do_bias = job.bias_rows > 0 && m0 == 0;
  const int bias_end = min(r_end, job.bias_rows);
  const int pair = tid % PAIRS, group = tid / PAIRS;
  float2 col_sum = make_float2(0.0f, 0.0f);

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // Strip `step` (KR rows of A's TM columns and G's TN columns) into
  // `stage`; rows past the split and columns past the matrix read as 0.
  auto load = [&](int step, int stage) {
    bf16* as = smem + stage * SE;
    bf16* gs = as + KR * LDA_S;
    const int r0 = r_begin + step * KR;
#pragma unroll
    for (int i = 0; i < KR * (TM / 8) / DW_THREADS; ++i) {
      const int v = tid + i * DW_THREADS;
      const int r = v / (TM / 8), c = (v % (TM / 8)) * 8;
      const bool ok = r0 + r < r_end && m0 + c < job.m;
      cp_async16(as + r * LDA_S + c,
                 ok ? job.a + (size_t)(r0 + r) * job.lda + m0 + c : job.a,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < KR * (TN / 8) / DW_THREADS; ++i) {
      const int v = tid + i * DW_THREADS;
      const int r = v / (TN / 8), c = (v % (TN / 8)) * 8;
      const bool ok = r0 + r < r_end && n0 + c < job.n;
      cp_async16(gs + r * LDG_S + c,
                 ok ? job.g + (size_t)(r0 + r) * job.ldg + n0 + c : job.g,
                 ok);
    }
  };

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // strip t has landed; strip t - 1 is consumed
    if (t + DW_STAGES - 1 < steps)
      load(t + DW_STAGES - 1, (t + DW_STAGES - 1) % DW_STAGES);
    cp_async_commit();
    const bf16* as = smem + (t % DW_STAGES) * SE;
    const bf16* gs = as + KR * LDA_S;
    if (do_bias) {
      const int r0 = group * ROWS_PER;
      const int last = min(r0 + ROWS_PER, bias_end - (r_begin + t * KR));
      for (int r = r0; r < last; ++r) {
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(gs + r * LDG_S +
                                                     2 * pair));
        col_sum.x += v.x;
        col_sum.y += v.y;
      }
    }
#pragma unroll
    for (int ks = 0; ks < KR; ks += 16) {
      // A^T fragments: matrix i of lane group i = lane / 8 holds k offset
      // (i / 2) * 8 and m offset (i % 2) * 8.
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (m0 + wm + mt * 16 < job.m)
          ldsm_x4_t(af[mt], as + (ks + (lane & 7) + ((lane >> 4) << 3)) *
                                     LDA_S +
                                wm + mt * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int jp = 0; jp < NTW / 2; ++jp) {
        const int nb = wn + jp * 16;
        if (n0 + nb >= job.n) continue;
        uint32_t bfr[4];
        ldsm_x4_t(bfr, gs + (ks + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                LDG_S +
                           nb + ((lane >> 4) << 3));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (m0 + wm + mt * 16 >= job.m) continue;
          mma16816(acc[mt][2 * jp], af[mt], bfr[0], bfr[1]);
          mma16816(acc[mt][2 * jp + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* slot = a.partial + (size_t)split * a.stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = m0 + wm + mt * 16 + (lane >> 2);
    if (row >= job.m) continue;
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int col = n0 + wn + j * 8 + 2 * (lane & 3);
      if (col >= job.n) continue;
      float* p = slot + job.out + (size_t)row * job.n + col;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(p + 8 * (size_t)job.n) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
  if (do_bias) {
    // The row groups' sums, added in group order.
    __syncthreads();
    float2* sums = reinterpret_cast<float2*>(dw_smem);
    sums[group * PAIRS + pair] = col_sum;
    __syncthreads();
    if (tid < PAIRS && n0 + 2 * tid < job.n) {
      float2 total = sums[tid];
      for (int g = 1; g < GROUPS; ++g) {
        total.x += sums[g * PAIRS + tid].x;
        total.y += sums[g * PAIRS + tid].y;
      }
      *reinterpret_cast<float2*>(slot + job.bias_out + n0 + 2 * tid) = total;
    }
  }
}

__global__ void dw_reduce_kernel(const float* __restrict__ partial,
                                 long long stride, int splits,
                                 float* __restrict__ out, int accumulate) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < stride; e += (long long)gridDim.x * blockDim.x) {
    float v = accumulate ? out[e] : 0.0f;
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * stride + e];
    out[e] = v + s;
  }
}

template <int TN>
cudaError_t launch_partial(const DwArgs& a, int tiles, cudaStream_t s) {
  const size_t smem = dw_smem_bytes<TN>();
  cudaError_t err = cudaFuncSetAttribute(
      dw_partial_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dw_partial_kernel<TN><<<dim3(tiles, a.splits), DW_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Adds the weight gradients of one chunk into `out`, in a fixed order.
//   ptrs:  2 per job: A, G (device pointers)
//   ints:  8 per job: lda, ldg, m, n, rows, bias_rows, out, bias_out
//   tile_n: 256 or 128, the block tile's columns (at least every job's n
//     for one pass over A);
//   partial: splits x stride floats of scratch; out: stride floats;
//   accumulate: 0 for the first chunk (out is overwritten), 1 after.
// Offsets must be multiples of 8 floats. Returns a cudaError_t.
int weight_grad(void* const* ptrs, const int* ints, int njobs, int tile_n,
                int splits, float* partial, long long stride, float* out,
                int accumulate, int device, void* stream) {
  if (njobs <= 0 || njobs > MAX_JOBS || splits <= 0 ||
      (tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DwArgs a = {};
  int tiles = 0;
  for (int j = 0; j < njobs; ++j) {
    DwJob& job = a.jobs[j];
    job.a = (const bf16*)ptrs[2 * j];
    job.g = (const bf16*)ptrs[2 * j + 1];
    const int* v = ints + 8 * j;
    job.lda = v[0];
    job.ldg = v[1];
    job.m = v[2];
    job.n = v[3];
    job.rows = v[4];
    job.bias_rows = v[5];
    job.out = v[6];
    job.bias_out = v[7];
    if (job.m % 16 || job.n % 16 || job.lda % 8 || job.ldg % 8 ||
        job.out % 8 || job.rows < 0 || job.m > job.lda || job.n > job.ldg)
      return (int)cudaErrorInvalidValue;
    job.tiles_n = (job.n + tile_n - 1) / tile_n;
    job.tile0 = tiles;
    tiles += ((job.m + TM - 1) / TM) * job.tiles_n;
  }
  a.njobs = njobs;
  a.splits = splits;
  a.stride = stride;
  a.partial = partial;
  cudaStream_t s = (cudaStream_t)stream;
  err = tile_n == 256 ? launch_partial<256>(a, tiles, s)
                      : launch_partial<128>(a, tiles, s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((stride + 255) / 256 < 4096 ? (stride + 255) / 256
                                                       : 4096);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(partial, stride, splits, out,
                                          accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"

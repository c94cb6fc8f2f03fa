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
//   dw_partial_kernel  one block per (64 x 64 tile of one dW, row split):
//                      wmma bf16 products with f32 accumulators over the
//                      split's rows, plus the f32 column sums of g (the
//                      bias gradient), stored to the split's own slot;
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
// Bound: 2 * rows * m * n FLOP per job (the same as the Pallas kernels'
// in-body dW); bytes: each block reads its rows of a 64-column strip of A
// and of G, so A and G are read n/64 and m/64 times over. That re-reading,
// not the tensor rate, is what this simple tiling leaves on the table.

#include "mlp_common.cuh"

namespace {

constexpr int TILE = 64;          // dW tile, both dimensions
constexpr int DBR = 32;           // rows staged per step
constexpr int LDT = TILE + SPAD;  // staged row stride
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
  int tiles_n;      // ceil(n / TILE)
  int tile0;        // first grid tile of this job
};

struct DwArgs {
  DwJob jobs[MAX_JOBS];
  int njobs;
  int splits;
  long long stride;  // floats per split slot
  float* partial;    // splits x stride
};

__global__ void __launch_bounds__(NTHREADS) dw_partial_kernel(
    const __grid_constant__ DwArgs a) {
  __shared__ __align__(128) bf16 a_s[DBR * LDT];
  __shared__ __align__(128) bf16 g_s[DBR * LDT];
  int jb = 0;
  while (jb + 1 < a.njobs && (int)blockIdx.x >= a.jobs[jb + 1].tile0) ++jb;
  const DwJob& job = a.jobs[jb];
  const int tile = blockIdx.x - job.tile0;
  const int m0 = (tile / job.tiles_n) * TILE;
  const int n0 = (tile % job.tiles_n) * TILE;
  const int split = blockIdx.y;
  const int per = ((job.rows + a.splits - 1) / a.splits + DBR - 1) / DBR * DBR;
  const int r_begin = min(job.rows, split * per);
  const int r_end = min(job.rows, r_begin + per);

  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3, cg = warp >> 2;
  const bool m_ok = m0 + rg * 16 < job.m;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const bool do_bias = job.bias_rows > 0 && m0 == 0;
  float col_sum = 0.0f;  // thread t < TILE: column n0 + t of the bias

  for (int r0 = r_begin; r0 < r_end; r0 += DBR) {
    __syncthreads();  // the previous step's tiles are consumed
    // 8 bf16 (16 bytes) per vector; m and n are multiples of 16, so a
    // vector lies wholly inside or wholly outside the matrix.
    for (int v = threadIdx.x; v < 2 * DBR * (TILE / 8); v += NTHREADS) {
      const bool is_g = v >= DBR * (TILE / 8);
      const int u = is_g ? v - DBR * (TILE / 8) : v;
      const int r = u / (TILE / 8), c = (u % (TILE / 8)) * 8;
      const int row = r0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (is_g) {
        if (row < r_end && n0 + c < job.n)
          val = *reinterpret_cast<const uint4*>(
              job.g + (size_t)row * job.ldg + n0 + c);
        *reinterpret_cast<uint4*>(g_s + r * LDT + c) = val;
      } else {
        if (row < r_end && m0 + c < job.m)
          val = *reinterpret_cast<const uint4*>(
              job.a + (size_t)row * job.lda + m0 + c);
        *reinterpret_cast<uint4*>(a_s + r * LDT + c) = val;
      }
    }
    __syncthreads();
    if (do_bias && (int)threadIdx.x < TILE) {
      const int last = min(DBR, min(r_end, job.bias_rows) - r0);
      for (int r = 0; r < last; ++r)
        col_sum += __bfloat162float(g_s[r * LDT + threadIdx.x]);
    }
    if (m_ok) {
#pragma unroll
      for (int ks = 0; ks < DBR; ks += 16) {
        // A^T: element (m, k) of the fragment is A[k][m], a column-major
        // read of the staged rows.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
        wmma::load_matrix_sync(fa, a_s + ks * LDT + rg * 16, LDT);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = cg + 2 * j;
          if (n0 + nt * 16 < job.n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                fb;
            wmma::load_matrix_sync(fb, g_s + ks * LDT + nt * 16, LDT);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
  }

  float* slot = a.partial + (size_t)split * a.stride;
  if (m_ok) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nt = cg + 2 * j;
      if (n0 + nt * 16 < job.n)
        wmma::store_matrix_sync(
            slot + job.out + (size_t)(m0 + rg * 16) * job.n + n0 + nt * 16,
            acc[j], job.n, wmma::mem_row_major);
    }
  }
  if (do_bias && (int)threadIdx.x < TILE && n0 + (int)threadIdx.x < job.n)
    slot[job.bias_out + n0 + threadIdx.x] = col_sum;
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

}  // namespace

extern "C" {

// Adds the weight gradients of one chunk into `out`, in a fixed order.
//   ptrs:  2 per job: A, G (device pointers)
//   ints:  8 per job: lda, ldg, m, n, rows, bias_rows, out, bias_out
//   partial: splits x stride floats of scratch; out: stride floats;
//   accumulate: 0 for the first chunk (out is overwritten), 1 after.
// Offsets must be multiples of 8 floats. Returns a cudaError_t.
int weight_grad(void* const* ptrs, const int* ints, int njobs, int splits,
                float* partial, long long stride, float* out, int accumulate,
                int device, void* stream) {
  if (njobs <= 0 || njobs > MAX_JOBS || splits <= 0)
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
        job.out % 8 || job.rows < 0)
      return (int)cudaErrorInvalidValue;
    job.tiles_n = (job.n + TILE - 1) / TILE;
    job.tile0 = tiles;
    tiles += ((job.m + TILE - 1) / TILE) * job.tiles_n;
  }
  a.njobs = njobs;
  a.splits = splits;
  a.stride = stride;
  a.partial = partial;
  cudaStream_t s = (cudaStream_t)stream;
  dw_partial_kernel<<<dim3(tiles, splits), NTHREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)((stride + 255) / 256 < 4096 ? (stride + 255) / 256
                                                       : 4096);
  dw_reduce_kernel<<<blocks, 256, 0, s>>>(partial, stride, splits, out,
                                          accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"

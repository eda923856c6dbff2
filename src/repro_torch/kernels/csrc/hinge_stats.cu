// Fused Newton outer-step statistics of the primal squared-hinge SVM, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hinge_stats.py::_stats_kernel
// (and its Pallas-Triton twin repro/kernels/hinge_stats_gpu.py::
// _stats_gpu_kernel). From X (n, p), w, y (n,), 1/t and C it computes, for the
// implicit SVEN dataset,
//
//     a = X^T w (p,),  byw = y.w / t,
//     m_top = a - byw,  m_bot = -(a + byw),  act = (m < 1),
//     g_top = act_top (a - byw - 1),  g_bot = act_bot (a + byw + 1),
//     and one loss partial C sum_j (xi_top^2 + xi_bot^2), xi = act (1 - m),
//     per block.
//
// What bounds it: one read of X (n p elements), w and y, and four p-vectors
// written; about 2 n p FLOPs, two orders of magnitude under the fp32 rate for
// those bytes, so the card's memory rate bounds it. At the GLA-BRA-180 shape
// (n = 180, p = 49,151) X is 35 MB in f32; at the YMSD shape (n = 463,715,
// p = 90) it is 167 MB.
//
// Design. A column reduction of a row-major X, laid out as hinge pass 1
// (hinge.cu): threadIdx.x maps to 32 neighbouring columns, so a warp reads one
// 128-byte segment of a row, and the 8 warps of a block split the rows and
// meet in shared memory. The TPU kernel carries its sums across a sequential
// grid axis; CUDA blocks run in no order, so the sum over n is cut into row
// chunks when X is too narrow to fill the card by columns alone:
//   - one chunk (wide X: GLA-BRA-180 gives 1,536 column blocks): the block sums
//     all n rows, recomputes y.w itself (n is small there, as on the TPU) and
//     runs the epilogue in the same launch;
//   - several chunks (tall X: YMSD gives 3 column blocks): stats_partial writes
//     one partial of a per chunk and column, and column block 0 one partial of
//     y.w per chunk; stats_finish, one thread per column, sums the partials over
//     the chunks in a fixed order and only then runs the epilogue.
// No float atomics: every sum runs in a fixed order, so the result is the same
// on every run. Ragged edges are masked; there are no padded columns, so the
// loss needs no correction for them.
//
// X is float32 or bfloat16 storage; everything else is float32 and every sum
// is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                 // columns per block of stats_partial
constexpr int kWarps = 8;                 // row phases per block
constexpr int kThreads = kCols * kWarps;  // also the threads of stats_finish

template <typename T> __device__ __forceinline__ float ld(const T* p, int64_t i);
template <> __device__ __forceinline__ float ld<float>(const float* p, int64_t i) {
  return p[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                               int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a block of kThreads threads of one value per thread, in a fixed
// order; every thread gets the result. `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  const int lane = tid % 32, warp = tid / 32;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

struct Out {
  float* mt;         // (p,) m_top
  float* mb;         // (p,) m_bot
  float* gt;         // (p,) g_top
  float* gb;         // (p,) g_bot
  float* loss_part;  // one per block of the launch that runs the epilogue
};

// The epilogue of column j: writes its four outputs and returns
// xi_top^2 + xi_bot^2 (the block multiplies its sum by C).
__device__ __forceinline__ float epilogue(float a, float byw, int j, const Out& o) {
  const float o_top = a - byw, o_bot = a + byw;
  const float m_top = o_top, m_bot = -o_bot;
  const bool act_t = m_top < 1.f, act_b = m_bot < 1.f;
  const float xi_t = act_t ? 1.f - m_top : 0.f;
  const float xi_b = act_b ? 1.f - m_bot : 0.f;
  o.mt[j] = m_top;
  o.mb[j] = m_bot;
  o.gt[j] = act_t ? o_top - 1.f : 0.f;
  o.gb[j] = act_b ? o_bot + 1.f : 0.f;
  return xi_t * xi_t + xi_b * xi_b;
}

// block (32, 8), grid (ceil(p/32), nchunk): threadIdx.x = column within the
// block's 32, threadIdx.y = row phase, blockIdx.y = row chunk. kFused: one
// chunk of all n rows, epilogue here; else partials to a_part / yw_part.
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ X, const float* __restrict__ w,
              const float* __restrict__ y, int n, int p, int rows_per_chunk,
              float* __restrict__ a_part, float* __restrict__ yw_part, Out o,
              float invt, float C) {
  __shared__ float red[kWarps];
  __shared__ float colsum[kWarps][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int k = blockIdx.y;
  const int r0 = k * rows_per_chunk;
  const int r1 = min(n, r0 + rows_per_chunk);
  const int j = blockIdx.x * kCols + tx;

  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if (j < p) {
    int r = r0 + ty;
    for (; r + 3 * kWarps < r1; r += 4 * kWarps) {
      c0 = fmaf(ld<T>(X, (int64_t)r * p + j), w[r], c0);
      c1 = fmaf(ld<T>(X, (int64_t)(r + kWarps) * p + j), w[r + kWarps], c1);
      c2 = fmaf(ld<T>(X, (int64_t)(r + 2 * kWarps) * p + j), w[r + 2 * kWarps], c2);
      c3 = fmaf(ld<T>(X, (int64_t)(r + 3 * kWarps) * p + j), w[r + 3 * kWarps], c3);
    }
    for (; r < r1; r += kWarps) c0 = fmaf(ld<T>(X, (int64_t)r * p + j), w[r], c0);
  }
  colsum[ty][tx] = (c0 + c1) + (c2 + c3);

  // y.w over all rows (fused) or over this chunk (column block 0 only); the
  // condition is uniform over the block, so block_sum may synchronise.
  float yw = 0.f;
  if (kFused || blockIdx.x == 0) {
    float s = 0.f;
    for (int r = r0 + tid; r < r1; r += kThreads) s = fmaf(y[r], w[r], s);
    yw = block_sum(s, red, tid);
  }
  __syncthreads();  // colsum complete
  if (ty != 0) return;

  float a = 0.f;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) a += colsum[q][tx];
  if (!kFused) {
    if (j < p) a_part[(int64_t)k * p + j] = a;
    if (blockIdx.x == 0 && tx == 0) yw_part[k] = yw;
    return;
  }
  float term = 0.f;
  if (j < p) term = epilogue(a, yw * invt, j, o);
  term = warp_sum(term);  // warp 0 is exactly the ty == 0 row
  if (tx == 0) o.loss_part[blockIdx.x] = C * term;
}

// grid ceil(p / kThreads), one thread per column: the fixed-order sums over
// the chunks, then the epilogue.
__global__ void __launch_bounds__(kThreads)
stats_finish(const float* __restrict__ a_part, const float* __restrict__ yw_part,
             int nchunk, int p, Out o, float invt, float C) {
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int k = tid; k < nchunk; k += kThreads) s += yw_part[k];
  const float byw = block_sum(s, red, tid) * invt;
  const int j = blockIdx.x * kThreads + tid;
  float term = 0.f;
  if (j < p) {
    float a = 0.f;
    for (int k = 0; k < nchunk; ++k) a += a_part[(int64_t)k * p + j];
    term = epilogue(a, byw, j, o);
  }
  term = block_sum(term, red, tid);
  if (tid == 0) o.loss_part[blockIdx.x] = C * term;
}

template <typename T>
cudaError_t launch(const void* Xv, const float* w, const float* y, int n, int p,
                   int rows_per_chunk, int nchunk, float* a_part, float* yw_part,
                   Out o, float invt, float C, cudaStream_t s) {
  const T* X = static_cast<const T*>(Xv);
  const dim3 block(kCols, kWarps);
  const int colblocks = (p + kCols - 1) / kCols;
  if (nchunk == 1) {
    stats_partial<T, true><<<dim3(colblocks, 1), block, 0, s>>>(
        X, w, y, n, p, n, nullptr, nullptr, o, invt, C);
    return cudaGetLastError();
  }
  stats_partial<T, false><<<dim3(colblocks, nchunk), block, 0, s>>>(
      X, w, y, n, p, rows_per_chunk, a_part, yw_part, o, invt, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finish<<<(p + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      a_part, yw_part, nchunk, p, o, invt, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns per block of the partial sums, and the number of loss partials a
// launch with `nchunk` row chunks writes.
int sven_hinge_stats_cols() { return kCols; }
int sven_hinge_stats_loss_parts(int p, int nchunk) {
  return nchunk == 1 ? (p + kCols - 1) / kCols : (p + kThreads - 1) / kThreads;
}

// X (n, p) row-major, float32 (bf16 = 0) or bfloat16 (bf16 = 1); w, y (n,)
// float32 in. Rows are cut into nchunk chunks of rows_per_chunk (the last may
// be short); with nchunk > 1, a_part (nchunk, p) and yw_part (nchunk,) are
// float32 scratch. mt, mb, gt, gb (p,) and loss_part
// (sven_hinge_stats_loss_parts(p, nchunk),) float32 out. Returns the first
// CUDA error of the launches (0 = none).
int sven_hinge_stats(const void* X, int bf16, const float* w, const float* y, int n,
                     int p, int rows_per_chunk, int nchunk, float* a_part,
                     float* yw_part, float* mt, float* mb, float* gt, float* gb,
                     float* loss_part, float invt, float C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Out o{mt, mb, gt, gb, loss_part};
  return bf16 ? launch<__nv_bfloat16>(X, w, y, n, p, rows_per_chunk, nchunk, a_part,
                                      yw_part, o, invt, C, s)
              : launch<float>(X, w, y, n, p, rows_per_chunk, nchunk, a_part, yw_part,
                              o, invt, C, s);
}

}  // extern "C"

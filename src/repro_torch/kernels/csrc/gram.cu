// Fused shifted Gram of the SVEN dual, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::_gram_kernel (and its
// Pallas-Triton twin repro/kernels/gram_gpu.py::_gram_gpu_kernel). It computes
// K = Zhat^T Zhat (2p x 2p) of the paper's dual (eq. 3) from the original
// (n, p) X without building Zhat, through the block identity
//
//     K[a,b][i,j] = s_a s_b (X^T X)_ij - s_a u_i - s_b u_j + s,
//     u = X^T y / t,  s = y^T y / t^2,  s_0 = +1, s_1 = -1.
//
// What bounds it: A^T A of the augmented A = [X, y] (below) is symmetric, so
// the function needs its (p+1)(p+2)/2 distinct entries, n multiply-adds each:
// n (p+1)(p+2) FLOPs against n (p+1) reads. At the YMSD shape (n = 463,715,
// p = 90) that is 3.9 GFLOP over 167 MB (f32), so the f32 kernel is bound by
// the card's fp32 FMA rate, not by memory.
//
// Design. The TPU kernel carries its sums across a sequential k grid axis in
// VMEM scratch; CUDA blocks run in no order, so the sum over n is split
// instead:
//   1. gram_partial: y is treated as column p of an augmented (n, p+1)
//      matrix A = [X, y], so P = X^T X, X^T y and y^T y are all entries of
//      A^T A. Block (ti, tj, k) sums a 64 x 64 tile of A^T A over its own chunk
//      of rows, in registers (4 x 4 per thread, operands staged through
//      shared memory), and writes it to part[k]. Only tiles with tj >= ti run
//      (A^T A is symmetric). The row split gives the card enough blocks even
//      when p is small (p = 90 has only 3 such tiles).
//   2. gram_epilogue: one block per row i of P sums the partials of the
//      entries it reads (P_ij, u_i, u_j, s) over k in a fixed order
//      (deterministic: no float atomics), then writes the four quadrants, so
//      the epilogue runs only after the full sum.
// Ragged edges are masked, never padded. Precision modes: 0 = f32 (true fp32
// FMA; TF32 is not used), 1 = tf32 (operands rounded with cvt.rna.tf32.f32,
// fp32 accumulation), 2 = bf16 storage of X and y, fp32 accumulation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kRows = 16;     // rows staged per shared-memory step
constexpr int kMicro = 4;     // per-thread micro tile edge
constexpr int kThreads = 256; // (kTile / kMicro)^2

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xFFFFE000u);
}

template <typename T> __device__ __forceinline__ float ld(const T* p, int64_t i);
template <> __device__ __forceinline__ float ld<float>(const float* p, int64_t i) {
  return p[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                               int64_t i) {
  return __bfloat162float(p[i]);
}

// Entry (r, c) of A = [X, y]; 0 past the last column.
template <typename T, bool TF32>
__device__ __forceinline__ float aug(const T* X, const T* y, int64_t r, int c, int p) {
  float v = 0.f;
  if (c < p) v = ld<T>(X, r * p + c);
  else if (c == p) v = ld<T>(y, r);
  return TF32 ? to_tf32(v) : v;
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(kThreads)
gram_partial(const T* __restrict__ X, const T* __restrict__ y,
             float* __restrict__ part, int n, int p, int rows_per_split) {
  const int ti = blockIdx.x, tj = blockIdx.y, ks = blockIdx.z;
  if (tj < ti) return;  // symmetric: the lower tiles are never read
  const int q = p + 1;
  const int r0 = ks * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int tx = threadIdx.x % (kTile / kMicro);
  const int ty = threadIdx.x / (kTile / kMicro);

  __shared__ __align__(16) float As[kRows][kTile];
  __shared__ __align__(16) float Bs[kRows][kTile];
  float acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;

  for (int rb = r0; rb < r1; rb += kRows) {
    // neighbouring threads load neighbouring columns of one row: coalesced
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile, cc = e % kTile;
      const int64_t r = rb + rr;
      const bool in = r < r1;
      As[rr][cc] = in ? aug<T, TF32>(X, y, r, ti * kTile + cc, p) : 0.f;
      Bs[rr][cc] = in ? aug<T, TF32>(X, y, r, tj * kTile + cc, p) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * kMicro]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * kMicro]);
      const float a[kMicro] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kMicro] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (int64_t)ks * q * q;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gi = ti * kTile + ty * kMicro + i;
    if (gi >= q) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gj = tj * kTile + tx * kMicro + j;
      if (gj < q) out[(int64_t)gi * q + gj] = acc[i][j];
    }
  }
}

// sum_k part[k][idx], in the order k = 0, 1, ...
__device__ __forceinline__ float sum_parts(const float* __restrict__ part, int64_t idx,
                                           int64_t qq, int nsplit) {
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(int64_t)k * qq + idx];
  return s;
}

// The four quadrants of row i (block i). flat: K is (2p, 2p); else block
// layout (2, 2, p, p).
__global__ void gram_epilogue(const float* __restrict__ part, float* __restrict__ K,
                              int p, int nsplit, float invt, int flat) {
  const int i = blockIdx.x;
  const int q = p + 1;
  const int64_t qq = (int64_t)q * q;
  __shared__ float ui_s[2];  // X_i^T y and y^T y
  if (threadIdx.x < 2)
    ui_s[threadIdx.x] = sum_parts(part, threadIdx.x == 0 ? (int64_t)i * q + p
                                                         : (int64_t)p * q + p, qq, nsplit);
  __syncthreads();
  const float a = ui_s[0] * invt;
  const float s = ui_s[1] * invt * invt;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const float P = sum_parts(part, (int64_t)min(i, j) * q + max(i, j), qq, nsplit);
    const float b = sum_parts(part, (int64_t)j * q + p, qq, nsplit) * invt;
    const float v[2][2] = {{P - a - b + s, -P - a + b + s},
                           {-P + a - b + s, P + a + b + s}};
    for (int qa = 0; qa < 2; ++qa)
      for (int qb = 0; qb < 2; ++qb) {
        const int64_t o = flat ? ((int64_t)qa * p + i) * (2 * p) + (int64_t)qb * p + j
                               : (((int64_t)qa * 2 + qb) * p + i) * p + j;
        K[o] = v[qa][qb];
      }
  }
}

template <typename T, bool TF32>
cudaError_t launch_all(const void* X, const void* y, float* part, float* K, int n, int p,
                       int rows_per_split, int nsplit, float invt, int flat,
                       cudaStream_t stream) {
  const int q = p + 1;
  const int nt = (q + kTile - 1) / kTile;
  gram_partial<T, TF32><<<dim3(nt, nt, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(y), part, n, p, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_epilogue<<<p, 128, 0, stream>>>(part, K, p, nsplit, invt, flat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of each split and the tile edge the Python wrapper sizes `part` by.
int sven_gram_tile() { return kTile; }
int sven_gram_rows_step() { return kRows; }

// X (n, p) and y (n,) row-major, float32 (mode 0, 1) or bfloat16 (mode 2);
// part (nsplit, p+1, p+1) and K float32 scratch/output from the caller.
// Returns the first CUDA error of the two launches (0 = none).
int sven_gram(const void* X, const void* y, float* part, float* K, int n, int p,
              int rows_per_split, int nsplit, float invt, int flat, int mode,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_all<float, false>(X, y, part, K, n, p, rows_per_split, nsplit,
                                       invt, flat, s);
    case 1:
      return launch_all<float, true>(X, y, part, K, n, p, rows_per_split, nsplit,
                                      invt, flat, s);
    case 2:
      return launch_all<__nv_bfloat16, false>(X, y, part, K, n, p, rows_per_split,
                                               nsplit, invt, flat, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

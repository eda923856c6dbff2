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
// fp32 accumulation), 2 = bf16 storage of X and y, fp32 accumulation,
// 3 = f64: float64 X and y, and float64 throughout (loads, shared tiles,
// accumulators, partials, epilogue and K), with FP64 FMAs (not the FP64
// tensor cores). Mode 3 is what a float64 problem runs at precision "f32", so
// that K is the problem's own float64 Gram. Its bound at the YMSD shape:
// bytes 463,715 x 91 x 8 = 337.6 MB / 3.35 TB/s = 0.101 ms; operations
// n (p+1)(p+2) = 3.88 GFLOP / 67 TFLOP/s (FP64 tensor peak) = 0.058 ms; so
// bytes bound it. The tiles hold doubles: 16 KB of shared memory per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The type every product and sum of a mode is taken in: float, except for
// float64 storage, which is summed in double.
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <typename T> using acc_t = typename AccOf<T>::type;

template <typename T> __device__ __forceinline__ acc_t<T> ld(const T* p, int64_t i) {
  return p[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p,
                                                               int64_t i) {
  return __bfloat162float(p[i]);
}

// Entry (r, c) of A = [X, y]; 0 past the last column.
template <typename T, bool TF32>
__device__ __forceinline__ acc_t<T> aug(const T* X, const T* y, int64_t r, int c, int p) {
  acc_t<T> v = 0;
  if (c < p) v = ld<T>(X, r * p + c);
  else if (c == p) v = ld<T>(y, r);
  if constexpr (TF32) v = to_tf32(v);
  return v;
}

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

// Four neighbouring shared-memory entries: one float4, or two double2.
__device__ __forceinline__ void ld4(const float* s, float (&a)[kMicro]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* s, double (&a)[kMicro]) {
  const double2 v0 = *reinterpret_cast<const double2*>(s);
  const double2 v1 = *reinterpret_cast<const double2*>(s + 2);
  a[0] = v0.x; a[1] = v0.y; a[2] = v1.x; a[3] = v1.y;
}

template <typename T, bool TF32>
__global__ void __launch_bounds__(kThreads)
gram_partial(const T* __restrict__ X, const T* __restrict__ y,
             acc_t<T>* __restrict__ part, int n, int p, int rows_per_split) {
  using A = acc_t<T>;
  const int ti = blockIdx.x, tj = blockIdx.y, ks = blockIdx.z;
  if (tj < ti) return;  // symmetric: the lower tiles are never read
  const int q = p + 1;
  const int r0 = ks * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int tx = threadIdx.x % (kTile / kMicro);
  const int ty = threadIdx.x / (kTile / kMicro);

  __shared__ __align__(16) A As[kRows][kTile];
  __shared__ __align__(16) A Bs[kRows][kTile];
  A acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0;

  for (int rb = r0; rb < r1; rb += kRows) {
    // neighbouring threads load neighbouring columns of one row: coalesced
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int rr = e / kTile, cc = e % kTile;
      const int64_t r = rb + rr;
      const bool in = r < r1;
      As[rr][cc] = in ? aug<T, TF32>(X, y, r, ti * kTile + cc, p) : A(0);
      Bs[rr][cc] = in ? aug<T, TF32>(X, y, r, tj * kTile + cc, p) : A(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRows; ++kk) {
      A a[kMicro], b[kMicro];
      ld4(&As[kk][ty * kMicro], a);
      ld4(&Bs[kk][tx * kMicro], b);
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  A* out = part + (int64_t)ks * q * q;
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
template <typename A>
__device__ __forceinline__ A sum_parts(const A* __restrict__ part, int64_t idx,
                                       int64_t qq, int nsplit) {
  A s = 0;
  for (int k = 0; k < nsplit; ++k) s += part[(int64_t)k * qq + idx];
  return s;
}

// The four quadrants of row i (block i). flat: K is (2p, 2p); else block
// layout (2, 2, p, p). `scale` is 1/t rounded to float in the f32 modes,
// which multiply by it, and t in f64, which divides by it as the plain
// version does.
template <typename A>
__global__ void gram_epilogue(const A* __restrict__ part, A* __restrict__ K, int p,
                              int nsplit, A scale, int flat) {
  constexpr bool kF64 = std::is_same<A, double>::value;
  const int i = blockIdx.x;
  const int q = p + 1;
  const int64_t qq = (int64_t)q * q;
  auto over_t = [&](A x) -> A {
    if constexpr (kF64) return x / scale;
    else return x * scale;
  };
  __shared__ A ui_s[2];  // X_i^T y and y^T y
  if (threadIdx.x < 2)
    ui_s[threadIdx.x] = sum_parts(part, threadIdx.x == 0 ? (int64_t)i * q + p
                                                         : (int64_t)p * q + p, qq, nsplit);
  __syncthreads();
  const A a = over_t(ui_s[0]);
  A s;
  if constexpr (kF64) s = ui_s[1] / (scale * scale);
  else s = ui_s[1] * scale * scale;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const A P = sum_parts(part, (int64_t)min(i, j) * q + max(i, j), qq, nsplit);
    const A b = over_t(sum_parts(part, (int64_t)j * q + p, qq, nsplit));
    const A v[2][2] = {{P - a - b + s, -P - a + b + s},
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
cudaError_t launch_all(const void* X, const void* y, void* part, void* K, int n, int p,
                       int rows_per_split, int nsplit, double t, int flat,
                       cudaStream_t stream) {
  using A = acc_t<T>;
  const int q = p + 1;
  const int nt = (q + kTile - 1) / kTile;
  gram_partial<T, TF32><<<dim3(nt, nt, nsplit), kThreads, 0, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(y), static_cast<A*>(part), n, p,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const A scale = std::is_same<A, double>::value ? A(t) : A(1.0 / t);
  gram_epilogue<A><<<p, 128, 0, stream>>>(static_cast<const A*>(part),
                                          static_cast<A*>(K), p, nsplit, scale, flat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of each split and the tile edge the Python wrapper sizes `part` by.
int sven_gram_tile() { return kTile; }
int sven_gram_rows_step() { return kRows; }

// X (n, p) and y (n,) row-major, float32 (mode 0, 1), bfloat16 (mode 2) or
// float64 (mode 3); part (nsplit, p+1, p+1) scratch and K from the caller,
// float64 in mode 3 and float32 otherwise. Returns the first CUDA error of
// the two launches (0 = none).
int sven_gram(const void* X, const void* y, void* part, void* K, int n, int p,
              int rows_per_split, int nsplit, double t, int flat, int mode,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_all<float, false>(X, y, part, K, n, p, rows_per_split, nsplit, t,
                                       flat, s);
    case 1:
      return launch_all<float, true>(X, y, part, K, n, p, rows_per_split, nsplit, t,
                                      flat, s);
    case 2:
      return launch_all<__nv_bfloat16, false>(X, y, part, K, n, p, rows_per_split,
                                               nsplit, t, flat, s);
    case 3:
      return launch_all<double, false>(X, y, part, K, n, p, rows_per_split, nsplit, t,
                                        flat, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

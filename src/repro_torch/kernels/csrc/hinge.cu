// Squared-hinge Hessian mat-vec of primal Newton-CG, for Hopper (sm_90a):
//
//     H v = v + 2C ( X d + (y/t) e ),
//     d = act_top (c - byv) + act_bot (c + byv),  c = X^T v,  byv = y.v / t,
//     e = sum(act_bot (c + byv)) - sum(act_top (c - byv)).
//
// Two passes, as on the TPU: pass 2 needs all of d and e.
//
// Pass 1, hinge_xtv, replaces repro/kernels/hinge.py::_xtv_kernel. It is a
// reduction over the n rows for each of the p columns of a row-major X.
// Bound: one read of X (n p elements); at the GLA-BRA-180 shape (n = 180,
// p = 49,151) that is 35 MB in f32, which fits in the 50 MB L2. Design:
// threadIdx.x maps to columns, so a warp reads 32 neighbouring addresses of
// one row; the 8 warps of a block split the rows and meet in shared memory,
// which gives p/32 blocks (1,536 at that shape) instead of p/256. byv is
// recomputed by every block, as the TPU kernel does (n is small on the primal
// path). e is written as one partial per block and summed in a fixed order by
// pass 2: no float atomics.
//
// Pass 2, hinge_xd, replaces repro/kernels/hinge.py::_xd_kernel. It is a dot
// product over p for each row. Bound: one read of X again. Design: one warp
// per row for narrow X; for p >= 1024 all 8 warps of a block share one row
// (n = 180 rows would give only 180 warps on 132 SMs otherwise). Lanes read
// neighbouring addresses, four independent accumulators per lane hide load
// latency, and a warp-shuffle reduction ends the row.
//
// X is float32 or bfloat16 storage; everything else is float32 and every sum
// is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Sum over the block of one value per thread, in a fixed order; every thread
// gets the result. `tid` is the flat thread id; `red` holds kWarps floats.
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

// ---------------------------------------------------------------- pass 1 ---
// block (32, 8): threadIdx.x = column within the block's 32, threadIdx.y =
// row phase.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hinge_xtv(const T* __restrict__ X, const float* __restrict__ v,
          const float* __restrict__ y, const float* __restrict__ at,
          const float* __restrict__ ab, float* __restrict__ d,
          float* __restrict__ e_part, int n, int p, float invt) {
  __shared__ float red[kWarps];
  __shared__ float colsum[kWarps][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 32 + tx;

  float s = 0.f;
  for (int r = tid; r < n; r += kThreads) s = fmaf(y[r], v[r], s);
  const float byv = block_sum(s, red, tid) * invt;

  const int j = blockIdx.x * 32 + tx;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if (j < p) {
    int r = ty;
    for (; r + 3 * kWarps < n; r += 4 * kWarps) {
      c0 = fmaf(ld<T>(X, (int64_t)r * p + j), v[r], c0);
      c1 = fmaf(ld<T>(X, (int64_t)(r + kWarps) * p + j), v[r + kWarps], c1);
      c2 = fmaf(ld<T>(X, (int64_t)(r + 2 * kWarps) * p + j), v[r + 2 * kWarps], c2);
      c3 = fmaf(ld<T>(X, (int64_t)(r + 3 * kWarps) * p + j), v[r + 3 * kWarps], c3);
    }
    for (; r < n; r += kWarps) c0 = fmaf(ld<T>(X, (int64_t)r * p + j), v[r], c0);
  }
  colsum[ty][tx] = (c0 + c1) + (c2 + c3);
  __syncthreads();
  if (ty == 0) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += colsum[w][tx];
    float contrib = 0.f;
    if (j < p) {
      const float ut = at[j] * (c - byv);
      const float ub = ab[j] * (c + byv);
      d[j] = ut + ub;
      contrib = ub - ut;
    }
    contrib = warp_sum(contrib);  // warp 0 is exactly the ty == 0 row
    if (tx == 0) e_part[blockIdx.x] = contrib;
  }
}

// ---------------------------------------------------------------- pass 2 ---
// WPR warps per row; kWarps / WPR rows per block.
template <typename T, int WPR>
__global__ void __launch_bounds__(kThreads)
hinge_xd(const T* __restrict__ X, const float* __restrict__ d,
         const float* __restrict__ e_part, int n_epart, const float* __restrict__ y,
         const float* __restrict__ v, float* __restrict__ hv, int n, int p, float invt,
         float twoC) {
  __shared__ float red[kWarps];
  __shared__ float rowpart[kWarps];
  float es = 0.f;
  for (int i = threadIdx.x; i < n_epart; i += kThreads) es += e_part[i];
  const float e = block_sum(es, red, threadIdx.x);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = blockIdx.x * (kWarps / WPR) + warp / WPR;
  const int sub = warp % WPR;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (row < n) {
    const int64_t base = (int64_t)row * p;
    const int stride = 32 * WPR;
    int j = sub * 32 + lane;
    for (; j + 3 * stride < p; j += 4 * stride) {
      a0 = fmaf(ld<T>(X, base + j), d[j], a0);
      a1 = fmaf(ld<T>(X, base + j + stride), d[j + stride], a1);
      a2 = fmaf(ld<T>(X, base + j + 2 * stride), d[j + 2 * stride], a2);
      a3 = fmaf(ld<T>(X, base + j + 3 * stride), d[j + 3 * stride], a3);
    }
    for (; j < p; j += stride) a0 = fmaf(ld<T>(X, base + j), d[j], a0);
  }
  const float acc = warp_sum((a0 + a1) + (a2 + a3));
  if (lane == 0) rowpart[warp] = acc;
  __syncthreads();
  if (sub == 0 && lane == 0 && row < n) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) tot += rowpart[warp + w];
    hv[row] = v[row] + twoC * (tot + y[row] * invt * e);
  }
}

template <typename T>
cudaError_t launch_xtv(const void* X, const float* v, const float* y, const float* at,
                       const float* ab, float* d, float* e_part, int n, int p,
                       float invt, cudaStream_t s) {
  hinge_xtv<T><<<(p + 31) / 32, dim3(32, kWarps), 0, s>>>(
      static_cast<const T*>(X), v, y, at, ab, d, e_part, n, p, invt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_xd(const void* X, const float* d, const float* e_part, int n_epart,
                      const float* y, const float* v, float* hv, int n, int p,
                      float invt, float twoC, cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  if (p >= 1024) {
    hinge_xd<T, kWarps><<<n, kThreads, 0, s>>>(Xt, d, e_part, n_epart, y, v, hv, n, p,
                                               invt, twoC);
  } else {
    hinge_xd<T, 1><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        Xt, d, e_part, n_epart, y, v, hv, n, p, invt, twoC);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of e partials pass 1 writes (one per block of 32 columns).
int sven_hinge_xtv_blocks(int p) { return (p + 31) / 32; }

// X (n, p) row-major, float32 (bf16 = 0) or bfloat16 (bf16 = 1); v, y (n,),
// at, ab (p,) float32 in; d (p,) and e_part (sven_hinge_xtv_blocks(p),)
// float32 out. Returns the CUDA error of the launch (0 = none).
int sven_hinge_xtv(const void* X, int bf16, const float* v, const float* y,
                   const float* at, const float* ab, float* d, float* e_part, int n,
                   int p, float invt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_xtv<__nv_bfloat16>(X, v, y, at, ab, d, e_part, n, p, invt, s)
              : launch_xtv<float>(X, v, y, at, ab, d, e_part, n, p, invt, s);
}

// X as above; d (p,), e_part (n_epart,), y, v (n,) float32 in; hv (n,) out.
int sven_hinge_xd(const void* X, int bf16, const float* d, const float* e_part,
                  int n_epart, const float* y, const float* v, float* hv, int n, int p,
                  float invt, float twoC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_xd<__nv_bfloat16>(X, d, e_part, n_epart, y, v, hv, n, p, invt,
                                         twoC, s)
              : launch_xd<float>(X, d, e_part, n_epart, y, v, hv, n, p, invt, twoC, s);
}

}  // extern "C"

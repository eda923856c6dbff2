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
// product over p for each row. Bound: one read of X again (10.6 us in f32 at
// the GLA-BRA-180 shape). Design: a 2-D grid of (row group x column chunk).
// A block of 256 threads takes R rows and one chunk of up to 4,096 columns:
// it stages its chunk of d in shared memory once (16 KB f32, with one pad
// word every 32, so that a warp's reads of d meet at most 2-way bank
// conflicts, against 4-way (f32) or 8-way (bf16) without) and reuses it for
// its R rows. At GLA-BRA-180 (R = 4) that is 45 x 12 = 540 blocks, about 4
// per SM (one block per row would give 180 on 132 SMs). X is read in 16-byte
// vectors (4 f32 or 8 bf16), with a scalar head and tail per row: p is odd
// there, so most rows do not start on a 16-byte boundary, and the head is
// taken from each row's own address. Each (row, chunk) writes one partial;
// the last block of a row group to finish, found by an integer atomicAdd
// ticket, sums the partials of its rows in chunk order, adds the e term and
// writes H v, then sets the ticket back to 0 for the next launch. So it is
// one launch, deterministic, with no float atomics. For p < 1024 a block
// takes R = 8 rows, one warp per row, in one chunk, and writes H v itself.
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
constexpr int kChunk = 4096;                    // columns of d per block
constexpr int kChunkPad = kChunk + kChunk / 32;  // one pad word every 32
constexpr int kWideP = 1024;                    // from here, R = 4 and chunks

// Shared-memory slot of column i of the chunk: one pad word every 32, for
// the reads of 4 (f32) or 8 (bf16) neighbouring columns per lane.
__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// A 16-byte vector of X: 4 floats, or 8 bf16 in a uint4.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

// acc + the vector x times columns i .. i+n-1 of the staged d.
__device__ __forceinline__ float vdot(const float4& x, const float* ds, int i, float acc) {
  acc = fmaf(x.x, ds[slot(i)], acc);
  acc = fmaf(x.y, ds[slot(i + 1)], acc);
  acc = fmaf(x.z, ds[slot(i + 2)], acc);
  return fmaf(x.w, ds[slot(i + 3)], acc);
}
__device__ __forceinline__ float vdot(const uint4& x, const float* ds, int i, float acc) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc = fmaf(f.x, ds[slot(i + 2 * k)], acc);
    acc = fmaf(f.y, ds[slot(i + 2 * k + 1)], acc);
  }
  return acc;
}

// grid (ceil(n / R), chunks); R rows of one chunk per block, 256 / R threads
// per row. With more than one chunk, part (n, chunks) holds the partials and
// ticket (ceil(n / R),) counts the finished chunks of each row group; it is
// 0 before the launch and 0 again after it.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
hinge_xd(const T* __restrict__ X, const float* __restrict__ d,
         const float* __restrict__ e_part, int n_epart, const float* __restrict__ y,
         const float* __restrict__ v, float* __restrict__ hv, float* __restrict__ part,
         int* __restrict__ ticket, int n, int p, float invt, float twoC) {
  constexpr int TPR = kThreads / R;   // threads per row
  constexpr int WPR = TPR / 32;       // warps per row
  constexpr int VEC = Vec<T>::n;
  using VT = typename Vec<T>::type;
  __shared__ float ds[kChunkPad];
  __shared__ float red[kWarps];
  __shared__ float wsum[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nchunk = gridDim.y;
  const int j0 = blockIdx.y * kChunk;
  const int len = min(kChunk, p - j0);
  for (int i = tid; i < len; i += kThreads) ds[slot(i)] = d[j0 + i];
  __syncthreads();

  const int lt = tid % TPR;
  const int row = blockIdx.x * R + tid / TPR;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (row < n) {
    const T* xr = X + (int64_t)row * p + j0;
    // columns before the first 16-byte boundary of this row's chunk
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) & 15u);
    const int head = min(len, ((16 - mis) & 15) / (int)sizeof(T));
    if (lt < head) a0 = ld<T>(xr, lt) * ds[slot(lt)];   // head < VEC <= TPR
    const int nv = (len - head) / VEC;
    const VT* xv = reinterpret_cast<const VT*>(xr + head);
    int k = lt;
    for (; k + 3 * TPR < nv; k += 4 * TPR) {
      const VT x0 = __ldg(xv + k), x1 = __ldg(xv + k + TPR);
      const VT x2 = __ldg(xv + k + 2 * TPR), x3 = __ldg(xv + k + 3 * TPR);
      a0 = vdot(x0, ds, head + k * VEC, a0);
      a1 = vdot(x1, ds, head + (k + TPR) * VEC, a1);
      a2 = vdot(x2, ds, head + (k + 2 * TPR) * VEC, a2);
      a3 = vdot(x3, ds, head + (k + 3 * TPR) * VEC, a3);
    }
    for (; k < nv; k += TPR) a0 = vdot(__ldg(xv + k), ds, head + k * VEC, a0);
    const int tail = head + nv * VEC + lt;              // fewer than VEC left
    if (tail < len) a1 = fmaf(ld<T>(xr, tail), ds[slot(tail)], a1);
  }
  const float acc = warp_sum((a0 + a1) + (a2 + a3));
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();

  // thread r < R owns row r of the block from here on
  const int mine_row = blockIdx.x * R + tid;
  const bool owner = tid < R && mine_row < n;
  float dot = 0.f;
  if (tid < R) {
#pragma unroll
    for (int w = 0; w < WPR; ++w) dot += wsum[tid * WPR + w];
  }
  if (nchunk > 1) {
    if (owner) {
      part[(int64_t)mine_row * nchunk + blockIdx.y] = dot;
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) last = atomicAdd(&ticket[blockIdx.x], 1) == nchunk - 1;
    __syncthreads();
    if (!last) return;                 // block-uniform
    __threadfence();
    if (owner) {
      dot = 0.f;
      for (int c = 0; c < nchunk; ++c) dot += __ldcg(&part[(int64_t)mine_row * nchunk + c]);
    }
    if (tid == 0) ticket[blockIdx.x] = 0;   // every block of the group has counted
  }
  float es = 0.f;
  for (int i = tid; i < n_epart; i += kThreads) es += e_part[i];
  const float e = block_sum(es, red, tid);
  if (owner) hv[mine_row] = v[mine_row] + twoC * (dot + y[mine_row] * invt * e);
}

// Rows per block and column chunks of pass 2 for a row length p.
__host__ __device__ inline int xd_rows(int p) { return p >= kWideP ? 4 : 8; }
__host__ __device__ inline int xd_chunks(int p) {
  return p >= kWideP ? (p + kChunk - 1) / kChunk : 1;
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
                      const float* y, const float* v, float* hv, float* part,
                      int* ticket, int n, int p, float invt, float twoC, cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  const int R = xd_rows(p);
  const dim3 grid((n + R - 1) / R, xd_chunks(p));
  if (R == 4) {
    hinge_xd<T, 4><<<grid, kThreads, 0, s>>>(Xt, d, e_part, n_epart, y, v, hv, part,
                                             ticket, n, p, invt, twoC);
  } else {
    hinge_xd<T, 8><<<grid, kThreads, 0, s>>>(Xt, d, e_part, n_epart, y, v, hv, part,
                                             ticket, n, p, invt, twoC);
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

// Rows per row group and column chunks of pass 2 (the wrapper sizes part as
// (n, chunks) and ticket as (ceil(n / rows),) from these).
int sven_hinge_xd_rows(int p) { return xd_rows(p); }
int sven_hinge_xd_chunks(int p) { return xd_chunks(p); }

// X as above; d (p,), e_part (n_epart,), y, v (n,) float32 in; hv (n,) out.
// With more than one chunk: part (n, chunks) float32 scratch, and ticket
// (ceil(n / rows),) int32, all 0 on entry and left 0 (else both may be null).
// One launch on `stream`; launches that share a ticket buffer must be
// ordered (one stream).
int sven_hinge_xd(const void* X, int bf16, const float* d, const float* e_part,
                  int n_epart, const float* y, const float* v, float* hv, float* part,
                  int* ticket, int n, int p, float invt, float twoC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_xd<__nv_bfloat16>(X, d, e_part, n_epart, y, v, hv, part, ticket,
                                         n, p, invt, twoC, s)
              : launch_xd<float>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p,
                                 invt, twoC, s);
}

}  // extern "C"

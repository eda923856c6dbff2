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
// p = 49,151) that is 35 MB in f32 (10.7 us at 3.35 TB/s), which fits in the
// 50 MB L2, and 70.8 MB in f64 (21.1 us), which does not. Design: lanes map
// to neighbouring columns, so a warp reads a contiguous piece of one row;
// the 8 warps of a block split the rows and meet in shared memory. Three
// choices serve the bound. The loads of X are the first thing a block
// issues: byv, which only the epilogue needs, is summed after them. Each
// thread takes 4 columns 32 apart, 128 columns per block: at that shape 384
// blocks, one wave of resident blocks (32 columns per block gave 1,536
// blocks, 1.45 waves). Each step of a thread's row loop issues 64 bytes of
// loads (16 f32 or bf16, 8 f64) before its first FMA. p is odd there, so rows
// are not 16-byte aligned and each lane reads one element per row; TMA needs
// row strides that are multiples of 16 bytes, which 4 p and 8 p are not. byv
// is recomputed by every block, as the TPU kernel does (n is small on the
// primal path). e is written as one partial per block and summed in a fixed
// order by pass 2: no float atomics.
//
// Pass 2, hinge_xd, replaces repro/kernels/hinge.py::_xd_kernel. It is a dot
// product over p for each row. Bound: one read of X again (10.6 us in f32 at
// the GLA-BRA-180 shape). Design: a 2-D grid of (row group x column chunk).
// A block of 256 threads takes R rows and one chunk of up to 4,096 columns:
// it stages its chunk of d in shared memory once (16 KB f32 or 32 KB f64,
// padded so that a warp's reads of d meet few bank conflicts: see `slot`)
// and reuses it for its R rows. At GLA-BRA-180 (R = 4) that is 45 x 12 = 540
// blocks, about 4 per SM (one block per row would give 180 on 132 SMs). X is
// read in 16-byte vectors (4 f32, 8 bf16 or 2 f64), with a scalar head and
// tail per row: p is odd there, so most rows do not start on a 16-byte
// boundary, and the head is taken from each row's own address. Each (row, chunk) writes one partial;
// the last block of a row group to finish, found by an integer atomicAdd
// ticket, sums the partials of its rows in chunk order, adds the e term and
// writes H v, then sets the ticket back to 0 for the next launch. So it is
// one launch, deterministic, with no float atomics. For p < 1024 a block
// takes R = 8 rows, one warp per row, in one chunk, and writes H v itself.
//
// Modes: X float32 or bfloat16 storage, with everything else float32 and
// every sum float32; or X float64, with everything else float64 (v, y, act,
// d, the e partials, pass 2's partials, H v) and every sum float64, taken
// with FP64 FMAs. The float64 mode is what a float64 problem runs at
// precision "f32", so that H v is the problem's own float64 product. Both
// passes are templates on the storage type and share one layout across the
// modes; at the GLA-BRA-180 shape X is 70.8 MB in float64, larger than the
// L2, so each pass then reads HBM: 21.1 us each at 3.35 TB/s.
//
// Lanes: both passes also launch once for a stack of B problems (the
// lane-batched solve of core/batch.py), the port of the leading grid axis
// that JAX's vmap gives the Pallas kernels. The lane is blockIdx.z; each
// block offsets its pointers by its lane (X by 0 when the lanes share it,
// else by n p; y by 0 or n) and reads its lane's 1/t and 2C from device
// arrays. Inside a lane the blocks, the layout and the order of every sum
// are the single launch's, so a lane's results are bitwise those of a
// single launch on that lane's operands (at the same addresses: pass 2
// splits a row at its own 16-byte boundary). The lane forms are separate
// instantiations (kLanes), so the single launch's code is unchanged. Bound
// of a lane-batched pass: B reads of X when the lanes stack X, but one
// read when they share it, which this simple form does not reach: each
// lane's blocks read the shared X again (from the L2 where it fits).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

template <typename A> __device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block of one value per thread, in a fixed order; every thread
// gets the result. `tid` is the flat thread id; `red` holds kWarps values.
template <typename A> __device__ __forceinline__ A block_sum(A v, A* red, int tid) {
  const int lane = tid % 32, warp = tid / 32;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  A s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// The lane operands of a lane-batched launch (kLanes): the elements
// between two lanes' X (0: shared, or n p) and y (0 or n), and each lane's
// 1/t and 2C (B,) in the summing type. Every other operand is stacked
// densely by lane.
template <typename A> struct Lanes {
  int64_t x_stride;
  int64_t y_stride;
  const A* invt;
  const A* twoC;
};

// ---------------------------------------------------------------- pass 1 ---
// Loads of X each thread keeps in flight in one step of its row loop: 64
// bytes of f32 or f64, 32 of bf16.
template <typename A> struct InFlight { static constexpr int loads = 16; };
template <> struct InFlight<double> { static constexpr int loads = 8; };

constexpr int CPT = 4;              // columns per thread of pass 1
constexpr int kCols = 32 * CPT;     // columns per block of pass 1

// 256 threads = 8 warps. Lane l of warp w owns columns j0 + l + 32 k
// (k < CPT) of the block's kCols columns, and rows w, w + 8, w + 16, ...
// A step of its row loop issues U x CPT loads (U rows), each a warp-wide
// 128-byte (f32) or 256-byte (f64) read of one row, before its first FMA.
// Every column is summed over its rows in row order within a warp and over
// the warps in warp order. With kLanes, blockIdx.z is the lane.
template <typename T, bool kLanes, typename A = acc_t<T>>
__global__ void __launch_bounds__(kThreads, 4)
hinge_xtv(const T* __restrict__ X, const A* __restrict__ v,
          const A* __restrict__ y, const A* __restrict__ at,
          const A* __restrict__ ab, A* __restrict__ d,
          A* __restrict__ e_part, int n, int p, A invt, Lanes<A> ls) {
  constexpr int U = InFlight<A>::loads / CPT;
  __shared__ A colsum[kWarps][kCols];
  __shared__ A red[kWarps];
  __shared__ A esum[CPT];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if constexpr (kLanes) {
    const int64_t l = blockIdx.z;
    X += l * ls.x_stride;
    y += l * ls.y_stride;
    v += l * n;
    at += l * p;
    ab += l * p;
    d += l * p;
    e_part += l * gridDim.x;
  }
  const int j0 = blockIdx.x * kCols + lane;

  A acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0;
  for (int r = warp; r < n; r += U * kWarps) {
    A x[U][CPT], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * kWarps;
      vr[u] = rr < n ? v[rr] : A(0);
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        x[u][k] = rr < n && j0 + 32 * k < p ? ld<T>(X, (int64_t)rr * p + j0 + 32 * k)
                                             : A(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[k] = mad(x[u][k], vr[u], acc[k]);
  }

  // byv = y.v / t, needed only here: summed after the loads of X went out
  A s = 0;
  for (int r = threadIdx.x; r < n; r += kThreads) s = mad(y[r], v[r], s);
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
#pragma unroll
  for (int k = 0; k < CPT; ++k) colsum[warp][lane + 32 * k] = acc[k];
  __syncthreads();
  A byv = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) byv += red[w];
  if constexpr (kLanes) invt = ls.invt[blockIdx.z];
  byv *= invt;
  if (threadIdx.x < kCols) {   // whole warps: kCols is a multiple of 32
    A c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += colsum[w][threadIdx.x];
    const int j = blockIdx.x * kCols + threadIdx.x;
    A contrib = 0;
    if (j < p) {
      const A ut = at[j] * (c - byv);
      const A ub = ab[j] * (c + byv);
      d[j] = ut + ub;
      contrib = ub - ut;
    }
    contrib = warp_sum(contrib);
    if (lane == 0) esum[warp] = contrib;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    A e = 0;
#pragma unroll
    for (int w = 0; w < CPT; ++w) e += esum[w];
    e_part[blockIdx.x] = e;
  }
}

// ---------------------------------------------------------------- pass 2 ---
constexpr int kChunk = 4096;                    // columns of d per block
constexpr int kWideP = 1024;                    // from here, R = 4 and chunks

// Shared-memory slot of column i of the chunk. Lane l reads the columns of
// its 16-byte vector: a stride of 4 words (f32), 8 words (bf16) or 2
// doubles (f64) across the warp. f32 / bf16: one pad word every 32 cuts the
// 4- and 8-way bank conflicts to at most 2-way. f64: a double spans two of
// the 32 four-byte banks, and a warp's 8-byte reads are served per half-warp
// (16 lanes, 32 doubles apart at most); doubles 16 apart would share banks,
// so one pad double every 16 shifts each such pair by two banks, and the
// reads are conflict-free. The padded chunk: 4,224 floats (16.9 KB) or 4,352
// doubles (34.8 KB), under the 48 KB of static shared memory.
template <typename A> struct Pad { static constexpr int shift = 5; };
template <> struct Pad<double> { static constexpr int shift = 4; };
template <typename A> __device__ __forceinline__ int slot(int i) {
  return i + (i >> Pad<A>::shift);
}

// A 16-byte vector of X: 4 floats, 8 bf16 in a uint4, or 2 doubles.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

// acc + the vector x times columns i .. i+n-1 of the staged d.
__device__ __forceinline__ float vdot(const float4& x, const float* ds, int i, float acc) {
  acc = fmaf(x.x, ds[slot<float>(i)], acc);
  acc = fmaf(x.y, ds[slot<float>(i + 1)], acc);
  acc = fmaf(x.z, ds[slot<float>(i + 2)], acc);
  return fmaf(x.w, ds[slot<float>(i + 3)], acc);
}
__device__ __forceinline__ float vdot(const uint4& x, const float* ds, int i, float acc) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    acc = fmaf(f.x, ds[slot<float>(i + 2 * k)], acc);
    acc = fmaf(f.y, ds[slot<float>(i + 2 * k + 1)], acc);
  }
  return acc;
}
__device__ __forceinline__ double vdot(const double2& x, const double* ds, int i,
                                       double acc) {
  acc = fma(x.x, ds[slot<double>(i)], acc);
  return fma(x.y, ds[slot<double>(i + 1)], acc);
}

// grid (ceil(n / R), chunks); R rows of one chunk per block, 256 / R threads
// per row. With more than one chunk, part (n, chunks) holds the partials and
// ticket (ceil(n / R),) counts the finished chunks of each row group; it is
// 0 before the launch and 0 again after it. With kLanes, blockIdx.z is the
// lane, and part and ticket hold B such blocks, one after another.
template <typename T, int R, bool kLanes, typename A = acc_t<T>>
__global__ void __launch_bounds__(kThreads)
hinge_xd(const T* __restrict__ X, const A* __restrict__ d,
         const A* __restrict__ e_part, int n_epart, const A* __restrict__ y,
         const A* __restrict__ v, A* __restrict__ hv, A* __restrict__ part,
         int* __restrict__ ticket, int n, int p, A invt, A twoC, Lanes<A> ls) {
  constexpr int TPR = kThreads / R;   // threads per row
  constexpr int WPR = TPR / 32;       // warps per row
  constexpr int VEC = Vec<T>::n;
  using VT = typename Vec<T>::type;
  __shared__ A ds[kChunk + (kChunk >> Pad<A>::shift)];
  __shared__ A red[kWarps];
  __shared__ A wsum[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nchunk = gridDim.y;
  if constexpr (kLanes) {
    const int64_t l = blockIdx.z;
    X += l * ls.x_stride;
    y += l * ls.y_stride;
    d += l * p;
    e_part += l * n_epart;
    v += l * n;
    hv += l * n;
    if (nchunk > 1) {
      part += l * n * nchunk;
      ticket += l * gridDim.x;
    }
    invt = ls.invt[l];
    twoC = ls.twoC[l];
  }
  const int j0 = blockIdx.y * kChunk;
  const int len = min(kChunk, p - j0);
  for (int i = tid; i < len; i += kThreads) ds[slot<A>(i)] = d[j0 + i];
  __syncthreads();

  const int lt = tid % TPR;
  const int row = blockIdx.x * R + tid / TPR;
  A a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (row < n) {
    const T* xr = X + (int64_t)row * p + j0;
    // columns before the first 16-byte boundary of this row's chunk: up to
    // 3 floats, 7 bf16 or 1 double (every other row when p is odd)
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) & 15u);
    const int head = min(len, ((16 - mis) & 15) / (int)sizeof(T));
    if (lt < head) a0 = ld<T>(xr, lt) * ds[slot<A>(lt)];   // head < VEC <= TPR
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
    if (tail < len) a1 = mad(ld<T>(xr, tail), ds[slot<A>(tail)], a1);
  }
  const A acc = warp_sum((a0 + a1) + (a2 + a3));
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();

  // thread r < R owns row r of the block from here on
  const int mine_row = blockIdx.x * R + tid;
  const bool owner = tid < R && mine_row < n;
  A dot = 0;
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
      dot = 0;
      for (int c = 0; c < nchunk; ++c) dot += __ldcg(&part[(int64_t)mine_row * nchunk + c]);
    }
    if (tid == 0) ticket[blockIdx.x] = 0;   // every block of the group has counted
  }
  A es = 0;
  for (int i = tid; i < n_epart; i += kThreads) es += e_part[i];
  const A e = block_sum(es, red, tid);
  if (owner) hv[mine_row] = v[mine_row] + twoC * (dot + y[mine_row] * invt * e);
}

// Rows per block and column chunks of pass 2 for a row length p.
__host__ __device__ inline int xd_rows(int p) { return p >= kWideP ? 4 : 8; }
__host__ __device__ inline int xd_chunks(int p) {
  return p >= kWideP ? (p + kChunk - 1) / kChunk : 1;
}

// The scalars come in as double and are rounded to the summing type here:
// the f32 and bf16 modes multiply by the same float 1/t and 2C as ever. A
// lane-batched launch (kLanes) takes `lanes_n` lanes on grid z and reads
// each lane's scalars from ls.invt / ls.twoC instead.
template <typename T, bool kLanes>
cudaError_t launch_xtv(const void* X, const void* v, const void* y, const void* at,
                       const void* ab, void* d, void* e_part, int n, int p, double invt,
                       Lanes<acc_t<T>> ls, int lanes_n, cudaStream_t s) {
  using A = acc_t<T>;
  const dim3 grid((p + kCols - 1) / kCols, 1, lanes_n);
  hinge_xtv<T, kLanes><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(X), static_cast<const A*>(v), static_cast<const A*>(y),
      static_cast<const A*>(at), static_cast<const A*>(ab), static_cast<A*>(d),
      static_cast<A*>(e_part), n, p, A(invt), ls);
  return cudaGetLastError();
}

template <typename T, bool kLanes>
cudaError_t launch_xd(const void* X, const void* d, const void* e_part, int n_epart,
                      const void* y, const void* v, void* hv, void* part, int* ticket,
                      int n, int p, double invt, double twoC, Lanes<acc_t<T>> ls,
                      int lanes_n, cudaStream_t s) {
  using A = acc_t<T>;
  const T* Xt = static_cast<const T*>(X);
  const A *dA = static_cast<const A*>(d), *eA = static_cast<const A*>(e_part),
          *yA = static_cast<const A*>(y), *vA = static_cast<const A*>(v);
  A *hA = static_cast<A*>(hv), *pA = static_cast<A*>(part);
  const int R = xd_rows(p);
  const dim3 grid((n + R - 1) / R, xd_chunks(p), lanes_n);
  if (R == 4) {
    hinge_xd<T, 4, kLanes><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA,
                                                     ticket, n, p, A(invt), A(twoC), ls);
  } else {
    hinge_xd<T, 8, kLanes><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA,
                                                     ticket, n, p, A(invt), A(twoC), ls);
  }
  return cudaGetLastError();
}

template <typename T>
Lanes<acc_t<T>> lanes_of(long long x_stride, long long y_stride, const void* invt,
                         const void* twoC) {
  using A = acc_t<T>;
  return Lanes<A>{x_stride, y_stride, static_cast<const A*>(invt),
                  static_cast<const A*>(twoC)};
}

// f(T{}) for the storage type T of `mode`: float32 (0), bfloat16 (1),
// float64 (2); an unknown mode is cudaErrorInvalidValue.
template <typename F> int by_mode(int mode, F&& f) {
  switch (mode) {
    case 0: return (int)f(float{});
    case 1: return (int)f(__nv_bfloat16{});
    case 2: return (int)f(double{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Number of e partials pass 1 writes for a row length p: one per block of
// kCols columns.
int sven_hinge_xtv_blocks(int p) { return (p + kCols - 1) / kCols; }

// X (n, p) row-major: float32 (mode 0), bfloat16 (mode 1) or float64 (mode
// 2). v, y (n,), at, ab (p,) in and d (p,), e_part (sven_hinge_xtv_blocks(p),)
// out are float64 in mode 2 and float32 otherwise. Returns the CUDA error of
// the launch (0 = none; an unknown mode is cudaErrorInvalidValue).
int sven_hinge_xtv(const void* X, int mode, const void* v, const void* y, const void* at,
                   const void* ab, void* d, void* e_part, int n, int p, double invt,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    return launch_xtv<T, false>(X, v, y, at, ab, d, e_part, n, p, invt, Lanes<acc_t<T>>{},
                                1, s);
  });
}

// Pass 1 for `lanes` problems in one launch. X is (n, p) shared by every
// lane (x_stride 0) or (lanes, n, p) (x_stride n p); y (n,) shared (y_stride
// 0) or (lanes, n) (y_stride n); v (lanes, n), at, ab, d (lanes, p), e_part
// (lanes, sven_hinge_xtv_blocks(p)) and invt (lanes,): each lane's 1/t in
// the summing type. Types as for sven_hinge_xtv.
int sven_hinge_xtv_lanes(const void* X, int mode, long long x_stride, const void* v,
                         const void* y, long long y_stride, const void* at, const void* ab,
                         void* d, void* e_part, int n, int p, int lanes, const void* invt,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    return launch_xtv<T, true>(X, v, y, at, ab, d, e_part, n, p, 0.0,
                               lanes_of<T>(x_stride, y_stride, invt, nullptr), lanes, s);
  });
}

// Rows per row group and column chunks of pass 2 (the wrapper sizes part as
// (n, chunks) and ticket as (ceil(n / rows),) from these).
int sven_hinge_xd_rows(int p) { return xd_rows(p); }
int sven_hinge_xd_chunks(int p) { return xd_chunks(p); }

// X and mode as above; d (p,), e_part (n_epart,), y, v (n,) in and hv (n,)
// out, float64 in mode 2 and float32 otherwise. With more than one chunk:
// part (n, chunks) scratch of the same type, and ticket (ceil(n / rows),)
// int32, all 0 on entry and left 0 (else both may be null). One launch on
// `stream`; launches that share a ticket buffer must be ordered (one stream).
int sven_hinge_xd(const void* X, int mode, const void* d, const void* e_part, int n_epart,
                  const void* y, const void* v, void* hv, void* part, int* ticket, int n,
                  int p, double invt, double twoC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    return launch_xd<T, false>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p, invt,
                               twoC, Lanes<acc_t<T>>{}, 1, s);
  });
}

// Pass 2 for `lanes` problems in one launch. X, x_stride, y and y_stride as
// for sven_hinge_xtv_lanes; d (lanes, p), e_part (lanes, n_epart), v and hv
// (lanes, n), invt and twoC (lanes,) in the summing type. With more than one
// chunk: part (lanes, n, chunks) and ticket (lanes, ceil(n / rows)), the
// ticket all 0 on entry and left 0.
int sven_hinge_xd_lanes(const void* X, int mode, long long x_stride, const void* d,
                        const void* e_part, int n_epart, const void* y, long long y_stride,
                        const void* v, void* hv, void* part, int* ticket, int n, int p,
                        int lanes, const void* invt, const void* twoC, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    return launch_xd<T, true>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p, 0.0,
                              0.0, lanes_of<T>(x_stride, y_stride, invt, twoC), lanes, s);
  });
}

}  // extern "C"

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
// that JAX's vmap gives the Pallas kernels, on one of two routes. Bound of a
// lane-batched pass: B reads of X when the lanes stack X, one read when
// they share it. A stacked X (or one lane) takes the stacked route: pass 1
// is the single launch's kernel with the lane on grid z (an instantiation
// of its own, kLanes, so the single launch's code is unchanged); pass 2 is
// hinge_xd_stacked, a block per (lane, chunk) and many rows. A shared X with
// two or more lanes takes the shared-X route (hinge_xtv_shared,
// hinge_xd_shared): a block takes its strip or tile for a group of up to G
// lanes, each element of X it loads feeds every lane of the group, and the
// groups that read one strip or tile are neighbours in the grid, so all but
// the first find it in the L2. Each lane's sums keep the single launch's
// order on either route (see each kernel), and pass 2 splits each row at
// its own 16-byte boundary as the single launch does, so every lane is
// bitwise a single launch on that lane's operands at the same addresses (a
// stacked X whose lanes lie a multiple of 16 bytes apart, as
// core/svm/state.py::pitched lays them out, gives each lane the single
// launch's bits on a fresh copy too). Each lane's 1/t and 2C are taken from
// its float64 t and C in the kernel, as the host takes them for a single
// launch. kernels/hinge.py::plan picks the route, the lane groups and pass
// 2's rows per block. What bounds the shared route (PERF.md §6): in pass 1,
// the loads of X an SM keeps in flight while G lanes' accumulators hold its
// registers; in pass 2, its reads of d from shared memory, one per element
// of X and lane, which its paired rows halve.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The lane operands of a lane-batched launch: the elements between two
// lanes' X (0: shared, or at least n p) and y (0, or at least n), and each
// lane's t and C (B,) in float64. Every other operand is stacked densely by
// lane.
template <typename A> struct Lanes {
  int64_t x_stride;
  int64_t y_stride;
  const double* t;
  const double* C;
};

// Lane l's 1/t and 2C in the summing type: taken in double and rounded once,
// as the host computes them for a single launch (IEEE division is correctly
// rounded on both).
template <typename A> __device__ __forceinline__ A lane_invt(const Lanes<A>& ls, int64_t l) {
  return A(1.0 / ls.t[l]);
}
template <typename A> __device__ __forceinline__ A lane_twoC(const Lanes<A>& ls, int64_t l) {
  return A(2.0 * ls.C[l]);
}

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
// the warps in warp order. With kLanes (pass 1 of the stacked route),
// blockIdx.z is the lane.
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
  if constexpr (kLanes) invt = lane_invt(ls, blockIdx.z);
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

// Lane groups of the shared-X route: `lanes` lanes cut into
// lane_groups(lanes, G) groups of at most G whose sizes differ by at most
// one; group i holds lanes [group_first(i), group_first(i + 1)).
// kernels/hinge.py::lane_groups computes the same cut.
__host__ __device__ inline int lane_groups(int lanes, int G) { return (lanes + G - 1) / G; }
__device__ __forceinline__ int group_first(int i, int lanes, int ng) {
  return (int)((int64_t)i * lanes / ng);
}

// One element from global to shared memory by cp.async (no registers;
// cp_async_wait_all waits for every copy the thread issued).
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block of the shared-X route has 512 threads (16 warps). Pass 1 keeps
// two an SM, so a thread has 64 registers, of which its G x kShCPT
// accumulators may take 24 words; pass 2 keeps one (its staged chunks of d
// take most of the shared memory).
constexpr int kShThreads = 512;
constexpr int kShWarps = kShThreads / 32;
constexpr int kShCPT = 2;          // columns per thread of the shared pass 1
constexpr int kVRows = 128;        // rows of v the shared pass 1 stages at a time

// Rows of X a thread of the shared pass 1 loads per step: 64 bytes of loads
// (kShCPT columns a row), or half that where its accumulators take more
// than 16 words.
__host__ __device__ constexpr int xtv_rows(int words, int loads) {
  return words > 16 ? loads / kShCPT / 2 : loads / kShCPT;
}

// Pass 1 on a shared X for groups of up to G lanes: a block takes its
// kCols-column strip for every lane of its group, so each element of X it
// loads feeds the group's G FMAs. Grid: ceil(p / kCols) strips x
// lane_groups(lanes, G) groups, the group the fastest index, so the groups
// that read one strip run side by side and all but the first find it in
// the L2. Warp w takes row class w % 8 (rows w % 8, w % 8 + 8, ...) and
// column half w / 8 of the strip, kShCPT columns 32 apart a thread. The
// group's v is staged in shared memory as [row][lane], kVRows rows at a
// time, and read as a broadcast; its act_top, act_bot of the strip are
// copied to shared memory (cp.async) while X streams, and its 1/t written
// there, so the epilogue waits on no load from memory. Every lane's sums
// are the single launch's, in its order: byv by the first 256 threads as its block sums it (first,
// before the accumulators take their registers); column j of lane g over
// its row class in row order (a padding row would add +0 to an accumulator
// that cannot be -0, so it is skipped), then the 8 classes in class order;
// d and the e partial as its epilogue, lane by lane through one colsum
// buffer. So each lane is bitwise a single launch.
template <typename T, int G, typename A = acc_t<T>>
__global__ void __launch_bounds__(kShThreads, 2)
hinge_xtv_shared(const T* __restrict__ X, const A* __restrict__ v,
                 const A* __restrict__ y, const A* __restrict__ at,
                 const A* __restrict__ ab, A* __restrict__ d,
                 A* __restrict__ e_part, int n, int p, int lanes, Lanes<A> ls) {
  constexpr int CP = kShCPT;
  constexpr int words = G * CP * sizeof(A) / 4;
  static_assert(words <= 24, "two blocks an SM leave 24 registers to the accumulators");
  constexpr int U = xtv_rows(words, InFlight<A>::loads);
  __shared__ A colsum[kWarps][kCols];
  __shared__ A vs[kVRows][G];
  __shared__ A ats[G][kCols], abs_[G][kCols], invts[G];
  __shared__ A red[G][kWarps];
  __shared__ A esum[CPT];
  const int tid = threadIdx.x, lane = tid % 32, wid = tid / 32;
  const int cls = wid % kWarps, half = wid / kWarps;
  const int ng = lane_groups(lanes, G);
  const int grp = blockIdx.x % ng, strip = blockIdx.x / ng;
  const int nstrip = gridDim.x / ng;
  const int l0 = group_first(grp, lanes, ng);
  const int gl = group_first(grp + 1, lanes, ng) - l0;
  const A* vg = v + (int64_t)l0 * n;
  const int j0 = strip * kCols + half * 32 * CP + lane;
  for (int i = tid; i < gl * kCols; i += kShThreads) {
    const int g = i / kCols, c = i - g * kCols, j = strip * kCols + c;
    if (j < p) {
      cp_async(&ats[g][c], at + (int64_t)(l0 + g) * p + j);
      cp_async(&abs_[g][c], ab + (int64_t)(l0 + g) * p + j);
    }
  }
  if (tid < gl) invts[tid] = lane_invt(ls, l0 + tid);

  // byv of each lane, summed by the first 256 threads as a single launch's
  // block sums it, before the accumulators of X^T v take their registers
  if (tid < kThreads) {
    A s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0;
    for (int r = tid; r < n; r += kThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < gl)
          s[g] = mad(y[(int64_t)(l0 + g) * ls.y_stride + r], vg[(int64_t)g * n + r], s[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const A sw = warp_sum(s[g]);
      if (lane == 0) red[g][wid] = sw;
    }
  }

  A acc[G][CP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < CP; ++k) acc[g][k] = 0;
  for (int c0 = 0; c0 < n; c0 += kVRows) {
    const int c1 = min(n, c0 + kVRows);
    __syncthreads();                   // the previous rows of v are read
    for (int i = tid; i < (c1 - c0) * gl; i += kShThreads) {
      const int g = i / (c1 - c0), r = i - g * (c1 - c0);
      vs[r][g] = vg[(int64_t)g * n + c0 + r];
    }
    __syncthreads();
    for (int r = c0 + cls; r < c1; r += U * kWarps) {
      A x[U][CP];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * kWarps;
#pragma unroll
        for (int k = 0; k < CP; ++k)
          x[u][k] = rr < c1 && j0 + 32 * k < p ? ld<T>(X, (int64_t)rr * p + j0 + 32 * k)
                                                : A(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * kWarps;
        if (rr < c1) {                   // warp-uniform
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (g < gl) {
              const A vv = vs[rr - c0][g];
#pragma unroll
              for (int k = 0; k < CP; ++k) acc[g][k] = mad(x[u][k], vv, acc[g][k]);
            }
          }
        }
      }
    }
  }

  cp_async_wait_all();               // ats, abs_ (and invts): visible after the next barrier
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= gl) break;                 // block-uniform
    const int64_t l = l0 + g;
#pragma unroll
    for (int k = 0; k < CP; ++k) colsum[cls][half * 32 * CP + lane + 32 * k] = acc[g][k];
    __syncthreads();
    if (tid < kCols) {   // whole warps: kCols is a multiple of 32
      A byv = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) byv += red[g][w];
      const A invt = invts[g];
      byv *= invt;
      A c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += colsum[w][tid];
      const int j = strip * kCols + tid;
      A contrib = 0;
      if (j < p) {
        const A ut = ats[g][tid] * (c - byv);
        const A ub = abs_[g][tid] * (c + byv);
        d[l * p + j] = ut + ub;
        contrib = ub - ut;
      }
      contrib = warp_sum(contrib);
      if (lane == 0) esum[wid] = contrib;
    }
    __syncthreads();   // colsum and esum are read before the next lane writes them
    if (tid == 0) {
      A e = 0;
#pragma unroll
      for (int w = 0; w < CPT; ++w) e += esum[w];
      e_part[l * nstrip + strip] = e;
    }
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
// 0 before the launch and 0 again after it.
template <typename T, int R, typename A = acc_t<T>>
__global__ void __launch_bounds__(kThreads)
hinge_xd(const T* __restrict__ X, const A* __restrict__ d,
         const A* __restrict__ e_part, int n_epart, const A* __restrict__ y,
         const A* __restrict__ v, A* __restrict__ hv, A* __restrict__ part,
         int* __restrict__ ticket, int n, int p, A invt, A twoC) {
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

// Pass 2 on a stacked X (or one lane), replacing the per-lane form that ran
// the kernel above with the lane on grid z. Bound: B reads of X. The
// per-lane form's blocks took R rows of one chunk (2,160 blocks at 9b), each
// staging a 32 KB chunk of d from the L2 for 128 KB of X: a quarter more
// traffic, and one L2 round trip before its first load of X. Here a block
// takes one (lane, chunk) and `rows` rows (a multiple of R; kernels/
// hinge.py::plan sizes them): it stages the chunk once and walks its rows R
// at a time (in float64 with 8 vectors of X in flight a thread, not 4),
// each row summed by the single launch's threads in its order (the same
// code as above: head and tail from the row's own address, the
// vector-to-accumulator map, warp_sum, the row's warps in order); with more
// than one chunk the last block of a (lane, row block), found by its
// ticket, sums each row's partials in chunk order and e as a single
// launch's block sums it, and sets the ticket back to 0. So each lane is
// bitwise a single launch.
template <typename T, int R, typename A = acc_t<T>>
__global__ void __launch_bounds__(kThreads)
hinge_xd_stacked(const T* __restrict__ X, const A* __restrict__ d,
                 const A* __restrict__ e_part, int n_epart, const A* __restrict__ y,
                 const A* __restrict__ v, A* __restrict__ hv, A* __restrict__ part,
                 int* __restrict__ ticket, int n, int p, int lanes, int rows, Lanes<A> ls) {
  constexpr int TPR = kThreads / R;   // threads per row
  constexpr int WPR = TPR / 32;       // warps per row
  constexpr int VEC = Vec<T>::n;
  // 16-byte vectors of X a thread keeps in flight: 8 in float64, whose rows
  // are twice as long in bytes, else the single launch's 4
  constexpr int kDeep = sizeof(T) == 8 ? 8 : 4;
  using VT = typename Vec<T>::type;
  __shared__ A ds[kChunk + (kChunk >> Pad<A>::shift)];
  __shared__ A red[kWarps];
  __shared__ A wsum[kWarps];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nchunk = gridDim.y, chunk = blockIdx.y;
  const int64_t l = blockIdx.x % lanes;
  const int rblk = blockIdx.x / lanes;
  X += l * ls.x_stride;
  y += l * ls.y_stride;
  d += l * p;
  e_part += l * n_epart;
  v += l * n;
  hv += l * n;
  part += l * n * nchunk;
  const A invt = lane_invt(ls, l), twoC = lane_twoC(ls, l);
  const int j0 = chunk * kChunk;
  const int len = min(kChunk, p - j0);
  for (int i = tid; i < len; i += kThreads) ds[slot<A>(i)] = d[j0 + i];
  A e = 0;
  if (nchunk == 1) {   // every block needs e with one chunk, only the last with more
    A es = 0;
    for (int i = tid; i < n_epart; i += kThreads) es += e_part[i];
    e = block_sum(es, red, tid);   // its barriers also publish ds
  }
  __syncthreads();

  const int lt = tid % TPR;
  const int row0 = rblk * rows, row_end = min(n, row0 + rows);
  for (int r0 = row0; r0 < row_end; r0 += R) {   // block-uniform
    const int row = r0 + tid / TPR;
    A a0 = 0, a1 = 0, a2 = 0, a3 = 0;
    if (row < row_end) {
      const T* xr = X + (int64_t)row * p + j0;
      const int mis = (int)(reinterpret_cast<uintptr_t>(xr) & 15u);
      const int head = min(len, ((16 - mis) & 15) / (int)sizeof(T));
      if (lt < head) a0 = ld<T>(xr, lt) * ds[slot<A>(lt)];
      const int nv = (len - head) / VEC;
      const VT* xv = reinterpret_cast<const VT*>(xr + head);
      int k = lt;
      if constexpr (kDeep > 4) {
        // kDeep vectors in flight, summed four at a time into a0..a3: the
        // FMAs of the single launch's unrolled loop, in its order
        for (; k + (kDeep - 1) * TPR < nv; k += kDeep * TPR) {
          VT x[kDeep];
#pragma unroll
          for (int m = 0; m < kDeep; ++m) x[m] = __ldg(xv + k + m * TPR);
#pragma unroll
          for (int m = 0; m < kDeep; m += 4) {
            a0 = vdot(x[m], ds, head + (k + m * TPR) * VEC, a0);
            a1 = vdot(x[m + 1], ds, head + (k + (m + 1) * TPR) * VEC, a1);
            a2 = vdot(x[m + 2], ds, head + (k + (m + 2) * TPR) * VEC, a2);
            a3 = vdot(x[m + 3], ds, head + (k + (m + 3) * TPR) * VEC, a3);
          }
        }
      }
      for (; k + 3 * TPR < nv; k += 4 * TPR) {
        const VT x0 = __ldg(xv + k), x1 = __ldg(xv + k + TPR);
        const VT x2 = __ldg(xv + k + 2 * TPR), x3 = __ldg(xv + k + 3 * TPR);
        a0 = vdot(x0, ds, head + k * VEC, a0);
        a1 = vdot(x1, ds, head + (k + TPR) * VEC, a1);
        a2 = vdot(x2, ds, head + (k + 2 * TPR) * VEC, a2);
        a3 = vdot(x3, ds, head + (k + 3 * TPR) * VEC, a3);
      }
      for (; k < nv; k += TPR) a0 = vdot(__ldg(xv + k), ds, head + k * VEC, a0);
      const int tail = head + nv * VEC + lt;
      if (tail < len) a1 = mad(ld<T>(xr, tail), ds[slot<A>(tail)], a1);
    }
    const A acc = warp_sum((a0 + a1) + (a2 + a3));
    if (lane == 0) wsum[warp] = acc;
    __syncthreads();
    if (tid < R && r0 + tid < row_end) {   // thread r owns row r0 + r
      const int mine_row = r0 + tid;
      A dot = 0;
#pragma unroll
      for (int w = 0; w < WPR; ++w) dot += wsum[tid * WPR + w];
      if (nchunk > 1)
        part[(int64_t)mine_row * nchunk + chunk] = dot;
      else
        hv[mine_row] = v[mine_row] + twoC * (dot + y[mine_row] * invt * e);
    }
    __syncthreads();   // wsum is read before the next rows write it
  }
  if (nchunk == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&ticket[blockIdx.x], 1) == nchunk - 1;
  __syncthreads();
  if (!last) return;                 // block-uniform
  __threadfence();
  A es = 0;
  for (int i = tid; i < n_epart; i += kThreads) es += e_part[i];
  e = block_sum(es, red, tid);
  for (int mine_row = row0 + tid; mine_row < row_end; mine_row += kThreads) {
    A dot = 0;
    for (int c = 0; c < nchunk; ++c) dot += __ldcg(&part[(int64_t)mine_row * nchunk + c]);
    hv[mine_row] = v[mine_row] + twoC * (dot + y[mine_row] * invt * e);
  }
  if (tid == 0) ticket[blockIdx.x] = 0;   // every block of the row block has counted
}

// The padded chunk of d a block of pass 2 stages for one lane.
template <typename A> __host__ __device__ constexpr int chunk_slots() {
  return kChunk + (kChunk >> Pad<A>::shift);
}

// The elements of a 16-byte vector of X in the summing type, in memory
// order.
__device__ __forceinline__ void unpack(const float4& x, float (&f)[4]) {
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
}
__device__ __forceinline__ void unpack(const uint4& x, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x, f[2 * k + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const double2& x, double (&f)[2]) {
  f[0] = x.x, f[1] = x.y;
}

// es[g] = e of lane l0 + g (g < gl), summed from its n_epart partials by
// the first 256 threads as a single launch's block sums e, for every lane
// at once (red2 holds G x kWarps values); every thread of the block calls
// it, and es is visible after the next barrier.
template <int G, typename A>
__device__ __forceinline__ void lanes_e(const A* __restrict__ e_part, int n_epart, int l0,
                                        int gl, A (*red2)[kWarps], A* es, int tid) {
  const int lane = tid % 32, wid = tid / 32;
  A s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0;
  if (tid < kThreads) {
    for (int i = tid; i < n_epart; i += kThreads) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < gl) s[g] += e_part[(int64_t)(l0 + g) * n_epart + i];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const A sw = warp_sum(s[g]);
      if (lane == 0) red2[g][wid] = sw;
    }
  }
  __syncthreads();
  if (tid < gl) {
    A e = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) e += red2[tid][w];
    es[tid] = e;
  }
}

// a[g] and b[g] = vdot(xa / xb, lane g's staged chunk, i, ...) for the gl
// live lanes of a group: the FMAs of `vdot` in its order for each of two
// rows that read the same columns, each element of d loaded once for both.
template <typename T, int G, typename A>
__device__ __forceinline__ void vdot_pair(const typename Vec<T>::type& xa,
                                          const typename Vec<T>::type& xb, const A* ds,
                                          int i, int gl, A (&a)[G], A (&b)[G]) {
  constexpr int VEC = Vec<T>::n;
  A fa[VEC], fb[VEC];
  unpack(xa, fa);
  unpack(xb, fb);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < gl) {
      const A* dg = ds + g * chunk_slots<A>();
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const A dv = dg[slot<A>(i + q)];
        a[g] = mad(fa[q], dv, a[g]);
        b[g] = mad(fb[q], dv, b[g]);
      }
    }
  }
}

// Pass 2 on a shared X for groups of up to G lanes. A block stages its
// chunk of d for each lane of its group (dynamic shared memory, gl x the
// padded chunk, by cp.async), then takes `rows` rows (a multiple of 4 R) in
// passes of 4 R rows. As in the single launch TPR = 256 / R threads take a
// row, but each such thread group takes two rows D = 16 / sizeof(T) apart:
// their starts lie at the same offset from a 16-byte boundary, so both
// split at the same columns, and each element of d read from shared memory
// feeds both rows (the reads of d bound this pass). Each 16-byte vector of X
// is loaded once and feeds the group's vdots. Grid: (lane_groups(lanes, G)
// x ceil(n / rows), chunks), the group the fastest index. Each (lane, row)
// is summed as the single launch sums it: the same threads per row, the
// same head and tail from the row's own address (one address for every
// lane), the same vector-to-accumulator map (a0..a3 in the unrolled loop,
// a0 for the rest and the head, a1 for the tail), warp_sum, the row's warps
// in order, the partials in chunk order, e as its block sums it. With more
// than one chunk, ticket (one per group x row block) finds the last block,
// which finishes the rows of its group and row block and sets the ticket
// back to 0. So each lane is bitwise a single launch.
template <typename T, int R, int G, typename A = acc_t<T>>
__global__ void __launch_bounds__(kShThreads, 1)
hinge_xd_shared(const T* __restrict__ X, const A* __restrict__ d,
                const A* __restrict__ e_part, int n_epart, const A* __restrict__ y,
                const A* __restrict__ v, A* __restrict__ hv, A* __restrict__ part,
                int* __restrict__ ticket, int n, int p, int lanes, int rows, Lanes<A> ls) {
  constexpr int TPR = kThreads / R;     // threads per row, as in the single launch
  constexpr int WPR = TPR / 32;         // warps per row
  constexpr int NG = kShThreads / TPR;  // thread groups: 2 R
  constexpr int D = 16 / sizeof(T);     // rows between the two rows of a group
  constexpr int PR = 2 * NG;            // rows of a pass
  constexpr int VEC = Vec<T>::n;
  constexpr int SL = chunk_slots<A>();
  static_assert(NG % D == 0, "a pass must pair every row");
  using VT = typename Vec<T>::type;
  extern __shared__ __align__(16) unsigned char dyn[];
  A* ds = reinterpret_cast<A*>(dyn);
  __shared__ A red2[G][kWarps];
  __shared__ A wsum[2][G][kShWarps];
  __shared__ A es[G];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nchunk = gridDim.y, chunk = blockIdx.y;
  const int ng = lane_groups(lanes, G);
  const int grp = blockIdx.x % ng, rblk = blockIdx.x / ng;
  const int l0 = group_first(grp, lanes, ng);
  const int gl = group_first(grp + 1, lanes, ng) - l0;
  const int j0 = chunk * kChunk;
  const int len = min(kChunk, p - j0);
  for (int g = 0; g < gl; ++g)
    for (int i = tid; i < len; i += kShThreads)
      cp_async(ds + g * SL + slot<A>(i), d + (int64_t)(l0 + g) * p + j0 + i);
  // each lane's e: every block needs it with one chunk, only the last with
  // more
  if (nchunk == 1) lanes_e<G>(e_part, n_epart, l0, gl, red2, es, tid);
  cp_async_wait_all();
  __syncthreads();

  // thread group tg takes rows ra and ra + D of each pass
  const int lt = tid % TPR, tg = tid / TPR;
  const int ra_off = (tg / D) * 2 * D + tg % D;
  const int row0 = rblk * rows, row_end = min(n, row0 + rows);
  for (int r0 = row0; r0 < row_end; r0 += PR) {   // block-uniform
    const int ra = r0 + ra_off, rb = ra + D;
    A a0[G], a1[G], a2[G], a3[G], b0[G], b1[G], b2[G], b3[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      a0[g] = a1[g] = a2[g] = a3[g] = 0;
      b0[g] = b1[g] = b2[g] = b3[g] = 0;
    }
    if (ra < n) {
      const bool live_b = rb < n;
      const T* xa = X + (int64_t)ra * p + j0;
      const T* xb = X + (int64_t)(live_b ? rb : ra) * p + j0;   // a copy of row a if b is past n
      const int mis = (int)(reinterpret_cast<uintptr_t>(xa) & 15u);
      const int head = min(len, ((16 - mis) & 15) / (int)sizeof(T));
      if (lt < head) {
        const A ha = ld<T>(xa, lt), hb = ld<T>(xb, lt);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gl) {
            const A dv = ds[g * SL + slot<A>(lt)];
            a0[g] = ha * dv;
            b0[g] = hb * dv;
          }
        }
      }
      const int nv = (len - head) / VEC;
      const VT* va = reinterpret_cast<const VT*>(xa + head);
      const VT* vb = reinterpret_cast<const VT*>(xb + head);
      int k = lt;
      for (; k + 3 * TPR < nv; k += 4 * TPR) {
        VT xa4[4], xb4[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) xa4[m] = __ldg(va + k + m * TPR);
#pragma unroll
        for (int m = 0; m < 4; ++m) xb4[m] = __ldg(vb + k + m * TPR);
        vdot_pair<T, G>(xa4[0], xb4[0], ds, head + k * VEC, gl, a0, b0);
        vdot_pair<T, G>(xa4[1], xb4[1], ds, head + (k + TPR) * VEC, gl, a1, b1);
        vdot_pair<T, G>(xa4[2], xb4[2], ds, head + (k + 2 * TPR) * VEC, gl, a2, b2);
        vdot_pair<T, G>(xa4[3], xb4[3], ds, head + (k + 3 * TPR) * VEC, gl, a3, b3);
      }
      for (; k < nv; k += TPR)
        vdot_pair<T, G>(__ldg(va + k), __ldg(vb + k), ds, head + k * VEC, gl, a0, b0);
      const int tail = head + nv * VEC + lt;              // fewer than VEC left
      if (tail < len) {
        const A ta = ld<T>(xa, tail), tb = ld<T>(xb, tail);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < gl) {
            const A dv = ds[g * SL + slot<A>(tail)];
            a1[g] = mad(ta, dv, a1[g]);
            b1[g] = mad(tb, dv, b1[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const A sa = warp_sum((a0[g] + a1[g]) + (a2[g] + a3[g]));
      const A sb = warp_sum((b0[g] + b1[g]) + (b2[g] + b3[g]));
      if (lane == 0) wsum[0][g][warp] = sa, wsum[1][g][warp] = sb;
    }
    __syncthreads();
    // thread g PR + r owns row r0 + r of this pass for lane g
    if (tid < PR * G) {
      const int g = tid / PR, r = tid % PR, mine_row = r0 + r;
      const int w = r % (2 * D), second = w >= D;          // row b of its group?
      const int owner_tg = (r / (2 * D)) * D + w - (second ? D : 0);
      if (g < gl && mine_row < n) {
        A dot = 0;
#pragma unroll
        for (int q = 0; q < WPR; ++q) dot += wsum[second][g][owner_tg * WPR + q];
        const int64_t l = l0 + g;
        if (nchunk > 1) {
          part[(l * n + mine_row) * nchunk + chunk] = dot;
        } else {
          const A invt = lane_invt(ls, l), twoC = lane_twoC(ls, l), e = es[g];
          const A* yl = y + l * ls.y_stride;
          hv[l * n + mine_row] = v[l * n + mine_row] + twoC * (dot + yl[mine_row] * invt * e);
        }
      }
    }
    __syncthreads();   // wsum is read before the next pass writes it
  }
  if (nchunk == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&ticket[blockIdx.x], 1) == nchunk - 1;
  __syncthreads();
  if (!last) return;                 // block-uniform
  __threadfence();
  lanes_e<G>(e_part, n_epart, l0, gl, red2, es, tid);
  __syncthreads();
  const int nrows = row_end - row0;
  for (int q = tid; q < gl * nrows; q += kShThreads) {
    const int g = q / nrows, mine_row = row0 + q % nrows;
    const int64_t l = l0 + g;
    // the partials in chunk order, loaded four at a time
    const A* pr = part + (l * n + mine_row) * nchunk;
    A dot = 0;
    int c = 0;
    for (; c + 4 <= nchunk; c += 4) {
      const A q0 = __ldcg(pr + c), q1 = __ldcg(pr + c + 1);
      const A q2 = __ldcg(pr + c + 2), q3 = __ldcg(pr + c + 3);
      dot += q0;
      dot += q1;
      dot += q2;
      dot += q3;
    }
    for (; c < nchunk; ++c) dot += __ldcg(pr + c);
    const A invt = lane_invt(ls, l), twoC = lane_twoC(ls, l), e = es[g];
    const A* yl = y + l * ls.y_stride;
    hv[l * n + mine_row] = v[l * n + mine_row] + twoC * (dot + yl[mine_row] * invt * e);
  }
  if (tid == 0) ticket[blockIdx.x] = 0;   // every block of the group has counted
}

// Rows per block and column chunks of pass 2 for a row length p.
__host__ __device__ inline int xd_rows(int p) { return p >= kWideP ? 4 : 8; }
__host__ __device__ inline int xd_chunks(int p) {
  return p >= kWideP ? (p + kChunk - 1) / kChunk : 1;
}

// The scalars come in as double and are rounded to the summing type here:
// the f32 and bf16 modes multiply by the same float 1/t and 2C as ever.
// A lane-batched launch (kLanes) takes `lanes_n` lanes on grid z and reads
// each lane's 1/t from ls instead.
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

template <typename T>
cudaError_t launch_xd(const void* X, const void* d, const void* e_part, int n_epart,
                      const void* y, const void* v, void* hv, void* part, int* ticket,
                      int n, int p, double invt, double twoC, cudaStream_t s) {
  using A = acc_t<T>;
  const T* Xt = static_cast<const T*>(X);
  const A *dA = static_cast<const A*>(d), *eA = static_cast<const A*>(e_part),
          *yA = static_cast<const A*>(y), *vA = static_cast<const A*>(v);
  A *hA = static_cast<A*>(hv), *pA = static_cast<A*>(part);
  const int R = xd_rows(p);
  const dim3 grid((n + R - 1) / R, xd_chunks(p));
  if (R == 4) {
    hinge_xd<T, 4><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA, ticket, n,
                                             p, A(invt), A(twoC));
  } else {
    hinge_xd<T, 8><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA, ticket, n,
                                             p, A(invt), A(twoC));
  }
  return cudaGetLastError();
}

template <typename T>
Lanes<acc_t<T>> lanes_of(long long x_stride, long long y_stride, const void* t,
                         const void* C) {
  return Lanes<acc_t<T>>{x_stride, y_stride, static_cast<const double*>(t),
                         static_cast<const double*>(C)};
}

// The lane-group sizes G of the shared-X route built into this library, per
// summing type and pass (kernels/hinge.py::_SHARED_G names the same), the
// largest that compile without spills on an H100: pass 1 keeps G x 2
// accumulators a thread (at most 24 words, two blocks an SM); pass 2 G x 8
// (two rows) within 128 registers, and stages G chunks of d (34.8 KB a lane
// in float64, 16.9 KB in float32) in the 227 KB of shared memory a block
// may have.
template <typename A> struct SharedG {
  static constexpr int xtv[2] = {8, 12}, xd[2] = {3, 6};
};
template <> struct SharedG<double> {
  static constexpr int xtv[2] = {4, 6}, xd[2] = {2, 3};
};
template <int G> using IntC = std::integral_constant<int, G>;

// f(IntC<G>{}) for a G of pass 1 (xtv_group) or pass 2 (xd_group) built
// for storage type T; any other G is cudaErrorInvalidValue.
template <typename T, typename F> cudaError_t xtv_group(int G, F&& f) {
  using S = SharedG<acc_t<T>>;
  if (G == S::xtv[0]) return f(IntC<S::xtv[0]>{});
  if (G == S::xtv[1]) return f(IntC<S::xtv[1]>{});
  return cudaErrorInvalidValue;
}
template <typename T, typename F> cudaError_t xd_group(int G, F&& f) {
  using S = SharedG<acc_t<T>>;
  if (G == S::xd[0]) return f(IntC<S::xd[0]>{});
  if (G == S::xd[1]) return f(IntC<S::xd[1]>{});
  return cudaErrorInvalidValue;
}

// Pass 1 on a shared X, `lanes` >= 2 lanes in groups of up to G.
template <typename T>
cudaError_t launch_xtv_shared(const void* X, const void* v, const void* y, const void* at,
                              const void* ab, void* d, void* e_part, int n, int p,
                              Lanes<acc_t<T>> ls, int lanes, int G, cudaStream_t s) {
  using A = acc_t<T>;
  return xtv_group<T>(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    const dim3 grid((unsigned)((p + kCols - 1) / kCols) * lane_groups(lanes, kG));
    hinge_xtv_shared<T, kG><<<grid, kShThreads, 0, s>>>(
        static_cast<const T*>(X), static_cast<const A*>(v), static_cast<const A*>(y),
        static_cast<const A*>(at), static_cast<const A*>(ab), static_cast<A*>(d),
        static_cast<A*>(e_part), n, p, lanes, ls);
    return cudaGetLastError();
  });
}

// Pass 2 on a shared X, `lanes` >= 2 lanes in groups of up to G, `rows`
// rows (a multiple of 4 xd_rows(p)) a block. Dynamic shared memory: the
// largest group's chunks of d.
template <typename T>
cudaError_t launch_xd_shared(const void* X, const void* d, const void* e_part, int n_epart,
                             const void* y, const void* v, void* hv, void* part, int* ticket,
                             int n, int p, Lanes<acc_t<T>> ls, int lanes, int G, int rows,
                             cudaStream_t s) {
  using A = acc_t<T>;
  const int R = xd_rows(p);
  if (rows <= 0 || rows % (4 * R) != 0) return cudaErrorInvalidValue;
  return xd_group<T>(G, [&](auto g) {
    constexpr int kG = decltype(g)::value;
    const int ng = lane_groups(lanes, kG);
    const size_t smem = (size_t)((lanes + ng - 1) / ng) * chunk_slots<A>() * sizeof(A);
    const dim3 grid((unsigned)(ng * ((n + rows - 1) / rows)), xd_chunks(p));
    auto run = [&](auto kernel) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kShThreads, smem, s>>>(
          static_cast<const T*>(X), static_cast<const A*>(d), static_cast<const A*>(e_part),
          n_epart, static_cast<const A*>(y), static_cast<const A*>(v), static_cast<A*>(hv),
          static_cast<A*>(part), ticket, n, p, lanes, rows, ls);
      return cudaGetLastError();
    };
    return R == 4 ? run(hinge_xd_shared<T, 4, kG>) : run(hinge_xd_shared<T, 8, kG>);
  });
}

// Pass 2 on a stacked X (or one lane): a block per (lane, `rows` rows)
// and chunk, `rows` a positive multiple of xd_rows(p).
template <typename T>
cudaError_t launch_xd_stacked(const void* X, const void* d, const void* e_part, int n_epart,
                              const void* y, const void* v, void* hv, void* part, int* ticket,
                              int n, int p, Lanes<acc_t<T>> ls, int lanes, int rows,
                              cudaStream_t s) {
  using A = acc_t<T>;
  const int R = xd_rows(p);
  if (rows <= 0 || rows % R != 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(lanes * ((n + rows - 1) / rows)), xd_chunks(p));
  const T* Xt = static_cast<const T*>(X);
  const A *dA = static_cast<const A*>(d), *eA = static_cast<const A*>(e_part),
          *yA = static_cast<const A*>(y), *vA = static_cast<const A*>(v);
  A *hA = static_cast<A*>(hv), *pA = static_cast<A*>(part);
  if (R == 4) {
    hinge_xd_stacked<T, 4><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA,
                                                     ticket, n, p, lanes, rows, ls);
  } else {
    hinge_xd_stacked<T, 8><<<grid, kThreads, 0, s>>>(Xt, dA, eA, n_epart, yA, vA, hA, pA,
                                                     ticket, n, p, lanes, rows, ls);
  }
  return cudaGetLastError();
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
// lane (x_stride 0) or stacked, lane l's X at X + l x_stride (x_stride >=
// n p); y (n,) shared (y_stride 0) or (lanes, n) (y_stride n); v (lanes,
// n), at, ab, d (lanes, p), e_part (lanes, sven_hinge_xtv_blocks(p)), and
// t (lanes,): each lane's t in float64. Types as for sven_hinge_xtv.
// `group` 0 takes the stacked route (a lane per grid z); group G > 0 the
// shared-X route, in lane groups of up to G: X shared, at least 2 lanes,
// and G one of sven_hinge_shared_group(0, mode, i), else
// cudaErrorInvalidValue.
int sven_hinge_xtv_lanes(const void* X, int mode, long long x_stride, const void* v,
                         const void* y, long long y_stride, const void* at, const void* ab,
                         void* d, void* e_part, int n, int p, int lanes, const void* t,
                         int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group != 0 && (x_stride != 0 || lanes < 2)) return (int)cudaErrorInvalidValue;
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    const Lanes<acc_t<T>> ls = lanes_of<T>(x_stride, y_stride, t, nullptr);
    if (group != 0)
      return launch_xtv_shared<T>(X, v, y, at, ab, d, e_part, n, p, ls, lanes, group, s);
    return launch_xtv<T, true>(X, v, y, at, ab, d, e_part, n, p, 0.0, ls, lanes, s);
  });
}

// The i-th lane-group size (i = 0, 1) of the shared-X route of pass 1
// (pass 0) or pass 2 (pass 1) in `mode`; 0 for any other argument.
int sven_hinge_shared_group(int pass, int mode, int i) {
  if (pass < 0 || pass > 1 || i < 0 || i > 1) return 0;
  switch (mode) {
    case 0: case 1: return pass == 0 ? SharedG<float>::xtv[i] : SharedG<float>::xd[i];
    case 2: return pass == 0 ? SharedG<double>::xtv[i] : SharedG<double>::xd[i];
    default: return 0;
  }
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
    return launch_xd<T>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p, invt, twoC,
                        s);
  });
}

// Pass 2 for `lanes` problems in one launch. X, x_stride, y and y_stride as
// for sven_hinge_xtv_lanes; d (lanes, p), e_part (lanes, n_epart), v and hv
// (lanes, n), and t and C (lanes,) in float64. `group` 0 takes
// the stacked route, a block per lane and `rows` rows (a multiple of
// sven_hinge_xd_rows(p)); group G > 0 the shared-X route in lane groups of
// up to G (conditions as for sven_hinge_xtv_lanes, G one of
// sven_hinge_shared_group(1, mode, i)), `rows` rows a block (a multiple of
// 4 sven_hinge_xd_rows(p)). With more than one chunk, part (lanes, n,
// chunks) and ticket (ceil(lanes / max(G, 1)) x ceil(n / rows),), all 0 on
// entry and left 0.
int sven_hinge_xd_lanes(const void* X, int mode, long long x_stride, const void* d,
                        const void* e_part, int n_epart, const void* y, long long y_stride,
                        const void* v, void* hv, void* part, int* ticket, int n, int p,
                        int lanes, const void* t, const void* C, int group, int rows,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group != 0 && (x_stride != 0 || lanes < 2)) return (int)cudaErrorInvalidValue;
  return by_mode(mode, [&](auto tag) {
    using T = decltype(tag);
    const Lanes<acc_t<T>> ls = lanes_of<T>(x_stride, y_stride, t, C);
    if (group == 0)
      return launch_xd_stacked<T>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p, ls,
                                  lanes, rows, s);
    return launch_xd_shared<T>(X, d, e_part, n_epart, y, v, hv, part, ticket, n, p, ls,
                               lanes, group, rows, s);
  });
}

}  // extern "C"

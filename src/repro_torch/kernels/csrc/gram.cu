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
// y is treated as column p of an augmented (n, q) matrix A = [X, y], q = p+1,
// so P = X^T X, X^T y and y^T y are all entries of A^T A. A^T A is symmetric:
// the function needs its q(q+1)/2 distinct entries, n multiply-adds each.
//
// The TPU kernel carries its sums across a sequential k grid axis in VMEM
// scratch; CUDA blocks run in no order, so the sum over n is split instead:
//   1. a partial kernel: block k sums the upper entries (i <= j) of A^T A over
//      its own chunk of rows and writes them to part[k] (q x q);
//   2. gram_epilogue: one block per row i of P sums the partials of the
//      entries it reads (P_ij, u_i, u_j, s) over k in a fixed order
//      (deterministic: no float atomics), then writes the four quadrants.
// Ragged edges are masked, never padded in memory.
//
// Modes 0-2 (float32 sums): 0 = f32 (true fp32 FMA; TF32 is not used), 1 =
// tf32 (operands rounded with cvt.rna.tf32.f32, fp32 accumulation), 2 = bf16
// storage of X and y, fp32 accumulation. Their partial kernel (gram_partial)
// sums 64 x 64 tiles of A^T A in registers, 4 x 4 per thread, operands staged
// through shared memory; only tiles with tj >= ti run. At the YMSD shape (n =
// 463,715, p = 90) the f32 function is 3.9 GFLOP over 167 MB: bound by the
// card's fp32 FMA rate.
//
// Mode 3 (float64: X, y, partials, epilogue and K all double) is what a
// float64 problem runs at precision "f32". Its bound at the YMSD shape: bytes
// n q 8 = 337.6 MB / 3.35 TB/s = 0.101 ms; operations n q (q+1) = 3.88 GFLOP
// / 67 TFLOP/s (FP64 tensor peak) = 0.058 ms; so bytes bound it. Its partial
// kernel (gram_partial_f64) runs on the FP64 tensor cores:
//   - mma.sync m16n8k4 f64 (m8n8k4 runs at a lower rate on Hopper). With
//     the rows as the k dimension, lane l's element of the A fragment of an
//     8-column group g and 4 rows r0.. is A[r0 + (l & 3)][8g + (l >> 2)], and
//     its element of the B fragment of group g is the same: one 8-byte
//     shared-memory load per lane, group and 4 rows feeds every block of the
//     triangle that touches that group.
//   - Columns are padded to 96-column tiles (12 groups; q = 91 at p = 90 is
//     one tile). A block takes one pair (I, J), I <= J, of tiles and a chunk
//     of rows; only the pairs that work are launched. A warp owns a 32 x 32
//     warp tile (2 x 4 m16n8k4 products, 32 double accumulators per lane);
//     on the diagonal a tile skips the products wholly below it, so a
//     diagonal pair computes 84 of the 8 x 8 blocks' worth for its 78 upper
//     blocks (12,288 products per row in the old float64 tiling, 5,376 here).
//     A diagonal pair has 6 warp tiles, each run by two warps (even and odd
//     4-row steps), summed in a fixed order at the end; an off-diagonal pair
//     has 9, one warp each. 12 warps, one block per SM.
//   - Staging: rows arrive by 8-byte cp.async (any alignment of X, any p) in
//     32-row stages, three buffers, so two stages load while one computes.
//     y goes into column p; columns past q and rows past the chunk are
//     zero-filled by the copy itself. The row pitch is 4 (mod 16) doubles,
//     so a half-warp's fragment loads (rows 0-3 x columns 0-3) hit 16
//     distinct 8-byte banks.
//   - One wave: the row split gives one block per SM when the pairs are
//     fewer than the SMs. Every entry is summed in a fixed order (k-steps in
//     row order within a warp, the two warps of a diagonal tile in warp
//     order, the blocks' partials in k order in the epilogue), so K is
//     bitwise repeatable.
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

// The type every product and sum of modes 0-2 is taken in.
template <typename T> using acc_t = float;

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

// Four neighbouring shared-memory entries: one float4.
__device__ __forceinline__ void ld4(const float* s, float (&a)[kMicro]) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
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

// ---- mode 3: the float64 partial kernel on the FP64 tensor cores -----------

namespace f64 {

constexpr int kEdge = 96;                 // columns of a tile: 12 groups of 8
constexpr int kBand = 32;                 // edge of a warp tile: 4 groups
constexpr int kBands = kEdge / kBand;     // warp tiles along a tile edge
constexpr int kStage = 32;                // rows per stage: 8 steps of 4
constexpr int kBuf = 3;                   // stage buffers in shared memory
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitWarps = 6;            // warp tiles of a diagonal pair
// Row pitch, 4 (mod 16) doubles: a diagonal pair stages 96 columns, an
// off-diagonal pair 192.
__host__ __device__ constexpr int pitch(bool diag) { return (diag ? 1 : 2) * kEdge + 4; }

// D += A B, A 16 x 4 (a0: rows 0-7, a1: rows 8-15), B 4 x 8, all float64.
__device__ __forceinline__ void mma(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// dst = *src if bytes is 8, else 0 (nothing is read).
__device__ __forceinline__ void cp_async8(double* dst, const double* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A warp tile's sums: [h][j] is the 16 x 8 product of row groups 2h, 2h+1
// with column group j; lane l holds rows l/4 and l/4 + 8, columns 2(l%4)
// and 2(l%4) + 1.
using Acc = double[2][4][4];

// One 4-row step of a warp tile. s is the staged row of the step's first
// row (row pitch rowp); the tile's row groups start at column ra, its
// column groups at cb.
// `same` (a tile on the diagonal, ra = cb) skips the products that lie
// wholly below the diagonal.
__device__ __forceinline__ void tile_step(const double* s, int rowp, int ra, int cb,
                                          bool same, Acc& acc) {
  const int lane = threadIdx.x & 31;
  const double* r = s + (lane & 3) * rowp + (lane >> 2);
  double fa[4], fb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) fa[i] = r[ra + 8 * i];
#pragma unroll
  for (int j = 0; j < 4; ++j) fb[j] = same ? fa[j] : r[cb + 8 * j];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (!same || j >= 2 * h) mma(acc[h][j], fa[2 * h], fa[2 * h + 1], fb[j]);
}

// The entries (i <= j < q) of a warp tile whose first row group is gi0 and
// first column group gj0, into out (leading dimension q).
__device__ __forceinline__ void tile_store(const Acc& acc, double* out, int q, int gi0,
                                           int gj0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * (gi0 + 2 * h + (e >> 1)) + (lane >> 2);
        const int c = 8 * (gj0 + j) + 2 * (lane & 3) + (e & 1);
        if (i <= c && c < q) out[(int64_t)i * q + c] = acc[h][j][e];
      }
}

// Block (x, k): tile pair x of the nt (nt + 1) / 2 upper pairs (row-major),
// rows [k R, min(n, (k+1) R)) with R = rows_per_split, a multiple of kStage.
__global__ void __launch_bounds__(kThreads, 1)
gram_partial_f64(const double* __restrict__ X, const double* __restrict__ y,
                 double* __restrict__ part, int n, int p, int rows_per_split, int nt) {
  extern __shared__ __align__(16) double smem[];
  int I = 0, rem = blockIdx.x;
  while (rem >= nt - I) rem -= nt - I++;
  const int J = I + rem;
  const bool diag = I == J;
  const int width = diag ? kEdge : 2 * kEdge;
  const int rowp = pitch(diag);
  const int q = p + 1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < n ? r0 + rows_per_split : (int64_t)n;
  const int nstage = (int)((r1 - r0 + kStage - 1) / kStage);

  // The loader: a thread copies one staged column, every (kThreads /
  // width)-th row; its source is a column of X, y, or nothing (zeros).
  const int col = threadIdx.x % width;
  const int rstep = kThreads / width;
  const int gc = col < kEdge ? I * kEdge + col : J * kEdge + col - kEdge;
  const double* src = gc < p ? X + gc : y;
  const int64_t stride = gc < p ? p : 1;
  const bool real = gc <= p;
  auto load = [&](int s) {
    double* dst = smem + (s % kBuf) * (kStage * rowp) + col;
    const int64_t rb = r0 + (int64_t)s * kStage;
    for (int rr = threadIdx.x / width; rr < kStage; rr += rstep) {
      const bool ok = real && rb + rr < r1;
      cp_async8(dst + rr * rowp, ok ? src + (rb + rr) * stride : src, ok ? 8 : 0);
    }
  };

  // This warp's tile (a, b) and 4-row steps. Diagonal pair: warp tiles (a <=
  // b) in an order that gives the SM's four schedulers (warp w on w % 4)
  // equal work; warps w and w + 6 share a tile, taking even and odd steps.
  // Off-diagonal pair: warp w < 9 takes tile (w / 3, w % 3), every step.
  const int warp = threadIdx.x >> 5;
  const int tile = diag ? warp % kSplitWarps : warp;
  const bool active = diag || warp < kBands * kBands;
  const int a = diag ? (0x210100 >> (4 * tile)) & 15 : tile / kBands;
  const int b = diag ? (0x222110 >> (4 * tile)) & 15 : tile % kBands;
  const int half = diag ? warp / kSplitWarps : 0;
  const int kstep = diag ? 2 : 1;
  const bool same = diag && a == b;
  const int ra = a * kBand, cb = (diag ? 0 : kEdge) + b * kBand;
  Acc acc;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0;

  for (int s = 0; s < kBuf - 1; ++s) {
    if (s < nstage) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<kBuf - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();            // ... everyone's; and stage s - 1 is consumed
    if (s + kBuf - 1 < nstage) load(s + kBuf - 1);
    cp_async_commit();
    if (active) {
      const double* st = smem + (s % kBuf) * (kStage * rowp);
      for (int k = half; k < kStage / 4; k += kstep)
        tile_step(st + 4 * k * rowp, rowp, ra, cb, same, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  if (diag) {  // odd steps' sums into the even steps' warp, through shared memory
    const int lane = threadIdx.x & 31;
    double* red = smem + tile * 32 * 32 + lane;
    if (half == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((h * 4 + j) * 4 + e) * 32] = acc[h][j][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] += red[((h * 4 + j) * 4 + e) * 32];
  }
  if (!active) return;
  constexpr int kGroups = kEdge / 8, kBandGroups = kBand / 8;
  tile_store(acc, part + (int64_t)blockIdx.y * q * q, q, I * kGroups + a * kBandGroups,
             J * kGroups + b * kBandGroups);
}

// One warp: A = S (4 x 64, row-major, staged at the kernel's pitch for an
// off-diagonal pair); D (64 x 64) gets the entries i <= j of A^T A that a
// diagonal warp tile (columns 0-31) and an off-diagonal one (rows 0-31,
// columns 32-63) compute, through the kernel's own fragment loads, products
// and stores. Checks the fragment layout on the card.
__global__ void mma_probe(const double* __restrict__ S, double* __restrict__ D) {
  constexpr int kLd = pitch(false);
  __shared__ double s[4 * kLd];
  for (int e = threadIdx.x; e < 4 * 64; e += 32) s[(e / 64) * kLd + e % 64] = S[e];
  __syncwarp();
  for (int off = 0; off < 2; ++off) {
    Acc acc = {};
    tile_step(s, kLd, 0, off * kBand, off == 0, acc);
    tile_store(acc, D, 64, 0, off * (kBand / 8));
  }
}

}  // namespace f64

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
  const A scale = A(1.0 / t);
  gram_epilogue<A><<<p, 128, 0, stream>>>(static_cast<const A*>(part),
                                          static_cast<A*>(K), p, nsplit, scale, flat);
  return cudaGetLastError();
}

cudaError_t launch_f64(const void* X, const void* y, void* part, void* K, int n, int p,
                       int rows_per_split, int nsplit, double t, int flat,
                       cudaStream_t stream) {
  const int nt = (p + 1 + f64::kEdge - 1) / f64::kEdge;
  // a block's stage buffers, at the pitch of the widest pair in the grid
  const int smem = f64::kBuf * f64::kStage * f64::pitch(nt == 1) * (int)sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      f64::gram_partial_f64, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  f64::gram_partial_f64<<<dim3(nt * (nt + 1) / 2, nsplit), f64::kThreads, smem, stream>>>(
      static_cast<const double*>(X), static_cast<const double*>(y),
      static_cast<double*>(part), n, p, rows_per_split, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_epilogue<double><<<p, 128, 0, stream>>>(static_cast<const double*>(part),
                                               static_cast<double*>(K), p, nsplit, t,
                                               flat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of each split and the tile edge the Python wrapper sizes `part` by:
// modes 0-2, and mode 3 (float64).
int sven_gram_tile() { return kTile; }
int sven_gram_rows_step() { return kRows; }
int sven_gram_tile_f64() { return f64::kEdge; }
int sven_gram_rows_step_f64() { return f64::kStage; }

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
      return launch_f64(X, y, part, K, n, p, rows_per_split, nsplit, t, flat, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// S (4, 64) and D (64, 64) float64 on the card: see f64::mma_probe.
int sven_gram_f64_probe(const void* S, void* D, void* stream) {
  f64::mma_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(S), static_cast<double*>(D));
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Ragged edges are masked, never padded in memory. Each mode has its own
// partial kernel (modes 0-2 one template on their product step) and shares
// the epilogue (float sums in modes 0-2, double in mode 3). At the YMSD
// shape (n = 463,715, p = 90) on an H100:
//
//   mode  X, y      products            partial kernel                 bound
//   0 f32  float    fp32 FMA (no TF32)  tc::gram_partial<Fma>          3.9 GFLOP / 67 TFLOP/s = 0.058 ms
//   1 tf32 float    TF32 tensor cores   tc::gram_partial<Tc<float>>    168.8 MB / 3.35 TB/s = 0.050 ms
//   2 bf16 bfloat16 BF16 tensor cores   tc::gram_partial<Tc<bf16>>     84.5 MB / 3.35 TB/s = 0.025 ms
//   3 f64  double   FP64 tensor cores   f64::gram_partial_f64          337.6 MB / 3.35 TB/s = 0.101 ms
//
// Mode 0 (float32: what a float32 problem runs at precision "f32", exact
// float32 FMAs as the plain version and JAX's Precision.HIGHEST compute) is
// bound by its operations: its FMAs, not its reads (168.8 MB, 0.050 ms), set
// the pace, and the FP32 pipe takes one warp instruction per clock per
// scheduler, so every other instruction costs an FMA slot. It shares modes
// 1-2's staging and plan (tc::gram_partial; below) and differs in its step,
// tc::Fma:
//   - 16 warps. A lane sums an 8 x 8 register tile of the pair's A^T A (64
//     float32 accumulators) over every nph-th row; only tiles on or above
//     the diagonal run: 78 on a diagonal pair (4,992 FMAs a row for its
//     4,656 upper entries; 4,186 are needed at q = 91), 6 row phases, 468 of
//     the 512 lanes busy. An off-diagonal pair has 144 tiles, 3 phases.
//   - Shared memory feeds 32 four-byte words per SM per clock against 128
//     FMAs, so a lane takes its 16 operands of a row by four 16-byte loads
//     (16 FMAs a load). A flat row of 90 floats is not 16-byte aligned, so
//     each stage is repacked first, while the one before is summed (one
//     barrier a stage): 384 threads copy one column each into rows of 96
//     (192 for an off-diagonal pair) columns at a pitch of 4 (mod 32) floats,
//     y into column p and zeros past it, which also drops the y swap and the
//     edge masks from the inner loop. Rows past the chunk are not summed.
//     Flat stages hold 96 rows (219 KB of shared memory at p = 90), wide
//     ones 48.
//   - The lanes of a tile are added in phase order at the end, through
//     shared memory: no float atomics, K bitwise repeatable.
//   - At YMSD it runs ahead of cuBLAS's A^T A but far from its bound
//     (PERF.md): scratch variants without the FMAs, without the shared
//     loads or without the repack were each only a little faster, twice the
//     warps or more stage buffers barely mattered, and halving the barriers
//     (96-row stages) helped most, with the SM clock at its maximum.

// Mode 3 (float64: X, y, partials, epilogue and K all double) is what a
// float64 problem runs at precision "f32". Its operations, n q (q+1) = 3.88
// GFLOP / 67 TFLOP/s (FP64 tensor peak) = 0.058 ms, are under its bytes.
// Its partial kernel (f64::gram_partial_f64):
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
//
// Modes 1 and 2 (tf32, bf16: float32 sums of products taken on the tensor
// cores, what the TPU kernel's Precision.DEFAULT does on its matrix unit)
// share one partial kernel, tc::gram_partial with the step tc::Tc, on the
// float64 body's plan:
//   - mma.sync m16n8k8 tf32 (operands rounded to nearest by cvt.rna.tf32.f32,
//     as the plain version rounds them; products of TF32 values are exact in
//     float32) and m16n8k16 bf16, float32 accumulators. Rows are the k
//     dimension, and one fragment per 8-column group serves both operands:
//     lane l works on column 8c + (l >> 2) of group c and holds rows
//     (l & 3) and (l & 3) + 4 of an 8-row step (tf32), or the row pairs
//     2(l & 3), +1 and 2(l & 3) + 8, +9 of a 16-row step packed into one
//     register each (bf16). Those two registers are the A fragment's (a0, a2)
//     or (a1, a3), as the group is the upper or lower half of an m16 tile,
//     and the B fragment's (b0, b1).
//   - Reads bound both modes: their padded products take 5 GFLOP, 0.005-0.01
//     ms at the tensor peaks. But mma.sync is the one tensor-core path here
//     (no wgmma), and at YMSD the products alone take most of the reads'
//     time (bf16) or more (tf32), so the design keeps the loads per product
//     low. A block takes one pair of 96-column tiles and a chunk of rows, one
//     8-warp block per SM, in one wave. A diagonal pair's triangle (42
//     products per step: 6 bands of 16 columns, band h against column groups
//     2h..11) is split between two warps as bands 0-1 (22 products, 12
//     fragments) and 2-5 (20, 8), each on every fourth step: each fragment,
//     loaded once a warp, feeds 2-12 products. An off-diagonal pair's 96 x
//     96 block is four 48 x 48 quadrants (18 products, 12 fragments), each on
//     every other step. The warps of a part are added in phase order at the
//     end, through shared memory.
//   - Stages are sized by bytes: 128 rows of bf16 or 64 of float32, 23 KB at
//     p = 90. One tile (q <= 96, the main path) is staged flat: a chunk of
//     rows of a contiguous X is one byte range; its whole 16-byte lines go by
//     one cp.async.bulk on the copy engine, counted by the stage's mbarrier,
//     and the last part line by cp.async, so X lands at a shift of (address
//     mod 16) and no alignment of X or parity of p is needed. Four buffers
//     keep three stages (69 KB) in flight per SM, past the ~25 KB that 3.35
//     TB/s x ~1 us / 132 SMs asks for; more buffers, the copy cut in pieces,
//     or twice the rows did not read faster. Wider A reads only its two
//     tiles' columns: each row's 96 columns by 4-byte cp.async from the
//     4-byte word that holds the first (shift 0 or 1 bf16 element by row),
//     three buffers of 200-element rows. y is staged flat beside X and stands
//     in for the lane's column where that column is p; other columns past p
//     are read as whatever lies there, which reaches only the products of
//     rows or columns past p, never stored; rows past the chunk read a zeroed
//     strip. Fragments are built by 2-byte (bf16) or 4-byte shared-memory
//     loads, since a flat row of 180 bytes is not 16-byte aligned for
//     ldmatrix.
//   - Accumulation: bf16 chains each accumulator through its warp's products
//     (56 at the YMSD split) and lands as close to the plain version as
//     shorter chains did. The tensor cores' tf32 sums round in their own way
//     and drift over a chain (the y^T y entry is a sum of positive terms), so
//     every tf32 product starts from zero and its sums are added to the
//     accumulators in float32, as an FMA chain would add them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u & 0xFFFFE000u);
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

// ---- modes 1 and 2: the tf32 and bf16 partial kernel on the tensor cores ---

namespace tc {

using f64::cp_async_commit;
using f64::cp_async_wait;

constexpr int kEdge = 96;           // columns of a tile: 12 groups of 8
constexpr int kGroups = kEdge / 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSegOff = 100;        // wide rows: where tile J's columns are staged
constexpr int kZero = 208;          // zeros read in place of rows past the chunk
// m16n8 products a warp sums per step, at most. A diagonal pair's triangle
// has 42 (6 row bands of 16 columns, band h against column groups 2h..11),
// split between two warps as bands 0-1 (22) and 2-5 (20); an off-diagonal
// pair's 96 x 96 block has 72, in four 48 x 48 quadrants (18).
constexpr int kMmas = 22;
// Shared memory of the end's sum over the warps of a role.
constexpr int kRedBytes = kWarps * kMmas * 4 * 32 * (int)sizeof(float);
// Staged row pitch of the wide route, in elements: one tile (diagonal pair)
// or two. A fragment load of lane l reads row 2(l & 3) (bf16) or l & 3
// (tf32), 4 (l & 3) pitch bytes from lane l & ~3's either way: 104 and 200
// put lanes l & 3 = 0..3 in distinct banks.
__host__ __device__ constexpr int pitch(bool diag) { return diag ? 104 : 200; }
// Product (h, j) of a diagonal pair's triangle.
__host__ __device__ constexpr int tri(int h, int j) { return h * (13 - h) + j - 2 * h; }

// dst = the first `bytes` of the 16 (4) bytes at src, zero-filled after them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}

// The `count` elements at src, copied from the 16-byte line that holds src
// by a block of kN threads: the first lands at dst + (src mod 16) / sizeof(T).
template <int kN, typename T>
__device__ __forceinline__ void copy_flat(T* dst, const T* src, int count) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a1 = a0 + (uintptr_t)count * sizeof(T);
  const uintptr_t line = a0 & ~(uintptr_t)15;
  const int chunks = (int)((a1 - line + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += kN) {
    const uintptr_t s = line + 16 * (uintptr_t)c;
    cp_async16(reinterpret_cast<char*>(dst) + 16 * c, reinterpret_cast<const void*>(s),
               (int)(a1 - s < 16 ? a1 - s : 16));
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
// One bulk copy of `bytes` (a multiple of 16, 16-byte aligned ends) on the
// copy engine, counted by `bar`, whose phase then completes (also for 0 bytes).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred P; mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2; "
        "selp.u32 %0, 1, 0, P; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T>
__device__ __forceinline__ int shift_of(const T* src, uintptr_t align) {
  return (int)((reinterpret_cast<uintptr_t>(src) & (align - 1)) / sizeof(T));
}

template <typename T> struct Mma;

// bf16: m16n8k16. Lane rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step (t = l & 3),
// packed in pairs, the lower row in the low half.
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kStep = 16;    // rows of one product (its k)
  static constexpr int kStage = 128;  // rows of one stage
  static constexpr int kLaneRows = 4;
  static __device__ int row(int i, int t) { return (i >> 1) * 8 + 2 * t + (i & 1); }
  // The fragment of the lane's column at offset kk of the staged rows at o.
  static __device__ void frag(const __nv_bfloat16* s, const int (&o)[kLaneRows], int kk,
                              uint32_t (&f)[2]) {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(s);
    f[0] = h[o[0] + kk] | (uint32_t)h[o[1] + kk] << 16;
    f[1] = h[o[2] + kk] | (uint32_t)h[o[3] + kk] << 16;
  }
  // D += A B, A 16 x 16, B 16 x 8, D chained through the tensor cores.
  static __device__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// tf32: m16n8k8. Lane rows t, t+4 of an 8-row step, rounded to TF32.
template <> struct Mma<float> {
  static constexpr int kStep = 8;
  static constexpr int kStage = 64;
  static constexpr int kLaneRows = 2;
  static __device__ int row(int i, int t) { return 4 * i + t; }
  static __device__ void frag(const float* s, const int (&o)[kLaneRows], int kk,
                              uint32_t (&f)[2]) {
    f[0] = __float_as_uint(to_tf32(s[o[0] + kk]));
    f[1] = __float_as_uint(to_tf32(s[o[1] + kk]));
  }
  // D += A B, A 16 x 8, B 8 x 8: the product from zero, its sums added to D
  // in float32 (a chain through the tensor cores drifts in tf32).
  static __device__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    float c[4];
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += c[e];
  }
};

// A warp's sums; product m's 16 x 8 block: lane l holds rows l/4 and l/4 + 8,
// columns 2(l%4) and 2(l%4) + 1.
using Acc = float[kMmas][4];

// The fragment of column group c (lane column at staged offset kk + 8c, which
// is column p where 8c + (l >> 2) == pc); y stands in there.
template <typename T>
__device__ __forceinline__ void group(const T* s, const int (&o)[Mma<T>::kLaneRows],
                                      const uint32_t (&fy)[2], int kk, int pc, int c,
                                      uint32_t (&f)[2]) {
  Mma<T>::frag(s, o, kk + 8 * c, f);
  if (8 * c + ((threadIdx.x & 31) >> 2) == pc) f[0] = fy[0], f[1] = fy[1];
}

// One step of bands H0..H1-1 of a diagonal pair's triangle: the fragments of
// column groups 2 H0..11 (staged from offset 0), each serving both operands,
// and the products of band h (groups 2h, 2h + 1) with groups 2h..11; product
// (h, j) into acc[tri(h, j) - tri(H0, 2 H0)]. Its block below the diagonal
// is summed and not stored.
template <int H0, int H1, typename T>
__device__ __forceinline__ void step_bands(const T* s, const int (&o)[Mma<T>::kLaneRows],
                                           const uint32_t (&fy)[2], int pc, Acc& acc) {
  uint32_t f[kGroups][2];
#pragma unroll
  for (int c = 2 * H0; c < kGroups; ++c) group(s, o, fy, 0, pc, c, f[c]);
#pragma unroll
  for (int h = H0; h < H1; ++h) {
    const uint32_t a[4] = {f[2 * h][0], f[2 * h + 1][0], f[2 * h][1], f[2 * h + 1][1]};
#pragma unroll
    for (int j = 2 * h; j < kGroups; ++j)
      Mma<T>::mma(acc[tri(h, j) - tri(H0, 2 * H0)], a, f[j]);
  }
}

// One step of a 48 x 48 quadrant of an off-diagonal pair: six row groups at
// staged offset ka (tile I), six column groups at kb (tile J), 18 products.
template <typename T>
__device__ __forceinline__ void step_quad(const T* s, const int (&o)[Mma<T>::kLaneRows],
                                          const uint32_t (&fy)[2], int ka, int pa, int kb,
                                          int pb, Acc& acc) {
  uint32_t fa[6][2], fb[6][2];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    group(s, o, fy, ka, pa, c, fa[c]);
    group(s, o, fy, kb, pb, c, fb[c]);
  }
#pragma unroll
  for (int h = 0; h < 3; ++h) {
    const uint32_t a[4] = {fa[2 * h][0], fa[2 * h + 1][0], fa[2 * h][1], fa[2 * h + 1][1]};
#pragma unroll
    for (int j = 0; j < 6; ++j) Mma<T>::mma(acc[6 * h + j], a, fb[j]);
  }
}

// Sum e of the lane's part of a product whose row groups start at gi and
// column group is gj, into out (leading dimension q) where i <= c < q.
__device__ __forceinline__ void put(float v, float* out, int q, int gi, int gj, int e) {
  const int lane = threadIdx.x & 31;
  const int i = 8 * (gi + (e >> 1)) + (lane >> 2);
  const int c = 8 * gj + 2 * (lane & 3) + (e & 1);
  if (i <= c && c < q) out[(int64_t)i * q + c] = v;
}

// The sums of step_bands<H0, H1> on a diagonal pair whose first group is g0.
template <int H0, int H1>
__device__ __forceinline__ void store_bands(const Acc& acc, float* out, int q, int g0) {
#pragma unroll
  for (int h = H0; h < H1; ++h)
#pragma unroll
    for (int j = 2 * h; j < kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put(acc[tri(h, j) - tri(H0, 2 * H0)][e], out, q, g0 + 2 * h, g0 + j, e);
}

// The sums of step_quad: row groups from gi, column groups from gj.
__device__ __forceinline__ void store_quad(const Acc& acc, float* out, int q, int gi,
                                           int gj) {
#pragma unroll
  for (int h = 0; h < 3; ++h)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) put(acc[6 * h + j][e], out, q, gi + 2 * h, gj + j, e);
}

// Where stage st lies in shared memory s: rows = its rows, X row r's staged
// columns from x(r) (the pair's tile I; tile J's from x(r) + kSegOff on the
// wide route), y from ys, zbase the zeroed strip.
template <typename T, bool kFlat>
struct Staged {
  const T* s;
  const T* X;
  int64_t rs;   // the stage's first row of X
  int rows, p, rowp, xs, ys, zbase;
  __device__ int x(int r) const {
    return kFlat ? xs + r * p : xs + r * rowp + shift_of(X + (rs + r) * p, 4);
  }
};

// Modes 1 and 2's product step (tensor cores) on a landed stage.
template <typename T>
struct Tc {
  using Elem = T;
  using M = Mma<T>;
  static constexpr int kThreads = tc::kThreads;
  __host__ __device__ static constexpr int stage(bool) { return M::kStage; }   // rows
  static constexpr int kLag = 0;   // a stage is summed in the step it lands
  // shared memory past the stages (elements), and the end's sum (bytes)
  static constexpr int extra(bool) { return 0; }
  static constexpr int red_bytes() { return kRedBytes; }

  // This warp's part (role) and steps. Diagonal pair: bands 0-1 (w even) or
  // 2-5 (w odd), every fourth step from w / 2. Off-diagonal pair: quadrant
  // (qa, qb) = ((w % 4) / 2, w % 2), every other step from w / 4.
  int I, J, warp, lane, nrole, role, ph, nph, qa, qb, t, ka, kb, pa, pb;
  bool diag;
  Acc acc;

  __device__ Tc(int I_, int J_, bool diag_, int p, T*, int) : I(I_), J(J_), diag(diag_) {
    warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    nrole = diag ? 2 : 4, role = warp % nrole;
    ph = warp / nrole, nph = kWarps / nrole;
    qa = role >> 1, qb = role & 1;
    t = lane & 3;
    ka = 48 * qa, kb = kSegOff + 48 * qb;
    pa = p - (I * kEdge + (diag ? 0 : 48 * qa)), pb = p - (J * kEdge + 48 * qb);
#pragma unroll
    for (int m = 0; m < kMmas; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
  }

  template <bool kFlat>
  __device__ void take(const Staged<T, kFlat>& g, int) {
    for (int k = ph; k * M::kStep < g.rows; k += nph) {
      int xo[M::kLaneRows], yo[M::kLaneRows];
#pragma unroll
      for (int i = 0; i < M::kLaneRows; ++i) {
        const int r = k * M::kStep + M::row(i, t);
        xo[i] = (r < g.rows ? g.x(r) : g.zbase) + (lane >> 2);
        yo[i] = r < g.rows ? g.ys + r : g.zbase;
      }
      uint32_t fy[2];
      M::frag(g.s, yo, 0, fy);
      if (!diag) step_quad(g.s, xo, fy, ka, pa, kb, pb, acc);
      else if (role == 0) step_bands<0, 2>(g.s, xo, fy, pa, acc);
      else step_bands<2, 6>(g.s, xo, fy, pa, acc);
    }
  }
  __device__ void sum(int, int) {}

  // The warps of a role add their sums to its first warp's in phase order,
  // through shared memory (lane-major: no bank conflicts); that warp stores.
  __device__ void finish(unsigned char* smem, float* out, int q) {
    float* const red = reinterpret_cast<float*>(smem) + lane;
    if (ph > 0) {
#pragma unroll
      for (int m = 0; m < kMmas; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((warp * kMmas + m) * 4 + e) * 32] = acc[m][e];
    }
    __syncthreads();
    if (ph > 0) return;
    for (int f = 1; f < nph; ++f) {
      const float* other = red + (f * nrole + role) * kMmas * 4 * 32;
#pragma unroll
      for (int m = 0; m < kMmas; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][e] += other[(m * 4 + e) * 32];
    }
    if (!diag) store_quad(acc, out, q, I * kGroups + 6 * qa, J * kGroups + 6 * qb);
    else if (role == 0) store_bands<0, 2>(acc, out, q, I * kGroups);
    else store_bands<2, 6>(acc, out, q, I * kGroups);
  }
};

// Mode 0's product step: float32 FMAs on the FP32 pipes (no tensor cores),
// 16 warps. A lane sums an 8 x 8 tile of the pair's A^T A (columns a of tile
// I against columns b of tile J, 8 each) in 64 registers, over every nph-th
// row of each stage. A diagonal pair has 78 tiles on or above the diagonal
// (b >= a), 6 row phases, 468 busy lanes; an off-diagonal pair 144 tiles, 3
// phases, 432 lanes. Each lane takes its 16 operands of a row by four
// 16-byte shared loads, 16 FMAs a load: flat rows of 90 floats are not
// 16-byte aligned, so a stage is first repacked (kLag: while the one before
// is summed) into rows of 96 or 192 columns at a pitch of 4 (mod 32)
// floats, y in column p and zeros past it.
struct Fma {
  using Elem = float;
  static constexpr int kThreads = 512;
  // rows of one stage: the flat route's 96 halve the barriers; the wide
  // route's 200-float staged rows fit only 48 beside the repacked stages
  __host__ __device__ static constexpr int stage(bool flat) { return flat ? 96 : 48; }
  static constexpr int kLag = 1;        // stage st is repacked while st - 1 is summed
  static constexpr int kRepack = 384;   // threads that repack: one column each
  __host__ __device__ static constexpr int pitch(bool diag) { return diag ? 100 : 196; }
  __host__ __device__ static constexpr int tiles(bool diag) { return diag ? 78 : 144; }
  __host__ __device__ static constexpr int phases(bool diag) { return diag ? 6 : 3; }
  // two repacked stages past the staged ones, at the widest pitch in the grid
  static constexpr int extra(bool one) { return 2 * stage(one) * pitch(one); }
  // the end's sum: every phase but the first, 64 sums a lane
  static constexpr int red_bytes() { return (phases(true) - 1) * tiles(true) * 64 * 4; }

  float acc[8][8];
  float* R;   // the two repacked stages
  int I, J, p, P, span, nph, ph, ao, bo, gi0, gj0;   // span: floats of a repacked stage
  bool diag, active;

  __device__ Fma(int I_, int J_, bool diag_, int p_, float* rbuf, int rows)
      : R(rbuf), I(I_), J(J_), p(p_), diag(diag_) {
    const int nt = tiles(diag), tile = threadIdx.x % nt;
    P = pitch(diag), span = rows * P, nph = phases(diag);
    ph = threadIdx.x / nt, active = ph < nph;
    int a = 0, b;
    if (diag) {   // the tiles row by row: band a has 12 - a
      int rem = tile;
      while (rem >= 12 - a) rem -= 12 - a, ++a;
      b = a + rem;
    } else {
      a = tile / 12, b = tile % 12;
    }
    ao = 8 * a, bo = (diag ? 0 : kEdge) + 8 * b;
    gi0 = I * kEdge + 8 * a, gj0 = J * kEdge + 8 * b;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // Stage st into repacked buffer st & 1: a thread copies one column (of 96
  // or 192), every (kRepack / width)-th row; its source is a column of X
  // (float rows land unshifted on the wide route), y, or the zeroed strip.
  template <bool kFlat>
  __device__ void take(const Staged<float, kFlat>& g, int st) {
    if (threadIdx.x >= kRepack) return;
    const int width = diag ? kEdge : 2 * kEdge;
    const int c = threadIdx.x % width, seg = c >= kEdge, cc = c - seg * kEdge;
    const int gc = (seg ? J : I) * kEdge + cc;
    int src = g.zbase, stride = 0;
    if (gc < p) {
      src = kFlat ? g.xs + gc : g.xs + seg * kSegOff + cc;
      stride = g.rowp;
    } else if (gc == p) {
      src = g.ys;
      stride = 1;
    }
    float* dst = R + (st & 1) * span + c;
#pragma unroll 4
    for (int r = threadIdx.x / width; r < g.rows; r += kRepack / width)
      dst[r * P] = g.s[src + r * stride];
  }

  // The rows of repacked stage st: row r's FMAs into the lane's tile.
  __device__ void sum(int st, int rows) {
    if (!active) return;
    const float* row = R + (st & 1) * span + ph * P;
#pragma unroll 2
    for (int r = ph; r < rows; r += nph, row += nph * P) {
      float a[8], b[8];
      const float4* va = reinterpret_cast<const float4*>(row + ao);
      const float4* vb = reinterpret_cast<const float4*>(row + bo);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 u = va[k], v = vb[k];
        a[4 * k] = u.x, a[4 * k + 1] = u.y, a[4 * k + 2] = u.z, a[4 * k + 3] = u.w;
        b[4 * k] = v.x, b[4 * k + 1] = v.y, b[4 * k + 2] = v.z, b[4 * k + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // The lanes of a tile add their sums to its first phase's in phase order,
  // through shared memory (tile-major: no bank conflicts); that lane stores
  // the entries i <= j < q.
  __device__ void finish(unsigned char* smem, float* out, int q) {
    float* const red = reinterpret_cast<float*>(smem);
    const int nt = tiles(diag), tile = threadIdx.x % nt;
    if (active && ph > 0) {
#pragma unroll
      for (int k = 0; k < 64; ++k) red[((ph - 1) * 64 + k) * nt + tile] = acc[k / 8][k % 8];
    }
    __syncthreads();
    if (!active || ph > 0) return;
    for (int f = 1; f < nph; ++f) {
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[k / 8][k % 8] += red[((f - 1) * 64 + k) * nt + tile];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gi = gi0 + i, gj = gj0 + j;
        if (gi <= gj && gj < q) out[(int64_t)gi * q + gj] = acc[i][j];
      }
  }
};

// Block (x, k): tile pair x of the nt (nt + 1) / 2 upper pairs (row-major),
// rows [k R, min(n, (k+1) R)) with R = rows_per_split; the step S (Tc<T> or
// Fma) sums each stage. kFlat (nt = 1): rows staged flat, xstage elements a
// buffer; else each row's tile columns.
__host__ __device__ constexpr int buffers(bool flat) { return flat ? 4 : 3; }
template <typename S, bool kFlat>
__global__ void __launch_bounds__(S::kThreads, 1)
gram_partial(const typename S::Elem* __restrict__ X, const typename S::Elem* __restrict__ y,
             float* __restrict__ part, int n, int p, int rows_per_split, int nt, int xstage) {
  using T = typename S::Elem;
  constexpr int kBuf = buffers(kFlat);
  constexpr int kStage = S::stage(kFlat);     // rows of one stage
  constexpr int kVec = 16 / (int)sizeof(T);   // elements of a 16-byte copy
  constexpr int kYStage = kStage + kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kBuf];             // flat X stages' copy barriers
  T* const s = reinterpret_cast<T*>(smem);    // offsets below are into s
  const int ybase = kBuf * xstage, zbase = ybase + kBuf * kYStage;

  int I = 0, rem = blockIdx.x;
  while (rem >= nt - I) rem -= nt - I++;
  const int J = I + rem;
  const bool diag = kFlat || I == J;
  const int q = p + 1;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t r1 = r0 + rows_per_split < n ? r0 + rows_per_split : (int64_t)n;
  const int nstage = (int)((r1 - r0 + kStage - 1) / kStage);
  const int rowp = kFlat ? p : pitch(diag);
  auto rows_of = [&](int st) {
    const int64_t left = r1 - r0 - (int64_t)st * kStage;
    return (int)(left < kStage ? left : kStage);
  };

  for (int e = threadIdx.x; e < kZero * (int)sizeof(T) / 4; e += S::kThreads)
    reinterpret_cast<uint32_t*>(s + zbase)[e] = 0u;
  if (kFlat && threadIdx.x == 0) {
    for (int b = 0; b < kBuf; ++b) bar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int st) {
    const int64_t rs = r0 + (int64_t)st * kStage;
    const int rows = rows_of(st);
    T* dx = s + (st % kBuf) * xstage;
    copy_flat<S::kThreads>(s + ybase + (st % kBuf) * kYStage, y + rs, rows);
    if constexpr (kFlat) {
      // the whole 16-byte lines by one bulk copy, the last part line apart
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(X + rs * p);
      const uintptr_t a1 = a0 + (uintptr_t)rows * p * sizeof(T);
      const uintptr_t line = a0 & ~(uintptr_t)15, body = a1 & ~(uintptr_t)15;
      const unsigned bytes = body > line ? (unsigned)(body - line) : 0u;
      if (threadIdx.x == 0)
        bulk_copy(dx, reinterpret_cast<const void*>(line), bytes, &bars[st % kBuf]);
      if (threadIdx.x == 32 && a1 > body)
        cp_async16(reinterpret_cast<char*>(dx) + (body - line),
                   reinterpret_cast<const void*>(body), (int)(a1 - body));
    } else {
      // each row's tile columns as 4-byte words from the word that holds the
      // first: kWords covers 96 columns and a shift of one bf16 element
      constexpr int kWords = kEdge * (int)sizeof(T) / 4 + (sizeof(T) < 4 ? 1 : 0);
      const int nseg = diag ? 1 : 2;
      for (int e = threadIdx.x; e < rows * nseg * kWords; e += S::kThreads) {
        const int w = e % kWords, rs2 = e / kWords;
        const int seg = diag ? 0 : rs2 & 1, r = diag ? rs2 : rs2 >> 1;
        const int c0 = (seg ? J : I) * kEdge;
        const int cols = p - c0 < kEdge ? p - c0 : kEdge;
        const uintptr_t a0 = reinterpret_cast<uintptr_t>(X + (rs + r) * p + c0);
        const uintptr_t a1 = a0 + (uintptr_t)cols * sizeof(T);
        const uintptr_t src = (a0 & ~(uintptr_t)3) + 4 * (uintptr_t)w;
        if (src < a1)
          cp_async4(dx + r * rowp + seg * kSegOff + w * (4 / (int)sizeof(T)),
                    reinterpret_cast<const void*>(src), (int)(a1 - src < 4 ? a1 - src : 4));
      }
    }
  };

  S step(I, J, diag, p, s + zbase + kZero, kStage);
  for (int st = 0; st < kBuf - 1; ++st) {
    if (st < nstage) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstage + S::kLag; ++st) {
    cp_async_wait<kBuf - 2>();  // stage st has landed (this thread's copies)
    if (kFlat && st < nstage) bar_wait(&bars[st % kBuf], (st / kBuf) & 1);
    __syncthreads();            // ... everyone's; and stage st - 1 is consumed
    if (st + kBuf - 1 < nstage) load(st + kBuf - 1);
    cp_async_commit();
    if (st < nstage) {
      const int64_t rs = r0 + (int64_t)st * kStage;
      const Staged<T, kFlat> g{s, X, rs, rows_of(st), p, rowp,
                               (st % kBuf) * xstage + (kFlat ? shift_of(X + rs * p, 16) : 0),
                               ybase + (st % kBuf) * kYStage + shift_of(y + rs, 16), zbase};
      step.take(g, st);
    }
    if (S::kLag && st > 0) step.sum(st - 1, rows_of(st - 1));
  }
  cp_async_wait<0>();
  __syncthreads();
  step.finish(smem, part + (int64_t)blockIdx.y * q * q, q);
}

// One warp: S (kStep x 192, row-major) staged as the wide route stages an
// off-diagonal pair; D (192 x 192) gets the entries i <= j of S^T S that a
// diagonal pair's two parts (columns 0-95) and an off-diagonal pair's four
// quadrants (rows 0-95, columns 96-191) compute in one step, through the
// kernel's own fragment loads, products and stores. Checks the fragment
// layouts on the card.
template <typename T>
__global__ void mma_probe(const T* __restrict__ S, float* __restrict__ D) {
  using M = Mma<T>;
  __shared__ __align__(16) T st[M::kStep * pitch(false)];
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < M::kStep * 2 * kEdge; e += 32) {
    const int r = e / (2 * kEdge), c = e % (2 * kEdge);
    st[r * pitch(false) + (c < kEdge ? c : kSegOff + c - kEdge)] = S[e];
  }
  __syncwarp();
  int o[M::kLaneRows];
#pragma unroll
  for (int i = 0; i < M::kLaneRows; ++i) o[i] = M::row(i, lane & 3) * pitch(false) + (lane >> 2);
  const uint32_t fy[2] = {0u, 0u};
  constexpr int kD = 2 * kEdge;
  for (int part = 0; part < 6; ++part) {
    Acc acc = {};
    if (part == 0) {
      step_bands<0, 2>(st, o, fy, -1, acc);
      store_bands<0, 2>(acc, D, kD, 0);
    } else if (part == 1) {
      step_bands<2, 6>(st, o, fy, -1, acc);
      store_bands<2, 6>(acc, D, kD, 0);
    } else {
      const int qa = (part - 2) >> 1, qb = (part - 2) & 1;
      step_quad(st, o, fy, 48 * qa, -1, kSegOff + 48 * qb, -1, acc);
      store_quad(acc, D, kD, 6 * qa, kGroups + 6 * qb);
    }
  }
}

}  // namespace tc


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

// Modes 0 (S = tc::Fma), 1 (tc::Tc<float>, tf32 products) and 2
// (tc::Tc<bfloat16>).
template <typename S>
cudaError_t launch_tc(const void* X, const void* y, void* part, void* K, int n, int p,
                      int rows_per_split, int nsplit, double t, int flat,
                      cudaStream_t stream) {
  using T = typename S::Elem;
  constexpr int kVec = 16 / (int)sizeof(T);
  const int nt = (p + 1 + tc::kEdge - 1) / tc::kEdge;
  const bool one = nt == 1;
  // a flat stage: its rows, a shift of up to kVec - 1 and the 96 columns a
  // lane may read past the last row's start; a wide one: rows at the widest pitch
  const int rows = S::stage(one);
  const int xstage = one ? (rows * p + kVec + tc::kEdge + kVec - 1) / kVec * kVec
                         : rows * tc::pitch(false);
  const int stages = tc::buffers(one) * (xstage + rows + kVec) + tc::kZero + S::extra(one);
  const int smem = stages * (int)sizeof(T) > S::red_bytes() ? stages * (int)sizeof(T)
                                                             : S::red_bytes();
  auto kernel = one ? tc::gram_partial<S, true> : tc::gram_partial<S, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(nt * (nt + 1) / 2, nsplit), S::kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(y), static_cast<float*>(part), n, p,
      rows_per_split, nt, xstage);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_epilogue<float><<<p, 128, 0, stream>>>(static_cast<const float*>(part),
                                              static_cast<float*>(K), p, nsplit,
                                              float(1.0 / t), flat);
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
// modes 0-2 (one staging; rows by mode) and mode 3.
int sven_gram_tile_tc() { return tc::kEdge; }
int sven_gram_rows_step_tc(int mode) {
  // mode 0: the flat route's stage, a multiple of the wide route's
  return mode == 0   ? tc::Fma::stage(true)
         : mode == 2 ? tc::Mma<__nv_bfloat16>::kStage
                     : tc::Mma<float>::kStage;
}
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
      return launch_tc<tc::Fma>(X, y, part, K, n, p, rows_per_split, nsplit, t, flat, s);
    case 1:
      return launch_tc<tc::Tc<float>>(X, y, part, K, n, p, rows_per_split, nsplit, t,
                                      flat, s);
    case 2:
      return launch_tc<tc::Tc<__nv_bfloat16>>(X, y, part, K, n, p, rows_per_split, nsplit,
                                              t, flat, s);
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

// S (8, 192) float32 (mode 1) or (16, 192) bfloat16 (mode 2) and D (192,
// 192) float32 on the card: see tc::mma_probe.
int sven_gram_tc_probe(const void* S, void* D, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    tc::mma_probe<float><<<1, 32, 0, s>>>(static_cast<const float*>(S),
                                          static_cast<float*>(D));
  else if (mode == 2)
    tc::mma_probe<__nv_bfloat16><<<1, 32, 0, s>>>(static_cast<const __nv_bfloat16*>(S),
                                                  static_cast<float*>(D));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"

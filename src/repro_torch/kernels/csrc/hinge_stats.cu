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
//     and the loss partials C sum_j (xi_top^2 + xi_bot^2), xi = act (1 - m).
//
// What bounds it: one read of X (n p elements), w and y, and four p-vectors
// written; about 2 n p FLOPs, two orders of magnitude under the fp32 rate for
// those bytes, so the card's memory rate bounds it. At the GLA-BRA-180 shape
// (n = 180, p = 49,151) X is 35 MB in f32; at the YMSD shape (n = 463,715,
// p = 90) it is 167 MB (0.050 ms at 3.35 TB/s; 0.025 ms in bf16).
//
// Two routes, each one launch. The wrapper (kernels/hinge_stats.py, `plan`)
// takes the tall route when p <= kMaxP (2,048) and its row ranges give more
// blocks than the wide route's column blocks; else the wide route.
//
// Tall route (narrow p, large n; YMSD): X is read as one contiguous stream.
//   - One wave: at most one 512-thread block per SM, each owning a contiguous
//     range of rows across all p columns.
//   - Staging: a block walks its rows in stages of up to 64 KB of X (rows of
//     the stage = min(512, 64 KB / row bytes): 182 f32 rows or 364 bf16 rows
//     at p = 90) through three buffers (128 KB in flight while one is
//     summed). A stage's whole 16-byte lines come in by one cp.async.bulk on
//     an mbarrier, its last part line and the stage's w and y by 16-byte
//     cp.async; so X may start at any element and p have any parity (the
//     first element of a stage lands at its 16-byte offset).
//   - Column sums out of shared memory: for p <= 512 thread t owns column
//     t mod p and row phase t / p (512 / p phases), so a warp reads
//     consecutive words of the flat stage; for 512 < p <= kMaxP a thread
//     owns columns t, t + 512, ... (up to kSlots = 4). y.w is summed from the
//     same stage.
//   - Finish: each block writes its p column sums and its y.w to part; the
//     last block to finish (an integer atomicAdd ticket, left 0 again) sums
//     them in a fixed order (phase q sums a contiguous range of blocks in
//     block order, then the phases in order) and runs the epilogue, one loss
//     partial.
//   - Width limit: the stage must hold a row and every column needs a slot,
//     kThreads x kSlots = 2,048 columns (a stage then holds 8 f32 rows).
//     Shared memory: three X buffers of 65,568 B and w, y buffers of 2,080
//     B, 209,184 B of dynamic shared memory a block.
//
// Wide route (wide X: GLA-BRA-180 gives 1,536 column blocks): threadIdx.x
// maps to 32 neighbouring columns, so a warp reads one 64- or 128-byte
// segment of a row, and the 8 warps of a block split all n rows and meet in
// shared memory; the block recomputes y.w itself (n is small there, as on
// the TPU) and runs the epilogue of its columns, one loss partial per block.
// A bfloat16 body whose lanes load four or two neighbouring columns at once
// (124 or 62 columns a block, 1-16 rows in flight) ran slower on the card in
// every variant tried (PERF.md), so both types keep this one.
//
// No float atomics: every sum runs in a fixed order, so the result is the same
// on every run. Ragged edges are masked; there are no padded columns, so the
// loss needs no correction for them. X is float32 or bfloat16 storage;
// everything else is float32 and every sum is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Sum over a block of kN threads of one value per thread, in a fixed order;
// every thread gets the result. `red` holds kN / 32 floats.
template <int kN>
__device__ __forceinline__ float block_sum(float v, float* red, int tid) {
  const int lane = tid % 32, warp = tid / 32;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kN / 32; ++w) s += red[w];
  return s;
}

struct Out {
  float* mt;         // (p,) m_top
  float* mb;         // (p,) m_bot
  float* gt;         // (p,) g_top
  float* gb;         // (p,) g_bot
  float* loss_part;  // one per block of the wide route, one on the tall route
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

// ------------------------------------------------------------ wide route ---
constexpr int kCols = 32;                     // columns per block
constexpr int kWarps = 8;                     // row phases per block
constexpr int kWideThreads = kCols * kWarps;

// block (32, 8), grid ceil(p / 32): threadIdx.x = column within the block's
// 32, threadIdx.y = row phase; every block sums all n rows.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
stats_wide(const T* __restrict__ X, const float* __restrict__ w,
           const float* __restrict__ y, int n, int p, Out o, float invt, float C) {
  __shared__ float red[kWarps];
  __shared__ float colsum[kWarps][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int j = blockIdx.x * kCols + tx;

  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if (j < p) {
    int r = ty;
    for (; r + 3 * kWarps < n; r += 4 * kWarps) {
      c0 = fmaf(ld<T>(X, (int64_t)r * p + j), w[r], c0);
      c1 = fmaf(ld<T>(X, (int64_t)(r + kWarps) * p + j), w[r + kWarps], c1);
      c2 = fmaf(ld<T>(X, (int64_t)(r + 2 * kWarps) * p + j), w[r + 2 * kWarps], c2);
      c3 = fmaf(ld<T>(X, (int64_t)(r + 3 * kWarps) * p + j), w[r + 3 * kWarps], c3);
    }
    for (; r < n; r += kWarps) c0 = fmaf(ld<T>(X, (int64_t)r * p + j), w[r], c0);
  }
  colsum[ty][tx] = (c0 + c1) + (c2 + c3);

  float s = 0.f;
  for (int r = tid; r < n; r += kWideThreads) s = fmaf(y[r], w[r], s);
  const float byw = block_sum<kWideThreads>(s, red, tid) * invt;  // also: colsum complete
  if (ty != 0) return;

  float a = 0.f;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) a += colsum[q][tx];
  float term = 0.f;
  if (j < p) term = epilogue(a, byw, j, o);
  term = warp_sum(term);  // warp 0 is exactly the ty == 0 row
  if (tx == 0) o.loss_part[blockIdx.x] = C * term;
}

// ------------------------------------------------------------ tall route ---
constexpr int kThreads = 512;                 // threads of a tall block
constexpr int kSlots = 4;                     // columns a thread owns at most
constexpr int kMaxP = kThreads * kSlots;      // widest p of the tall route
constexpr int kBuf = 3;                       // stage buffers
constexpr int kStageBytes = 65536;            // most bytes of X in a stage
constexpr int kMaxStageRows = 512;            // most rows in a stage
constexpr int kXBuf = kStageBytes + 32;       // X buffer: + head and tail lines
constexpr int kVBuf = kMaxStageRows + 8;      // w or y buffer, floats
constexpr int kSmem = kBuf * (kXBuf + 2 * kVBuf * (int)sizeof(float));
static_assert(kMaxStageRows <= kThreads, "a thread takes one row of y.w a stage");

__device__ inline int stage_rows(int p, int size) {
  const int r = kStageBytes / (p * size);
  return r < kMaxStageRows ? r : kMaxStageRows;
}

// dst = the first `bytes` of the 16 bytes at src, zero-filled after them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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
__device__ __forceinline__ int shift_of(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15u) / sizeof(T));
}

// grid `blocks` (at most one per SM), kThreads threads: block k sums rows
// [k R, min(n, (k + 1) R)), R = rows_per_block, into part[k] (p column sums,
// then y.w; row pitch p + 1); the last block to finish runs the epilogue.
// kS = 1 for p <= kThreads (row phases), else kSlots. ticket is 0 before the
// launch and 0 again after it.
template <typename T, int kS>
__global__ void __launch_bounds__(kThreads, 1)
stats_tall(const T* __restrict__ X, const float* __restrict__ w,
           const float* __restrict__ y, int n, int p, int rows_per_block,
           float* __restrict__ part, int* __restrict__ ticket, Out o, float invt,
           float C) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bars[kBuf];
  __shared__ float phsum[kThreads];
  __shared__ float red[kThreads / 32];
  __shared__ int last;
  char* const xbuf = reinterpret_cast<char*>(smem);
  float* const wbuf = reinterpret_cast<float*>(smem + kBuf * kXBuf);
  float* const ybuf = wbuf + kBuf * kVBuf;

  const int tid = threadIdx.x;
  const int nph = kS == 1 ? kThreads / p : 1;     // row phases
  const int ph = kS == 1 ? tid / p : 0;
  const int c = kS == 1 ? tid - ph * p : tid;     // the thread's (first) column
  const bool owner = ph < nph;                    // owns a column
  const int srows = stage_rows(p, (int)sizeof(T));
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : (int64_t)n;
  const int nstage = (int)((r1 - r0 + srows - 1) / srows);
  auto rows_of = [&](int st) {
    const int64_t left = r1 - r0 - (int64_t)st * srows;
    return (int)(left < srows ? left : srows);
  };

  if (tid == 0) {
    for (int b = 0; b < kBuf; ++b) bar_init(&bars[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int st) {
    const int64_t rs = r0 + (int64_t)st * srows;
    const int rows = rows_of(st), b = st % kBuf;
    copy_flat<kThreads>(wbuf + b * kVBuf, w + rs, rows);
    copy_flat<kThreads>(ybuf + b * kVBuf, y + rs, rows);
    // the whole 16-byte lines by one bulk copy, the last part line apart
    char* dx = xbuf + b * kXBuf;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(X + rs * p);
    const uintptr_t a1 = a0 + (uintptr_t)rows * p * sizeof(T);
    const uintptr_t line = a0 & ~(uintptr_t)15, body = a1 & ~(uintptr_t)15;
    const unsigned bytes = body > line ? (unsigned)(body - line) : 0u;
    if (tid == 0) bulk_copy(dx, reinterpret_cast<const void*>(line), bytes, &bars[b]);
    if (tid == 32 && a1 > body)
      cp_async16(dx + (body - line), reinterpret_cast<const void*>(body), (int)(a1 - body));
  };

  float acc[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) acc[s] = 0.f;
  float yw = 0.f;
  for (int st = 0; st < kBuf - 1; ++st) {
    if (st < nstage) load(st);
    cp_async_commit();
  }
  for (int st = 0; st < nstage; ++st) {
    const int b = st % kBuf;
    cp_async_wait<kBuf - 2>();  // stage st's w, y and tail have landed (own copies)
    bar_wait(&bars[b], (st / kBuf) & 1);
    __syncthreads();            // ... everyone's; and stage st - 1 is consumed
    if (st + kBuf - 1 < nstage) load(st + kBuf - 1);
    cp_async_commit();
    const int64_t rs = r0 + (int64_t)st * srows;
    const int rows = rows_of(st);
    const T* xs = reinterpret_cast<const T*>(xbuf + b * kXBuf) + shift_of(X + rs * p);
    const float* ws = wbuf + b * kVBuf + shift_of(w + rs);
    const float* ys = ybuf + b * kVBuf + shift_of(y + rs);
    if (tid < rows) yw = fmaf(ys[tid], ws[tid], yw);
    if (!owner) continue;
    if constexpr (kS == 1) {
      // element r p + c of row r = ph, ph + nph, ...: a warp reads consecutive
      // words. The trip count is known before the loop, so the unrolled body
      // issues its loads ahead of its FMAs.
      const int iters = rows > ph ? (rows - 1 - ph) / nph + 1 : 0;
      const int step = nph * p;
      const T* xp = xs + tid;
      const float* wp = ws + ph;
#pragma unroll 4
      for (int i = 0; i < iters; ++i) acc[0] = fmaf(ld<T>(xp, i * step), wp[i * nph], acc[0]);
    } else {
      for (int r = 0; r < rows; ++r) {
        const float wv = ws[r];
        const T* xr = xs + r * p + c;
#pragma unroll
        for (int s = 0; s < kS; ++s)
          if (c + s * kThreads < p) acc[s] = fmaf(ld<T>(xr, s * kThreads), wv, acc[s]);
      }
    }
  }
  cp_async_wait<0>();

  // the block's partials: column sums over the phases in order, then y.w
  if (kS == 1 && owner) phsum[tid] = acc[0];
  const float ywb = block_sum<kThreads>(yw, red, tid);  // also: phsum complete
  float* mine = part + (int64_t)blockIdx.x * (p + 1);
  if constexpr (kS == 1) {
    if (tid < p) {
      float a = 0.f;
      for (int q = 0; q < nph; ++q) a += phsum[q * p + tid];
      mine[tid] = a;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (c + s * kThreads < p) mine[c + s * kThreads] = acc[s];
  }
  if (tid == 0) mine[p] = ywb;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;  // block-uniform
  __threadfence();

  // the last block: the fixed-order sums over the blocks, then the epilogue.
  // Every partial it reads is loaded before the first is added, so that the
  // loads are in flight together (a missing one adds +0).
  const int G = gridDim.x;
  constexpr int kIn = 16 / kS;  // blocks a round of a thread's loads covers
  float s = 0.f;
  for (int k = tid; k < G; k += kThreads) s += __ldcg(part + (int64_t)k * (p + 1) + p);
  float a[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) a[q] = 0.f;
  if (owner) {
    const int k0 = (int)((int64_t)G * ph / nph), k1 = (int)((int64_t)G * (ph + 1) / nph);
    for (int k = k0; k < k1; k += kIn) {
      float v[kIn][kS];
#pragma unroll
      for (int i = 0; i < kIn; ++i)
#pragma unroll
        for (int q = 0; q < kS; ++q)
          v[i][q] = k + i < k1 && c + q * kThreads < p
                        ? __ldcg(part + (int64_t)(k + i) * (p + 1) + c + q * kThreads)
                        : 0.f;
#pragma unroll
      for (int i = 0; i < kIn; ++i)
#pragma unroll
        for (int q = 0; q < kS; ++q) a[q] += v[i][q];
    }
  }
  // every read of phsum above was before the ticket
  if (kS == 1 && owner) phsum[tid] = a[0];
  const float byw = block_sum<kThreads>(s, red, tid) * invt;  // also: phsum complete
  float term = 0.f;
  if constexpr (kS == 1) {
    if (tid < p) {
      float A = 0.f;
      for (int q = 0; q < nph; ++q) A += phsum[q * p + tid];
      term = epilogue(A, byw, tid, o);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kS; ++q)
      if (c + q * kThreads < p) term += epilogue(a[q], byw, c + q * kThreads, o);
  }
  term = block_sum<kThreads>(term, red, tid);
  if (tid == 0) {
    o.loss_part[0] = C * term;
    *ticket = 0;  // every block has counted
  }
}

template <typename T>
cudaError_t launch(const void* Xv, const float* w, const float* y, int n, int p,
                   int blocks, int rows_per_block, float* part, int* ticket, Out o,
                   float invt, float C, cudaStream_t s) {
  const T* X = static_cast<const T*>(Xv);
  if (blocks == 0) {
    stats_wide<T><<<(p + kCols - 1) / kCols, dim3(kCols, kWarps), 0, s>>>(X, w, y, n, p, o,
                                                                          invt, C);
    return cudaGetLastError();
  }
  if (p > kMaxP || (int64_t)blocks * rows_per_block < n ||
      (int64_t)(blocks - 1) * rows_per_block >= n)
    return cudaErrorInvalidValue;
  auto kernel = p <= kThreads ? stats_tall<T, 1> : stats_tall<T, kSlots>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, kSmem, s>>>(X, w, y, n, p, rows_per_block, part, ticket, o,
                                         invt, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tall route's widest p.
int sven_hinge_stats_tall_max_p() { return kMaxP; }
// Columns per block of the wide route.
int sven_hinge_stats_cols() { return kCols; }

// X (n, p) row-major, float32 (bf16 = 0) or bfloat16 (bf16 = 1), at any
// element alignment; w, y (n,) float32 in. blocks = 0: the wide route, with
// loss_part (ceil(p / 32),). Else the tall route: `blocks` blocks of
// rows_per_block rows (each has at least one; at most one block per SM
// runs), part (blocks, p + 1) float32 scratch, ticket one int32 that is 0 on
// entry and left 0, loss_part (1,). mt, mb, gt, gb (p,) float32 out. One
// launch on `stream`; launches that share a ticket must be ordered (one
// stream). Returns its CUDA error (0 = none; a plan the kernel cannot run is
// cudaErrorInvalidValue).
int sven_hinge_stats(const void* X, int bf16, const float* w, const float* y, int n,
                     int p, int blocks, int rows_per_block, float* part, int* ticket,
                     float* mt, float* mb, float* gt, float* gb, float* loss_part,
                     float invt, float C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Out o{mt, mb, gt, gb, loss_part};
  return bf16 ? launch<__nv_bfloat16>(X, w, y, n, p, blocks, rows_per_block, part, ticket,
                                      o, invt, C, s)
              : launch<float>(X, w, y, n, p, blocks, rows_per_block, part, ticket, o,
                              invt, C, s);
}

}  // extern "C"

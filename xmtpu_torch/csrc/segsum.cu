// Sorted segment sums for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes); see xmtpu_torch/ops/segsum.py.
//
// segsum_csr and segsum_long replace xmtpu/ops/pallas_segsum.py::_kernel
// (via sorted_segment_sum):
//   out[s, :] = sum of the rows of vals (E, D) whose sorted segment id is s,
//   the rows [off[s], off[s+1]) added in row order from zero, each type
//   accumulating in itself: the order of index_add_ on the host, so the bits
//   are the CPU twin's, on every run, with no atomics.  The TPU kernel walks
//   a sequential grid of 512-row chunks and turns each chunk into a one-hot
//   band matmul accumulated in VMEM; Hopper blocks run in no order, so that
//   carry does not translate.  Here the segment boundaries come as CSR
//   offsets (S+1,) computed once on the host from the sorted ids.
//   Bound on the H100: bytes (each input element read once, each output
//   written once, one add per input element) or, under this contract, the
//   longest segment's chain of dependent adds, whichever is longer.
//   Short segments (segsum_csr): one thread per output element (s, d)
//   walks its segment's rows of column d.  Blocks of
//   ops/segsum.py csr_threads (64-256 threads, from S*D) give every SM
//   blocks.  On rows of at most 3 values in segments of at most 16 rows on
//   average (csr_batch) a thread loads BATCH = 16 rows, every load issued
//   before the first add, so a segment waits one round trip where the
//   row-by-row loop waited several; elsewhere BATCH = 1.  The implicit
//   operator's orderings (11 rows a landmark, 44 a frame at scene C) take
//   this path alone.
//   Long segments (segsum_long): the walk above waits one round trip to L2
//   a row or two (~27 ns a row), and the launch waits for its longest
//   segment: 2,358 rows of BA's image sums took 64 us.  So a segment of
//   more than long_rows rows (the host plan, ops/segsum.py CsrPlan, built
//   once from host integers: segment, first and end row, longest first)
//   gets a thread block of its own, which streams its span of L*D
//   contiguous values through a ring of LONG_STAGES shared-memory stages by
//   cp.async: 16-byte copies of the span's whole 16-byte chunks, one-element
//   copies of the few values before the first and after the last (a span
//   at an odd r0*D of f64, or a view, is not aligned), LONG_STAGES - 1
//   tiles in flight while one is added.  D adder threads, one a column,
//   walk each staged tile in row order from shared memory, the next rows'
//   loads issued before the current rows' adds, so no global load sits in
//   the chain of adds.  Several such blocks share an SM, so the chains of
//   different segments overlap.  A layout that mixes both (BATA's cameras
//   among its points) makes one launch: the grid's first blocks take the
//   long segments, the rest are short-segment tiles whose threads leave
//   the long segments alone.  A faster order (a fixed tree over a
//   segment's rows) would change the bits; it is not taken.
//
// blocked_sum replaces xmtpu/ops/pallas_segsum.py::_kernel_blocked (via
// sorted_segment_sum_blocked): the same sum on the scheduled layout of
// plan_blocks / schedule_edges — G visits of `chunk` rows, each inside one
// output block of `sb` segments; within a block the real rows are the
// block's span of the sorted ids, re-chunked in order, then zero-valued
// padding rows carrying the block's first id at the tail of its last visit;
// an edge-less block gets one all-padding visit.  The TPU kernel added each
// visit's band partial into the resident output block in grid order.
//   Bound on the H100: bytes, as for segsum_csr (values and scheduled ids in
//   once, the (S, D) output out once: 2.5 us at D=6 f32 on scene C's
//   landmark schedule) — in practice the latency of finding each segment's
//   rows.  The first port wrote (G, band, D) per-visit partials and had
//   every output thread walk its block's visits (~44 at scene C), and lost
//   to one index_add_.
//   Design: one pass, no partial array.  One thread block per (output block,
//   tile of THREADS / D segments) finds the rows of its tile's two bounds
//   with one probe round over the visits' first ids (non-decreasing: a
//   visit starts with a real id, or an empty visit with its block's first
//   id) and one scan of the visit before, counted up to that visit's first
//   drop of the ids (where the padding starts); it then marks each
//   segment's run where the ids change and gives each output element one
//   thread that sums its run in row order: no atomics on values, the same
//   bits every run, the padding left out (or, where it equals every real id
//   of its block, added as +0.0).  Staging a tile's rows in shared memory
//   first measured slower (34 KB a block cuts the blocks an SM holds).
//
// Both are instantiated for float and double, each accumulating in its own
// type (the TPU kernel ran f32 at HIGHEST precision and f64 exactly).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CSR_MAX_THREADS = 256;
// segsum_long: threads a block (one adder a column: D <= LONG_THREADS), the
// stages of its shared-memory ring, the rows an adder loads before it adds
// them (ops/segsum.py keeps the same numbers)
constexpr int LONG_THREADS = 128;
constexpr int LONG_STAGES = 4;
constexpr int LONG_BATCH = 8;
// devices whose allowed dynamic shared memory launch_long_b remembers
constexpr int MAX_DEVICES = 64;

// Thread t = s * D + d of a CSR sum: out[s, d] = the rows [off[s],
// off[s+1]) of column d added in row order from zero.  The rows are loaded
// BATCH at a time, every load of a batch issued before the first add, so a
// segment of L rows waits ceil(L / BATCH) round trips instead of one per
// row (or per unrolled few).  With SKIP_LONG a segment of more than
// long_rows rows is left alone: a block of segsum_long sums it.
template <typename T, int BATCH, bool SKIP_LONG>
__device__ __forceinline__ void csr_output(const T* __restrict__ vals,
                                           const int* __restrict__ offsets,
                                           T* __restrict__ out, int64_t t,
                                           int D, int long_rows) {
  const int s = static_cast<int>(t / D), d = static_cast<int>(t - s * D);
  const int r0 = __ldg(offsets + s), r1 = __ldg(offsets + s + 1);
  if (SKIP_LONG && r1 - r0 > long_rows) return;
  const T* p = vals + static_cast<int64_t>(r0) * D + d;
  const int64_t stride = D;
  T acc = T(0);
  for (int r = r0; r < r1; r += BATCH, p += BATCH * stride) {
    T x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      x[u] = r + u < r1 ? __ldg(p + u * stride) : T(0);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (r + u < r1) acc = acc + x[u];
  }
  out[t] = acc;
}

// One thread per output element of every segment.
template <typename T, int BATCH>
__global__ void __launch_bounds__(CSR_MAX_THREADS)
segsum_csr(const T* __restrict__ vals, const int* __restrict__ offsets,
           T* __restrict__ out, int S, int D) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(S) * D) return;
  csr_output<T, BATCH, false>(vals, offsets, out, t, D, 0);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned smem, const void* gmem) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem),
                 "l"(gmem), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block copies the values [a, b) of vals into the stage buf (16-byte
// aligned), value a at byte (address of vals + a) % 16: the span's whole
// 16-byte chunks by 16-byte cp.async, from threads lo on (past the adders'
// warps where enough threads are left, so the adders issue no copy); the
// values before the first whole chunk (the head) and from the end of the
// last (the tail), at most 16 / sizeof(T) - 1 each, by one-value cp.async
// from the last threads.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* vals, int64_t a,
                                           int64_t b, unsigned char* buf,
                                           int lo) {
  constexpr int SZ = sizeof(T);
  const uintptr_t A = reinterpret_cast<uintptr_t>(vals + a);
  const uintptr_t B = reinterpret_cast<uintptr_t>(vals + b);
  const uintptr_t base = A & ~uintptr_t(15);
  const uintptr_t c0 = (A + 15) & ~uintptr_t(15);  // first whole chunk
  const uintptr_t c1 = B & ~uintptr_t(15);         // end of the whole chunks
  const uintptr_t ts = c1 > c0 ? c1 : c0;          // the tail's start
  const unsigned sb = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const int64_t chunks = c1 > c0 ? static_cast<int64_t>((c1 - c0) / 16) : 0;
  const int copiers = static_cast<int>(blockDim.x) - lo;
  for (int64_t c = static_cast<int>(threadIdx.x) - lo; c >= 0 && c < chunks;
       c += copiers)
    cp_async<16>(sb + static_cast<unsigned>(c0 - base + 16 * c),
                 reinterpret_cast<const void*>(c0 + 16 * c));
  const int head = static_cast<int>(((c0 < B ? c0 : B) - A) / SZ);
  const int tail = B > ts ? static_cast<int>((B - ts) / SZ) : 0;
  const int j = static_cast<int>(blockDim.x) - 1 - threadIdx.x;
  if (j < head)
    cp_async<SZ>(sb + static_cast<unsigned>(A - base + j * SZ),
                 reinterpret_cast<const void*>(A + j * SZ));
  else if (j < head + tail)
    cp_async<SZ>(sb + static_cast<unsigned>(ts - base + (j - head) * SZ),
                 reinterpret_cast<const void*>(ts + (j - head) * SZ));
}

// acc plus s[0], s[D], ..., s[(rows - 1) D] added in that order.  In whole
// batches of U rows the next batch is loaded from shared memory before the
// current one is added, so the loads stay out of the chain of adds (4.7 ns
// a row in f64 on the H100 against a 4.1 ns dependent add; the same loop
// with a predicate on each row took 12 ns); the last rows % U rows one by
// one.
template <typename T, int U>
__device__ __forceinline__ T add_rows(T acc, const T* s, int rows, int D) {
  const int full = rows - rows % U;
  int i = 0;
  if (full > 0) {
    T x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = s[u * D];
    for (; i + U < full; i += U) {
      T y[U];
#pragma unroll
      for (int u = 0; u < U; ++u) y[u] = s[(i + U + u) * D];
#pragma unroll
      for (int u = 0; u < U; ++u) acc = acc + x[u];
#pragma unroll
      for (int u = 0; u < U; ++u) x[u] = y[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc = acc + x[u];
    i = full;
  }
  for (; i < rows; ++i) acc = acc + s[i * D];
  return acc;
}

// A block of segsum_long: the long segment seg, rows [r0, r1), streamed
// tile_rows at a time through the ring (LONG_STAGES stages of stage_bytes +
// 16 bytes: a tile's values and the 16-byte misalignment of its first),
// LONG_STAGES - 1 tiles in flight;
// adder d < D adds column d of each tile in row order.  Every thread of the
// block runs every iteration (the barriers are the block's).
template <typename T>
__device__ __forceinline__ void sum_long_segment(
    const T* __restrict__ vals, T* __restrict__ out, int D, int tile_rows,
    int stage_bytes, unsigned char* ring, int seg, int64_t r0, int64_t r1) {
  const int tiles = static_cast<int>((r1 - r0 + tile_rows - 1) / tile_rows);
  const int stride = stage_bytes + 16;
  // the first thread that copies: past the adders' warps while at least
  // two warps are left to copy
  const int adders = (D + 31) / 32 * 32;
  const int lo = adders + 64 <= static_cast<int>(blockDim.x) ? adders : 0;
  auto stage = [&](int k) {
    if (k < tiles) {
      const int64_t a = r0 + static_cast<int64_t>(k) * tile_rows;
      const int64_t b = a + tile_rows < r1 ? a + tile_rows : r1;
      stage_tile(vals, a * D, b * D, ring + (k % LONG_STAGES) * stride,
                 lo);
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int k = 0; k < LONG_STAGES - 1; ++k) stage(k);
  const int d = threadIdx.x;
  T acc = T(0);
  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<LONG_STAGES - 2>();  // this thread's copies of tile k
    __syncthreads();  // everyone's; and the adds of tile k - 1 are done
    stage(k + LONG_STAGES - 1);       // into tile k - 1's stage
    if (d < D) {
      const int64_t a = r0 + static_cast<int64_t>(k) * tile_rows;
      const uintptr_t A = reinterpret_cast<uintptr_t>(vals + a * D);
      const T* s = reinterpret_cast<const T*>(
          ring + (k % LONG_STAGES) * stride + (A & 15));
      const int rows = static_cast<int>(r1 - a < tile_rows ? r1 - a
                                                            : tile_rows);
      acc = add_rows<T, LONG_BATCH>(acc, s + d, rows, D);
    }
  }
  if (d < D) out[static_cast<int64_t>(seg) * D + d] = acc;
}

// One launch for a layout with long segments: block j < n_long sums the
// long segment longs[j] = (segment, first row, end row)
// (sum_long_segment), the rest are short-segment tiles of blockDim.x
// outputs whose threads skip the segments of more than long_rows rows.
template <typename T, int BATCH>
__global__ void __launch_bounds__(LONG_THREADS)
segsum_long(const T* __restrict__ vals, const int* __restrict__ offsets,
            const int* __restrict__ longs, T* __restrict__ out, int S, int D,
            int n_long, int long_rows, int tile_rows, int stage_bytes) {
  extern __shared__ __align__(16) unsigned char ring[];
  const int j = static_cast<int>(blockIdx.x);
  if (j < n_long) {
    sum_long_segment<T>(vals, out, D, tile_rows, stage_bytes, ring,
                        __ldg(longs + 3 * j), __ldg(longs + 3 * j + 1),
                        __ldg(longs + 3 * j + 2));
    return;
  }
  const int64_t t = static_cast<int64_t>(blockIdx.x - n_long) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(S) * D) return;
  csr_output<T, BATCH, true>(vals, offsets, out, t, D, long_rows);
}

// An empty kernel: the launch floor of a grid (timed by chip_profile.py).
__global__ void floor_kernel() {}

// Cooperative search by the whole thread block, for K keys at once: the
// first index r in [0, n) with key_at(r) >= keys[k] (n if none), where
// key_at is non-decreasing.  Each round probes P * blockDim.x evenly spaced
// indices, all loads of the round issued together, and counts those below
// each key with barrier counts, which shrinks the interval that many-fold:
// one round up to P * blockDim.x indices.  Every thread gets the same
// answers; every thread must call it.
template <int K, int P, typename KeyAt>
__device__ __forceinline__ void block_lower_bound(KeyAt key_at, int64_t n,
                                                  const int (&keys)[K],
                                                  int64_t (&res)[K]) {
  int64_t l[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) l[k] = 0, h[k] = n;
  const int64_t np = static_cast<int64_t>(P) * blockDim.x;
  while (true) {
    bool open = false;
#pragma unroll
    for (int k = 0; k < K; ++k) open = open || h[k] > l[k];
    if (!open) break;  // uniform: every thread holds the same l, h
    int64_t step[K];
    bool below[K][P];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      step[k] = (h[k] - l[k] + np - 1) / np;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int64_t q = l[k] + (p * static_cast<int64_t>(blockDim.x) +
                                  threadIdx.x) * step[k];
        below[k][p] = q < h[k] && key_at(q) < keys[k];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int c = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) c += __syncthreads_count(below[k][p]);
      if (h[k] > l[k]) {
        if (c == 0) {
          h[k] = l[k];
        } else {
          const int64_t nl = l[k] + (c - 1) * step[k] + 1;
          h[k] = min(l[k] + c * step[k], h[k]);
          l[k] = nl;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) res[k] = l[k];
}

// One thread block per (output block b, tile of `tile` segments): every
// output element of the tile in one pass, no partial array.
//   1. for each bound s of the tile's segments [s0, s1), the first visit g
//      whose first id is >= s: a visit's first row holds a real id, or, in
//      an empty visit, its block's first id, so first ids never decrease;
//   2. the bound's row: if visit c = g - 1 lies in block b, the rows of c
//      below s, counted up to c's first drop of the ids (the start of the
//      block's padding: zero values carrying the block's first id, at the
//      tail of its last visit only); else visit g's first row;
//   3. each segment's run [start, end) in the tile's rows [r0, r1), marked
//      in shared memory where the ids change (empty segments keep [0, 0));
//   4. thread (j, d) sums column d of segment j's run in row order.
// A block whose padding equals every real id (all rows hold its first id)
// has no drop: its padding joins that segment's run and adds +0.0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_sum(const T* __restrict__ vals, const int* __restrict__ ids,
            T* __restrict__ out, int G, int S, int chunk, int sb, int tile,
            int D) {
  extern __shared__ int runs[];  // start[tile], end[tile]
  __shared__ int drop[2], below[2];
  const int tiles = (sb + tile - 1) / tile;
  const int b = blockIdx.x / tiles;
  const int s0 = b * sb + (blockIdx.x - b * tiles) * tile;
  const int s1 = min(min(s0 + tile, (b + 1) * sb), S);
  if (s0 >= s1) return;  // uniform across the block
  const int ns = s1 - s0;
  int* start = runs;
  int* end = runs + tile;
  for (int j = threadIdx.x; j < ns; j += blockDim.x) start[j] = end[j] = 0;
  if (threadIdx.x < 2) drop[threadIdx.x] = chunk, below[threadIdx.x] = 0;

  const int key[2] = {s0, s1};
  int64_t g[2];
  block_lower_bound<2, 4>(
      [&](int64_t v) { return __ldg(ids + v * chunk); }, G, key, g);
  bool in_b[2];
  const int* vis[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    vis[k] = ids + (g[k] - 1) * chunk;
    in_b[k] = g[k] > 0 && __ldg(vis[k]) / sb == b;  // uniform
    if (in_b[k])
      for (int q = threadIdx.x + 1; q < chunk; q += blockDim.x)
        if (__ldg(vis[k] + q) < __ldg(vis[k] + q - 1))
          atomicMin(&drop[k], q);  // an integer minimum
  }
  __syncthreads();
  int64_t r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (in_b[k]) {
      int cnt = 0;
      for (int q = threadIdx.x; q < drop[k]; q += blockDim.x)
        cnt += __ldg(vis[k] + q) < key[k];
      if (cnt) atomicAdd(&below[k], cnt);  // an integer sum
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k)
    r[k] = in_b[k] ? (g[k] - 1) * chunk + below[k] : g[k] * chunk;

  const int rows = static_cast<int>(r[1] - r[0]);
  const int* idp = ids + r[0];
  const T* vp = vals + r[0] * D;
  for (int q = threadIdx.x; q < rows; q += blockDim.x) {
    const int id = idp[q];
    if (q == 0 || idp[q - 1] != id) start[id - s0] = q;
    if (q + 1 == rows || idp[q + 1] != id) end[id - s0] = q + 1;
  }
  __syncthreads();
  for (int jd = threadIdx.x; jd < ns * D; jd += blockDim.x) {
    const int j = jd / D, d = jd - j * D;
    T acc = T(0);
    for (int q = start[j]; q < end[j]; ++q)
      acc = acc + vp[static_cast<int64_t>(q) * D + d];
    out[static_cast<int64_t>(s0 + j) * D + d] = acc;
  }
}

template <typename T, int BATCH>
int launch_csr_b(const T* vals, const int* offsets, T* out, int S, int D,
                 int threads, cudaStream_t s) {
  const int64_t outs = static_cast<int64_t>(S) * D;
  segsum_csr<T, BATCH>
      <<<static_cast<unsigned>((outs + threads - 1) / threads), threads, 0,
         s>>>(vals, offsets, out, S, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_csr(const T* vals, const int* offsets, T* out, int S, int D,
               int threads, int batch, cudaStream_t s) {
  if (static_cast<int64_t>(S) * D == 0) return 0;
  if (threads < 32 || threads % 32 != 0 || threads > CSR_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 1)
    return launch_csr_b<T, 1>(vals, offsets, out, S, D, threads, s);
  if (batch == 16)
    return launch_csr_b<T, 16>(vals, offsets, out, S, D, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int BATCH>
int launch_long_b(const T* vals, const int* offsets, const int* longs, T* out,
                  int S, int D, int n_long, int n_short, int long_rows,
                  int tile_rows, int stage_bytes, cudaStream_t s) {
  const int smem = LONG_STAGES * (stage_bytes + 16);
  // above 48 KB a block's dynamic shared memory must be allowed first, on
  // each device: the size allowed so far, by device
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > allowed[dev])) {
    rc = cudaFuncSetAttribute(segsum_long<T, BATCH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (dev < MAX_DEVICES) allowed[dev] = smem;
  }
  const int64_t outs = static_cast<int64_t>(S) * D;
  const int64_t tiles = n_short ? (outs + LONG_THREADS - 1) / LONG_THREADS
                                : 0;
  segsum_long<T, BATCH><<<static_cast<unsigned>(n_long + tiles),
                          LONG_THREADS, smem, s>>>(
      vals, offsets, longs, out, S, D, n_long, long_rows, tile_rows,
      stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_long(const T* vals, const int* offsets, const int* longs, T* out,
                int S, int D, int n_long, int n_short, int long_rows,
                int tile_rows, int stage_bytes, int batch, cudaStream_t s) {
  if (n_long < 1 || D < 1 || D > LONG_THREADS || tile_rows < 1 ||
      stage_bytes % 16 != 0 ||
      static_cast<int64_t>(tile_rows) * D * sizeof(T) > stage_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 1)
    return launch_long_b<T, 1>(vals, offsets, longs, out, S, D, n_long,
                               n_short, long_rows, tile_rows, stage_bytes, s);
  if (batch == 16)
    return launch_long_b<T, 16>(vals, offsets, longs, out, S, D, n_long,
                                n_short, long_rows, tile_rows, stage_bytes,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_blocked(const T* vals, const int* ids, T* out, int G, int S,
                   int chunk, int sb, int D, cudaStream_t s) {
  if (static_cast<int64_t>(S) * D == 0) return 0;
  if (G == 0) return static_cast<int>(cudaErrorInvalidValue);
  // segments per thread block: one thread per output element of the tile
  const int tile = max(1, min(sb, THREADS / D));
  const int64_t blocks = static_cast<int64_t>((S + sb - 1) / sb) *
                         ((sb + tile - 1) / tile);
  const size_t smem = 2 * static_cast<size_t>(tile) * sizeof(int);
  blocked_sum<T><<<static_cast<unsigned>(blocks), THREADS, smem, s>>>(
      vals, ids, out, G, S, chunk, sb, tile, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success).
int xm_segsum_f32(const float* vals, const int* offsets, float* out, int S,
                  int D, int threads, int batch, void* stream) {
  return launch_csr<float>(vals, offsets, out, S, D, threads, batch,
                           static_cast<cudaStream_t>(stream));
}

int xm_segsum_f64(const double* vals, const int* offsets, double* out, int S,
                  int D, int threads, int batch, void* stream) {
  return launch_csr<double>(vals, offsets, out, S, D, threads, batch,
                            static_cast<cudaStream_t>(stream));
}

// A launch with long segments (see segsum_long): `longs` (on the card)
// holds n_long rows (segment, first row, end row) of the segments of more
// than long_rows rows, longest first; n_short counts the others (the empty
// ones included); the ring's stages hold stage_bytes, its tiles tile_rows
// rows.
int xm_segsum_long_f32(const float* vals, const int* offsets,
                       const int* longs, float* out, int S, int D,
                       int n_long, int n_short, int long_rows, int tile_rows,
                       int stage_bytes, int batch, void* stream) {
  return launch_long<float>(vals, offsets, longs, out, S, D, n_long, n_short,
                            long_rows, tile_rows, stage_bytes, batch,
                            static_cast<cudaStream_t>(stream));
}

int xm_segsum_long_f64(const double* vals, const int* offsets,
                       const int* longs, double* out, int S, int D,
                       int n_long, int n_short, int long_rows, int tile_rows,
                       int stage_bytes, int batch, void* stream) {
  return launch_long<double>(vals, offsets, longs, out, S, D, n_long,
                             n_short, long_rows, tile_rows, stage_bytes,
                             batch, static_cast<cudaStream_t>(stream));
}

// An empty launch of `blocks` x `threads` with `smem` bytes of dynamic
// shared memory (at most 48 KB): the floor under a segment sum's time.
int xm_segsum_floor(int blocks, int threads, int smem, void* stream) {
  floor_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int xm_segsum_blocked_f32(const float* vals, const int* ids, float* out,
                          int G, int S, int chunk, int sb, int D,
                          void* stream) {
  return launch_blocked<float>(vals, ids, out, G, S, chunk, sb, D,
                               static_cast<cudaStream_t>(stream));
}

int xm_segsum_blocked_f64(const double* vals, const int* ids, double* out,
                          int G, int S, int chunk, int sb, int D,
                          void* stream) {
  return launch_blocked<double>(vals, ids, out, G, S, chunk, sb, D,
                                static_cast<cudaStream_t>(stream));
}

}  // extern "C"

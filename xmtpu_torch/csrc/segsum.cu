// Sorted segment sums for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes); see xmtpu_torch/ops/segsum.py.
//
// segsum_csr replaces xmtpu/ops/pallas_segsum.py::_kernel (via
// sorted_segment_sum):
//   out[s, :] = sum of the rows of vals (E, D) whose sorted segment id is s.
//   The TPU kernel walks a sequential grid of 512-row chunks and turns each
//   chunk into a one-hot band matmul accumulated in VMEM; Hopper blocks run
//   in no order, so that carry does not translate.  Here the segment
//   boundaries come as CSR offsets (S+1,) computed once from the sorted ids
//   (SchurQ's bounds_l / bounds_f).
//   Bound on the H100: bytes.  Each input element is read once and each
//   output written once; the arithmetic is one add per input element.  At
//   the implicit operator's sizes (E = 270k rows, D = 3..18, inputs that sit
//   in L2) that is about a microsecond, so in practice it is bound by its
//   launch and by the latency of its dependent loads.  The main path
//   launches it most at f32 D=3 on short segments (11 rows a landmark, 44 a
//   frame).  A thread that walks its segment's rows a load (or an
//   unrolled few) at a time waits that many round trips to L2, and the
//   launch waits for its longest segment.
//   Design: one thread per output element (s, d) adds its segment's rows of
//   column d in row order from zero — the order of index_add_ on the host,
//   so the bits are the CPU twin's, on every run, with no atomics.  Blocks
//   of ops/segsum.py csr_threads (64-256 threads, from S*D) give every SM
//   blocks: the frame ordering's 18k outputs made 256-thread blocks
//   72 for 132 SMs.  On rows of at most 3 values in segments of at most 16
//   rows on average (csr_batch), a thread loads BATCH = 16 rows, every
//   load issued before the first add, so a segment waits one round trip
//   where the row-by-row loop waited several; elsewhere BATCH = 1, the
//   row-by-row loop the compiler unrolls, measured faster there (wider rows
//   already coalesce across d).  Two designs that stage whole segments in
//   shared memory — a block's tile read coalesced in 8 KB chunks, and a
//   warp's ~32/D segments read coalesced into its own chunk —
//   measured slower at every held shape (PERF.md).
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

// Thread (s, d) of sorted_segment_sum: out[s, d] = the rows [off[s],
// off[s+1]) of column d added in row order from zero.  The rows are loaded
// BATCH at a time, every load of a batch issued before the first add, so a
// segment of L rows waits ceil(L / BATCH) round trips instead of one per
// row (or per unrolled few).
template <typename T, int BATCH>
__global__ void __launch_bounds__(CSR_MAX_THREADS)
segsum_csr(const T* __restrict__ vals, const int* __restrict__ offsets,
           T* __restrict__ out, int S, int D) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(S) * D) return;
  const int s = static_cast<int>(t / D), d = static_cast<int>(t - s * D);
  const int r0 = __ldg(offsets + s), r1 = __ldg(offsets + s + 1);
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

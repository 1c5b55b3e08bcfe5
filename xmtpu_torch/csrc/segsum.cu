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
//   (SchurQ's bounds_l / bounds_f), and every output element (s, d) is owned
//   by one thread that sums its segment's rows of column d in row order:
//   no float atomics, no dependence on the band bound, the same bits on
//   every run.
//   Bound on the H100: bytes.  Each input element is read once and each
//   output written once; the arithmetic is one add per input element.  At
//   the implicit operator's sizes (E = 270k rows, D = 3..18) the pass moves
//   a few MB — microseconds of HBM time — so in practice it is bound by its
//   launch and by the longest segment a thread walks.  Neighbouring threads
//   own neighbouring columns of one segment, then the next segment's, so a
//   warp's loads fall on neighbouring rows of the row-major array.
//
// blocked_partial + blocked_combine replace
// xmtpu/ops/pallas_segsum.py::_kernel_blocked (via
// sorted_segment_sum_blocked): the same sum on the scheduled layout of
// plan_blocks / schedule_edges — G visits of `chunk` rows, each inside one
// output block of `sb` segments, zero-valued padding rows carrying the
// block's first id at the tail of a block's last visit, and an empty visit
// for every edge-less block.  The TPU kernel accumulated each visit's band
// partial into the resident output block in grid order.  Here
//   pass 1 (one thread block per visit) sums each (window segment, column)
//     of the visit into partial (G, band, D), with the TPU kernel's window
//     clamp; padding rows sit after the visit's sorted prefix and are left
//     out (they hold exact zeros);
//   pass 2 (one thread per output element) adds the partials of its block's
//     visits in visit order: the TPU kernel's accumulation order, with no
//     atomics across visits.
//
// Both are instantiated for float and double, each accumulating in its own
// type (the TPU kernel ran f32 at HIGHEST precision and f64 exactly).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// sum of rows [r0, r1) of column d of the row-major (rows, D) array, in
// row order
template <typename T>
__device__ __forceinline__ T run_sum(const T* __restrict__ vals, int D, int d,
                                     int64_t r0, int64_t r1) {
  T acc = T(0);
  for (int64_t r = r0; r < r1; ++r) acc = acc + __ldg(vals + r * D + d);
  return acc;
}

// first index i in the sorted a[0:n) with a[i] >= key
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
segsum_csr(const T* __restrict__ vals, const int* __restrict__ offsets,
           T* __restrict__ out, int S, int D) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(S) * D) return;
  int s = static_cast<int>(t / D), d = static_cast<int>(t % D);
  out[t] = run_sum(vals, D, d, __ldg(offsets + s), __ldg(offsets + s + 1));
}

// first segment (relative to the block) of visit g's band window: the TPU
// kernel's clamp, which keeps [start, start + band) inside the block
__device__ __forceinline__ int window_start(const int* ids, const int* blk,
                                            int g, int chunk, int sb,
                                            int band) {
  int local_first = __ldg(ids + static_cast<int64_t>(g) * chunk) -
                    __ldg(blk + g) * sb;
  return max(min(local_first, sb - band), 0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_partial(const T* __restrict__ vals, const int* __restrict__ ids,
                const int* __restrict__ blk, T* __restrict__ partial,
                int chunk, int sb, int band, int D) {
  extern __shared__ int sids[];  // this visit's chunk ids
  __shared__ int npre;           // length of the sorted prefix
  const int g = blockIdx.x;
  const int* gid = ids + static_cast<int64_t>(g) * chunk;
  for (int r = threadIdx.x; r < chunk; r += blockDim.x) sids[r] = gid[r];
  if (threadIdx.x == 0) npre = chunk;
  __syncthreads();
  // padding rows follow the visit's real rows and carry the block's first
  // id, so the first drop in the ids is where they start (an integer
  // minimum: the same result whatever the order of the atomics)
  for (int r = threadIdx.x + 1; r < chunk; r += blockDim.x) {
    if (sids[r] < sids[r - 1]) atomicMin(&npre, r);
  }
  __syncthreads();
  const int n = npre;
  const int base = __ldg(blk + g) * sb + window_start(ids, blk, g, chunk, sb,
                                                      band);
  const T* gv = vals + static_cast<int64_t>(g) * chunk * D;
  T* out = partial + static_cast<int64_t>(g) * band * D;
  for (int jd = threadIdx.x; jd < band * D; jd += blockDim.x) {
    int j = jd / D, d = jd % D;
    int r0 = lower_bound(sids, n, base + j);
    int r1 = lower_bound(sids, n, base + j + 1);
    out[jd] = run_sum(gv, D, d, r0, r1);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
blocked_combine(const T* __restrict__ partial, const int* __restrict__ ids,
                const int* __restrict__ blk, T* __restrict__ out, int G,
                int S, int chunk, int sb, int band, int D) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(S) * D) return;
  int s = static_cast<int>(t / D), d = static_cast<int>(t % D);
  int b = s / sb;
  // this block's visits are a contiguous run of the sorted blk
  int lo = lower_bound(blk, G, b), hi = lower_bound(blk, G, b + 1);
  T acc = T(0);
  for (int g = lo; g < hi; ++g) {
    int j = s - b * sb - window_start(ids, blk, g, chunk, sb, band);
    if (j >= 0 && j < band) {
      acc = acc + __ldg(partial + (static_cast<int64_t>(g) * band + j) * D +
                        d);
    }
  }
  out[t] = acc;
}

int grid_for(int64_t n) {
  return static_cast<int>((n + THREADS - 1) / THREADS);
}

template <typename T>
int launch_csr(const T* vals, const int* offsets, T* out, int S, int D,
               cudaStream_t s) {
  int64_t n = static_cast<int64_t>(S) * D;
  if (n == 0) return 0;
  segsum_csr<T><<<grid_for(n), THREADS, 0, s>>>(vals, offsets, out, S, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_blocked(const T* vals, const int* ids, const int* blk, T* partial,
                   T* out, int G, int S, int chunk, int sb, int band, int D,
                   cudaStream_t s) {
  int64_t n = static_cast<int64_t>(S) * D;
  if (n == 0 || G == 0) return 0;
  size_t smem = static_cast<size_t>(chunk) * sizeof(int);
  blocked_partial<T><<<G, THREADS, smem, s>>>(vals, ids, blk, partial, chunk,
                                               sb, band, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  blocked_combine<T><<<grid_for(n), THREADS, 0, s>>>(partial, ids, blk, out,
                                                     G, S, chunk, sb, band, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launches (0 on success).
int xm_segsum_f32(const float* vals, const int* offsets, float* out, int S,
                  int D, void* stream) {
  return launch_csr<float>(vals, offsets, out, S, D,
                           static_cast<cudaStream_t>(stream));
}

int xm_segsum_f64(const double* vals, const int* offsets, double* out, int S,
                  int D, void* stream) {
  return launch_csr<double>(vals, offsets, out, S, D,
                            static_cast<cudaStream_t>(stream));
}

int xm_segsum_blocked_f32(const float* vals, const int* ids, const int* blk,
                          float* partial, float* out, int G, int S, int chunk,
                          int sb, int band, int D, void* stream) {
  return launch_blocked<float>(vals, ids, blk, partial, out, G, S, chunk, sb,
                               band, D, static_cast<cudaStream_t>(stream));
}

int xm_segsum_blocked_f64(const double* vals, const int* ids, const int* blk,
                          double* partial, double* out, int G, int S,
                          int chunk, int sb, int band, int D, void* stream) {
  return launch_blocked<double>(vals, ids, blk, partial, out, G, S, chunk, sb,
                                band, D, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

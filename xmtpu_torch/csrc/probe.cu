// Measurement probes of the card (sm_90a), bound through a plain C
// interface (ctypes): no kernel of the package calls them.  chip_smoke.py
// times the dependent add with them in every run (a segment sum's chain
// floor); chip_profile.py --probe sweeps the read rates (the L2 read rate
// under chip_smoke.py's byte bounds).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// One thread: n dependent adds acc = acc + x, which the compiler may not
// reassociate; the sum is stored so the chain is kept.  Timed at two n, it
// gives the latency of one dependent add.
template <typename T>
__global__ void add_chain(T x, int n, T* out) {
  T acc = T(0);
  for (int i = 0; i < n; ++i) acc = acc + x;
  out[0] = acc;
}

// One 16-byte load through L2, not L1, that the compiler may not drop or
// merge with another.
__device__ __forceinline__ uint4 load_cg(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Reads the n16 16-byte words at p `passes` times, grid-stride, U loads
// in flight a thread, and folds them into a value that is stored only if
// it hits a constant: timed on a buffer that fits the 50 MB L2, its read
// rate; on a larger one, device memory's.
template <int U>
__global__ void read_words(const uint4* __restrict__ p, int64_t n16,
                           int passes, unsigned* out) {
  unsigned acc = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int k = 0; k < passes; ++k) {
    int64_t i = t0;
    for (; i + (U - 1) * step < n16; i += U * step) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = load_cg(p + i + u * step);
#pragma unroll
      for (int u = 0; u < U; ++u) acc += v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
    for (; i < n16; i += step) {
      const uint4 v = load_cg(p + i);
      acc += v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x9e3779b9u) out[0] = acc;
}

}  // namespace

extern "C" {

// n dependent adds on one thread, in float (item 4) or double (item 8).
int xm_probe_add_chain(int item, int n, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (item == 4)
    add_chain<float><<<1, 1, 0, s>>>(1.0f, n, static_cast<float*>(out));
  else if (item == 8)
    add_chain<double><<<1, 1, 0, s>>>(1.0, n, static_cast<double*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// `passes` reads of n16 16-byte words at p (16-byte aligned) by blocks x
// threads, `unroll` (1, 4 or 8) loads in flight a thread.
int xm_probe_read(const void* p, long long n16, int passes, int blocks,
                  int threads, int unroll, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* w = static_cast<const uint4*>(p);
  unsigned* o = static_cast<unsigned*>(out);
  if (unroll == 1)
    read_words<1><<<blocks, threads, 0, s>>>(w, n16, passes, o);
  else if (unroll == 4)
    read_words<4><<<blocks, threads, 0, s>>>(w, n16, passes, o);
  else if (unroll == 8)
    read_words<8><<<blocks, threads, 0, s>>>(w, n16, passes, o);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

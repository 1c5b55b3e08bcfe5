// The fused Steihaug-tCG kernel for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes); see xmtpu_torch/ops/fused_tcg.py.
//
// tcg_step_kernel<MAXO, false> (xm_tcg_step) replaces
// xmtpu/ops/pallas_tcg.py::_tcg_kernel (body _tcg_body):
//   one whole preconditioned Steihaug-tCG inner iteration except the operator
//   product — the ehess tail, ehess2rhess with its per-camera symmetric 3x3
//   Grams, pHp / alpha / the boundary root tau, the small / negative-curvature
//   / boundary / superlinear tests, six axpys, the projected block-Jacobi
//   preconditioner solve, rdotr / rdotz / beta and the end-reason flags.
//   Bound on the H100: bytes by count — ~11 (3o, n) f32 arrays read and 4
//   written, 3.2 MB at n=6144, o=3 (0.95 us at 3.35 TB/s) against a few
//   hundred flops a camera — but in practice latency: three phases of
//   dependent loads separated by two reductions over every camera (pHp, then
//   rdotr / rdotz), whose results every camera's next phase needs.
//   Design: one launch per iteration, spread over a thread-block cluster of
//   up to 16 blocks on neighbouring SMs (ops/fused_tcg.py step_geometry: one
//   block up to 128 cameras).  Each thread owns the same strided cameras in
//   all three phases, so per-camera intermediates (rh, z) go through a
//   thread-private scratch buffer with no cross-thread hazard, and the
//   camera-lane-major (3o, n) layout keeps every load coalesced.  Each
//   reduction is a fixed-order block sum (warp shuffles, then shared memory),
//   then cluster.sync() and every block reading all the blocks' partials
//   through distributed shared memory and adding them in block order: every
//   block holds the same bits, with no atomics and no global scratch, so the
//   Steihaug scalars agree across blocks and two launches give the same
//   bits.  The scalar carry lives in device memory: every block reads it
//   before the first barrier and one thread writes it after the last, and
//   every block returns at once when it says done or i >= max_inner, so the
//   host may enqueue several iterations between reads of the flag and get
//   the same result.
//
// tcg_step_kernel<MAXO, true> (xm_tcg_step_dense) replaces
// xmtpu/ops/pallas_tcg.py::_tcg_kernel_dense: the same iteration with the
// operator product CW = 2 C W, W = pR .* s_ex + R .* ps, inside the same
// launch, on the row-major f32 C (3n, 3n), n <= 512 (no permuted copy of C).
//   Bound on the H100: bytes — C is 9 n^2 f32 (9.4 MB at n=512) read once
//   per iteration against 2 o flops per element.  At n <= 512 C stays in
//   the 50 MB L2 across the Steihaug loop, so in practice the rate at which
//   the cluster's (at most 16) SMs pull C from L2, plus the iteration's
//   chain of round trips.  A separate product kernel doubled the launches
//   and the host's enqueue cost, which paces the solve.
//   Design: phase 0, then the split variant's body.  Each block owns a contiguous range
//   of cameras in every phase, so its rows of C are one contiguous slab.
//   Its warps stream those rows RW at a time in items of 16-byte loads, the
//   first item issued before the done guard and before W is built (in
//   shared memory, by every block, from pR and ps read before the first
//   cluster barrier), and each next item before the current one is added,
//   so loads stay in flight while the warp works.  A lane adds its columns
//   in order; the warp adds its 32 lane partials in lane order through
//   shared memory (a shuffle tree ran one shuffle at a time, each behind
//   the compiler's divergence guard, and cost more than the group's
//   FMAs).  CW goes to shared memory for phase 1 (and to CWt, as the plain
//   version writes it).  Phase 2 of this instantiation issues a camera's
//   loads of vR, hvR, rR, pR and its residual before its first store: in
//   the split loop each store may alias the next load, so every element
//   paid round trips in series.  At 256 threads (255 registers) MAXO = 4
//   does not spill (at 512, 128 registers, it did, in both phases).
//   The dense geometry (ops/fused_tcg.py dense_geometry) uses more blocks
//   than the split one — phase 0 wants SMs — and threads without a camera
//   add zeros to the reductions.  Every block reads pR and ps before the
//   first cluster barrier and phase 3 writes them after the second, so no
//   block sees another's update.

// MAXO is an upper bound on the rank o: rows j >= o are loaded as zeros (they
// add exact zeros to every sum) and never stored.  Instantiated for MAXO =
// 4, 8, 16, 32; the split instantiation compiles to the same SASS as before
// the dense one was added.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// scalar-carry slots (xmtpu/ops/pallas_tcg.py: S_* / C_*)
constexpr int S_RDOTR = 0, S_RDOTZ = 1, S_VDOTV = 2, S_VDOTP = 3, S_PDOTP = 4,
              S_ER = 5, S_DONE = 6, S_I = 7;
constexpr int C_LAM = 0, C_DELTA = 1, C_GNORM = 2, C_RMIN = 3;
constexpr float ER_NEGCURV = 1.f, ER_BOUNDARY = 2.f, ER_SUPERLINEAR = 3.f,
                ER_SMALL_RDOTR = 5.f, ER_MAX_INNER = 6.f;

struct StepArgs {
  const float* Rt;      // (3o, n) frames
  const float* s_ex;    // (n,) scales, s_ex[0] = 1
  const float* sfree;   // (n,) 1 on free cameras 1..n-1, else 0
  const float* inv_s2;  // (n,) 1/s^2 on free cameras, else 0
  const float* egs;     // (n,) euclidean scale gradient (slot 0 = 0)
  const float* Segrt;   // (9, n) sym(R egR^T)
  const float* CsRt;    // (3o, n) 2 Q sR
  const float* minvRt;  // (9, n) block-Jacobi inverse blocks
  const float* inv_ms;  // (n,) 1 / scale preconditioner (slot 0 = 0)
  const float* CWt;     // (3o, n) 2 Q W for this iteration (dense: written)
  float* vR; float* vs; float* rR; float* rs;
  float* pR; float* ps; float* hvR; float* hvs;
  float* sc;            // (8,) scalar carry, updated in place
  const float* cfg;     // (4,) lam, delta, gradnorm, rdotr_min
  float* work;          // ((2*3o + 1), n) thread-private scratch
  int n;
  int o;
  int max_inner;
  const float* C;       // dense variant: row-major (3n, 3n) f32; else null
};

__device__ __forceinline__ bool carry_stopped(const float* sc, int max_inner) {
  return sc[S_DONE] != 0.f || sc[S_I] >= static_cast<float>(max_inner);
}

template <int MAXO>
__device__ __forceinline__ void load_rows(const float* X, int n, int o, int i,
                                          float (&A)[3][MAXO]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < MAXO; ++j)
      A[k][j] = (j < o) ? X[static_cast<size_t>(k * o + j) * n + i] : 0.f;
}

template <int MAXO>
__device__ __forceinline__ void store_rows(float* X, int n, int o, int i,
                                           const float (&A)[3][MAXO]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < MAXO; ++j)
      if (j < o) X[static_cast<size_t>(k * o + j) * n + i] = A[k][j];
}

// S[k][l] = 0.5 * sum_j (A[k][j] B[l][j] + A[l][j] B[k][j])
template <int MAXO>
__device__ __forceinline__ void gram3_sym(const float (&A)[3][MAXO],
                                          const float (&B)[3][MAXO],
                                          float (&S)[3][3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int l = k; l < 3; ++l) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < MAXO; ++j) acc += A[k][j] * B[l][j] + A[l][j] * B[k][j];
      S[k][l] = S[l][k] = 0.5f * acc;
    }
}

// X[k][j] -= sum_l S[k][l] R[l][j]
template <int MAXO>
__device__ __forceinline__ void sub_apply3(const float (&S)[3][3],
                                           const float (&R)[3][MAXO],
                                           float (&X)[3][MAXO]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < MAXO; ++j)
      X[k][j] -= S[k][0] * R[0][j] + S[k][1] * R[1][j] + S[k][2] * R[2][j];
}

// Block-wide sums of NV values per thread, in a fixed order: a shuffle tree
// inside each warp, then warp 0 reduces the per-warp partials.  Every thread
// gets the sums.  blockDim.x is a multiple of 32, at most 1024.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < NV; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) smem[q * 32 + warp] = v[q];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) v[q] = lane < nwarps ? smem[q * 32 + lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] += __shfl_down_sync(0xffffffffu, v[q], off);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < NV; ++q) smem[q * 32] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = smem[q * 32];
  __syncthreads();  // smem is reused by the next reduction
}

// Threads a tcg_step block may have: the cap __launch_bounds__ gives the
// compiler: at most 128 registers a thread for MAXO <= 8, 255 above (ptxas
// keeps MAXO = 4 within them; 8, 16 and 32 spill a little, more, most).
// The dense variant keeps its product's accumulators and a batch of C, and
// phase 2's loads, in registers: 256 threads, 255 registers, at every MAXO.
template <int MAXO, bool DENSE = false>
struct StepCap {
  static constexpr int threads = DENSE ? 256 : (MAXO <= 8 ? 512 : 256);
};
constexpr int MAX_CLUSTER = 16;  // blocks of one tcg_step launch
// devices whose launch state launch_step remembers (a device past them
// sets its attributes and checks its fit at every launch)
constexpr int MAX_DEVICES = 64;

// After block_sum: v holds this block's partials (the same in every thread).
// On return v holds the sums over every block of the cluster, added in
// block order from the blocks' shared memory (distributed shared memory),
// so every block holds the same bits.  mine: this reduction's own slot
// (NV floats); allp: every block's partials (blocks * NV floats).
template <int NV>
__device__ __forceinline__ void cluster_sum(float (&v)[NV], float* mine,
                                            float* allp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = gridDim.x, m = nb * NV;
  if (threadIdx.x == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) mine[q] = v[q];
  cluster.sync();
  for (int t = threadIdx.x; t < m; t += blockDim.x)
    allp[t] = *cluster.map_shared_rank(mine + t % NV, t / NV);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float acc = 0.f;
    for (int b = 0; b < nb; ++b) acc += allp[b * NV + q];
    v[q] = acc;
  }
  __syncthreads();  // allp is reused by the next reduction
}

// Rows of C a warp of the dense product streams together: each float4 of W
// read from shared memory serves all of them (RW * MAXO accumulators a lane).
template <int MAXO>
struct DenseRows {
  static constexpr int value = MAXO <= 4 ? 4 : (MAXO <= 8 ? 2 : 1);
};
// float4 columns a lane loads of each of its RW rows at a time: an item of
// RW * DENSE_COLS loads a lane, the next item in flight while one is added
constexpr int DENSE_COLS = 4;
// The product's lane sums go through shared memory, DENSE_PASS values a
// pass, each lane of the warp adding one value's 32 partials in lane order
// (a shuffle tree cost a serialized shuffle a value and level: the
// compiler guards each against divergence); rows padded to 33 floats so
// that neither the writes nor the reads conflict.
constexpr int DENSE_PASS = 16;
constexpr int DENSE_RED_FLOATS = DENSE_PASS * 33;  // a warp's scratch

// The dense variant's shared memory: W (o columns of 3n floats, padded to a
// multiple of 4), this block's CW (3o rows of cpb cameras) and each warp's
// reduction scratch.  ops/fused_tcg.py dense_smem_bytes computes the same.
__host__ __device__ inline size_t dense_smem_floats(int n, int o, int cpb,
                                                    int threads) {
  return static_cast<size_t>(o) * ((3 * n + 3) & ~3) +
         static_cast<size_t>(3 * o) * cpb +
         static_cast<size_t>(threads / 32) * DENSE_RED_FLOATS;
}

// Columns 4q..4q+3 of a row of the row-major (m, m) C.  VEC: 16-byte
// aligned rows (m % 4 == 0 and an aligned C), one 16-byte load; else four
// scalar loads, zero past column m.
template <bool VEC>
__device__ __forceinline__ float4 load_c4(const float* __restrict__ row,
                                          int m, int q) {
  const float* p = row + 4 * q;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  const int c = 4 * q;
  return make_float4(__ldg(p), c + 1 < m ? __ldg(p + 1) : 0.f,
                     c + 2 < m ? __ldg(p + 2) : 0.f,
                     c + 3 < m ? __ldg(p + 3) : 0.f);
}

// Loads of one item of a warp's share of the product: rows g .. g+RW-1 of
// C (below r1), float4 columns q0 + 32 t (below mq), zeros elsewhere.
template <int RW, bool VEC>
__device__ __forceinline__ void dense_load(const float* __restrict__ C, int g,
                                           int r1, int m, int mq, int q0,
                                           float4 (&cv)[DENSE_COLS][RW]) {
#pragma unroll
  for (int u = 0; u < RW; ++u) {
    const bool live = g + u < r1;
    const float* row = C + static_cast<size_t>(live ? g + u : g) * m;
#pragma unroll
    for (int t = 0; t < DENSE_COLS; ++t)
      cv[t][u] = live && q0 + 32 * t < mq
                     ? load_c4<VEC>(row, m, q0 + 32 * t)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Phase 0 of the dense variant: CW = 2 C W for this block's cameras
// [c0, c1), into CWsh[(k*o + j) * cpb + i - c0] and CWt.
//   The warps take the rows [3 c0, 3 c1) RW at a time (warp w from
//   3 c0 + w RW, every warps * RW rows), each group of rows in items of
//   32 * DENSE_COLS float4 columns; a lane adds its columns q = lane,
//   lane + 32, ... of each row in that order, and the warp adds its lanes'
//   partials in lane order through shared memory, so every run gives the
//   same bits.  Each item's loads are issued before the previous item is
//   added (the first before the done guard and W), so a warp keeps one
//   item in flight while it works.  Every block builds all of W from pR,
//   ps (read here, before the first cluster barrier), Rt and s_ex, a
//   thread per camera.
template <int MAXO, bool VEC>
__device__ __forceinline__ bool dense_product_v(const StepArgs& a, int c0,
                                                int c1, int cpb) {
  constexpr int RW = DenseRows<MAXO>::value, NV = RW * MAXO;
  constexpr int QSTEP = 32 * DENSE_COLS;
  const int n = a.n, o = a.o, m = 3 * n, mq = (m + 3) >> 2, mp = mq << 2;
  const float* __restrict__ C = a.C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gstep = (blockDim.x >> 5) * RW, r1 = 3 * c1;
  extern __shared__ float4 dense_smem[];
  float* Wsh = reinterpret_cast<float*>(dense_smem);  // Wsh[j * mp + 3i + k]
  float* CWsh = Wsh + static_cast<size_t>(o) * mp;
  float* red = CWsh + static_cast<size_t>(3 * o) * cpb +
               static_cast<size_t>(warp) * DENSE_RED_FLOATS;
  const float4* W4 = dense_smem;                      // W4[j * mq + q]

  // items: (group g, columns from qb); the first is loaded now
  int g = 3 * c0 + warp * RW, qb = 0;
  float4 cur[DENSE_COLS][RW], nxt[DENSE_COLS][RW];
  dense_load<RW, VEC>(C, g, r1, m, mq, lane, cur);
  // uniform across the launch: sc is written only after the last barrier
  if (carry_stopped(a.sc, a.max_inner)) return false;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float se = a.s_ex[i], su = a.ps[i];
    float w[3][MAXO];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        if (j < o) {
          const size_t off = static_cast<size_t>(k * o + j) * n + i;
          w[k][j] = a.pR[off] * se + a.Rt[off] * su;
        }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        if (j < o) Wsh[j * mp + 3 * i + k] = w[k][j];
  }
  for (int idx = threadIdx.x; idx < o * (mp - m); idx += blockDim.x) {
    const int j = idx / (mp - m);
    Wsh[j * mp + m + idx - j * (mp - m)] = 0.f;
  }
  __syncthreads();

  float acc[RW][MAXO];
#pragma unroll
  for (int u = 0; u < RW; ++u)
#pragma unroll
    for (int j = 0; j < MAXO; ++j) acc[u][j] = 0.f;
  while (g < r1) {  // warp-uniform: every lane takes every item
    // the next item, in flight while this one is added
    int gn = g, qn = qb + QSTEP;
    if (qn >= mq) gn += gstep, qn = 0;
    if (gn < r1) dense_load<RW, VEC>(C, gn, r1, m, mq, qn + lane, nxt);
#pragma unroll
    for (int t = 0; t < DENSE_COLS; ++t) {
      const int q = qb + lane + 32 * t;
      if (q < mq) {
#pragma unroll
        for (int j = 0; j < MAXO; ++j) {
          if (j < o) {
            const float4 w = W4[j * mq + q];
#pragma unroll
            for (int u = 0; u < RW; ++u) {
              acc[u][j] = fmaf(cur[t][u].x, w.x, acc[u][j]);
              acc[u][j] = fmaf(cur[t][u].y, w.y, acc[u][j]);
              acc[u][j] = fmaf(cur[t][u].z, w.z, acc[u][j]);
              acc[u][j] = fmaf(cur[t][u].w, w.w, acc[u][j]);
            }
          }
        }
      }
    }
    if (gn != g) {  // the group's last item: its sums, written by lane v
      float* cwt = const_cast<float*>(a.CWt);
#pragma unroll
      for (int p0 = 0; p0 < NV; p0 += DENSE_PASS) {
        constexpr int PASS = NV < DENSE_PASS ? NV : DENSE_PASS;
#pragma unroll
        for (int e = 0; e < PASS; ++e)
          red[e * 33 + lane] = acc[(p0 + e) / MAXO][(p0 + e) % MAXO];
        __syncwarp();
        const int v = p0 + lane, u = v / MAXO, j = v - u * MAXO;
        if (lane < PASS && j < o && g + u < r1) {
          float sum = 0.f;
#pragma unroll
          for (int l = 0; l < 32; ++l) sum += red[lane * 33 + l];
          const int r = g + u, i = r / 3, k = r - 3 * i;
          const float val = 2.f * sum;
          CWsh[(k * o + j) * cpb + i - c0] = val;
          cwt[static_cast<size_t>(k * o + j) * n + i] = val;
        }
        __syncwarp();  // red is rewritten by the next pass
      }
#pragma unroll
      for (int u = 0; u < RW; ++u)
#pragma unroll
        for (int j = 0; j < MAXO; ++j) acc[u][j] = 0.f;
    }
    g = gn;
    qb = qn;
#pragma unroll
    for (int t = 0; t < DENSE_COLS; ++t)
#pragma unroll
      for (int u = 0; u < RW; ++u) cur[t][u] = nxt[t][u];
  }
  __syncthreads();  // CWsh complete before phase 1 reads it
  return true;
}

// Phase 0 (dense_product_v); false, before any write, on a done carry.
template <int MAXO>
__device__ __forceinline__ bool dense_product(const StepArgs& a, int c0,
                                              int c1, int cpb) {
  if ((3 * a.n & 3) == 0 && (reinterpret_cast<uintptr_t>(a.C) & 15) == 0)
    return dense_product_v<MAXO, true>(a, c0, c1, cpb);
  return dense_product_v<MAXO, false>(a, c0, c1, cpb);
}

// Phase 2's vector updates of camera i for the dense variant, every load of
// a batch of (k, j) entries issued before any store: the split loop below
// interleaves them, so each store to vR, hvR or rR (which may alias the
// next load for all the compiler knows) costs the next load a round trip.
// Same arithmetic, same bits; Rn receives the new rR.
template <int MAXO>
__device__ __forceinline__ void dense_axpys(const StepArgs& a,
                                            const float* rh_w, int i,
                                            float coef, float step_a,
                                            float (&Rn)[3][MAXO]) {
  constexpr int NR = 3 * MAXO, BATCH = NR < 12 ? NR : 12;
  const int n = a.n, o = a.o;
#pragma unroll
  for (int b0 = 0; b0 < NR; b0 += BATCH) {
    float v[BATCH], hv[BATCH], r[BATCH], p[BATCH], rh[BATCH];
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int k = (b0 + e) / MAXO, j = (b0 + e) % MAXO;
      if (j < o) {
        const size_t off = static_cast<size_t>(k * o + j) * n + i;
        v[e] = a.vR[off];
        hv[e] = a.hvR[off];
        r[e] = a.rR[off];
        p[e] = a.pR[off];
        rh[e] = rh_w[off];
      }
    }
#pragma unroll
    for (int e = 0; e < BATCH; ++e) {
      const int k = (b0 + e) / MAXO, j = (b0 + e) % MAXO;
      Rn[k][j] = 0.f;
      if (j < o) {
        const size_t off = static_cast<size_t>(k * o + j) * n + i;
        a.vR[off] = v[e] + coef * p[e];
        a.hvR[off] = hv[e] + coef * rh[e];
        const float rn = r[e] + step_a * rh[e];
        a.rR[off] = rn;
        Rn[k][j] = rn;
      }
    }
  }
}

template <int MAXO, bool DENSE>
__global__ void __launch_bounds__(StepCap<MAXO, DENSE>::threads)
    tcg_step_kernel(StepArgs a) {
  __shared__ float red[4 * 32];
  __shared__ float mine[2][4];  // this block's partials, one slot a reduction
  __shared__ float allp[4 * MAX_CLUSTER];
  const float* sc = a.sc;
  // uniform across the launch: sc is written only after the last barrier
  // (the dense variant checks it in phase 0, its first loads of C issued)
  if constexpr (!DENSE)
    if (carry_stopped(sc, a.max_inner)) return;

  const int n = a.n, o = a.o;
  const bool split = gridDim.x > 1;
  // split: thread t of block b takes cameras b*threads + t + k*blocks*threads
  // (last = n); dense: block b takes the contiguous cameras [c0, last),
  // c0 = b*cpb, thread t every threads-th of them from c0 + t
  int first, stride, last, c0 = 0, cpb = 0;
  const float* cwsh = nullptr;  // dense: this block's CW in shared memory
  if constexpr (DENSE) {
    cpb = (n + gridDim.x - 1) / gridDim.x;
    c0 = blockIdx.x * cpb;
    first = c0 + threadIdx.x;
    stride = blockDim.x;
    last = min(n, c0 + cpb);
    if (!dense_product<MAXO>(a, c0, last, cpb)) return;
    extern __shared__ float4 dense_smem[];
    cwsh = reinterpret_cast<const float*>(dense_smem) +
           static_cast<size_t>(o) * ((3 * n + 3) & ~3);
  } else {
    first = blockIdx.x * blockDim.x + threadIdx.x;
    stride = gridDim.x * blockDim.x;
    last = n;
  }
  const float lam = a.cfg[C_LAM], delta = a.cfg[C_DELTA];
  const float gradnorm = a.cfg[C_GNORM], rdotr_min = a.cfg[C_RMIN];
  const float rdotr = sc[S_RDOTR], rdotz = sc[S_RDOTZ];
  const float vdotv = sc[S_VDOTV], vdotp = sc[S_VDOTP], pdotp = sc[S_PDOTP];
  const float s_i = sc[S_I];
  float* rh_w = a.work;                                   // rows 0..3o-1
  float* rhs_w = a.work + static_cast<size_t>(3 * o) * n;  // row 3o
  float* z_w = rhs_w + n;                                 // rows 3o+1..6o

  // ---- phase 1: Hessian tail, ehess2rhess, pHp ---------------------------
  float part[2] = {0.f, 0.f};  // sum p.rh, sum ps rhs / s^2
  for (int i = first; i < last; i += stride) {
    float R[3][MAXO], P[3][MAXO], H[3][MAXO];
    load_rows<MAXO>(a.Rt, n, o, i, R);
    load_rows<MAXO>(a.pR, n, o, i, P);
    const float sex = a.s_ex[i], su = a.ps[i], msk = a.sfree[i];
    const float is2 = a.inv_s2[i], eg = a.egs[i];
    float dcw = 0.f, dcs = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j) {
        float cw = 0.f, cs = 0.f;
        if (j < o) {
          const size_t off = static_cast<size_t>(k * o + j) * n + i;
          if constexpr (DENSE)
            cw = cwsh[(k * o + j) * cpb + i - c0];
          else
            cw = a.CWt[off];
          cs = a.CsRt[off];
        }
        H[k][j] = cs * su + cw * sex;
        dcw += cw * R[k][j];
        dcs += cs * P[k][j];
      }
    const float hs =
        (dcw + dcs + 4.f * lam * (3.f * sex * sex - 1.f) * su) * msk;
    float Seg[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l) Seg[k][l] = a.Segrt[(k * 3 + l) * n + i];
    sub_apply3<MAXO>(Seg, P, H);  // rh = h - Seg p
    float S2[3][3];
    gram3_sym<MAXO>(R, H, S2);
    sub_apply3<MAXO>(S2, R, H);   // rh = P_R(rh)
    const float rhs = (hs * sex * sex + su * sex * eg) * msk;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j) part[0] += P[k][j] * H[k][j];
    part[1] += su * rhs * is2;
    store_rows<MAXO>(rh_w, n, o, i, H);
    rhs_w[i] = rhs;
  }
  block_sum<2>(part, red);
  if (split) cluster_sum<2>(part, mine[0], allp);
  const float pHp = part[0] + part[1];

  // ---- Steihaug scalars (identical in every thread of every block) -------
  const float alpha = rdotz / pHp;
  const bool small = rdotr < rdotr_min;
  const bool negcurv = !small && (alpha <= 0.f);
  const float boundary_q = vdotv + 2.f * alpha * vdotp + alpha * alpha * pdotp;
  const bool exceed = !small && !negcurv && (boundary_q > delta * delta);
  const bool to_edge = negcurv || exceed;
  const bool normal = !small && !to_edge;
  float q = vdotp * vdotp + pdotp * (delta * delta - vdotv);
  q = q < 0.f ? 0.f : q;  // maximum(q, 0), NaN propagating
  const float tau = (-vdotp + sqrtf(q)) / pdotp;
  const float coef = to_edge ? tau : (normal ? alpha : 0.f);
  const float step_a = normal ? alpha : 0.f;

  // ---- phase 2: axpys, residual norms, preconditioner --------------------
  float sums[4] = {0.f, 0.f, 0.f, 0.f};  // rr_R, rr_s, rz_R, rz_s
  for (int i = first; i < last; i += stride) {
    float R[3][MAXO], Rn[3][MAXO], Z[3][MAXO];
    load_rows<MAXO>(a.Rt, n, o, i, R);
    const float su = a.ps[i], is2 = a.inv_s2[i], rhs = rhs_w[i];
    float rs;
    if constexpr (DENSE) {
      const float vs = a.vs[i], hvs = a.hvs[i], rs0 = a.rs[i];
      dense_axpys<MAXO>(a, rh_w, i, coef, step_a, Rn);
      a.vs[i] = vs + coef * su;
      a.hvs[i] = hvs + coef * rhs;
      rs = rs0 + step_a * rhs;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int j = 0; j < MAXO; ++j) {
          Rn[k][j] = 0.f;
          if (j < o) {
            const size_t off = static_cast<size_t>(k * o + j) * n + i;
            const float rh = rh_w[off];
            a.vR[off] += coef * a.pR[off];
            a.hvR[off] += coef * rh;
            const float r = a.rR[off] + step_a * rh;
            a.rR[off] = r;
            Rn[k][j] = r;
          }
        }
      a.vs[i] += coef * su;
      a.hvs[i] += coef * rhs;
      rs = a.rs[i] + step_a * rhs;
    }
    a.rs[i] = rs;
    float Mv[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l) Mv[k][l] = a.minvRt[(k * 3 + l) * n + i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        Z[k][j] = Mv[k][0] * Rn[0][j] + Mv[k][1] * Rn[1][j] + Mv[k][2] * Rn[2][j];
    float Sz[3][3];
    gram3_sym<MAXO>(R, Z, Sz);
    sub_apply3<MAXO>(Sz, R, Z);
    const float zs = rs * a.inv_ms[i];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < MAXO; ++j) {
        sums[0] += Rn[k][j] * Rn[k][j];
        sums[2] += Rn[k][j] * Z[k][j];
      }
    sums[1] += rs * rs * is2;
    sums[3] += rs * zs * is2;
    store_rows<MAXO>(z_w, n, o, i, Z);
  }
  block_sum<4>(sums, red);
  if (split) cluster_sum<4>(sums, mine[1], allp);
  const float rdotr_new = sums[0] + sums[1];
  const float rdotz_new = sums[2] + sums[3];
  const bool superlin =
      normal && (sqrtf(rdotr_new) < gradnorm * fminf(gradnorm, 0.1f));
  const float beta = rdotz_new / rdotz;

  // ---- phase 3: new search direction and the scalar carry ----------------
  if (normal) {
    for (int i = first; i < last; i += stride) {
      for (int r = 0; r < 3 * o; ++r) {
        const size_t off = static_cast<size_t>(r) * n + i;
        a.pR[off] = -z_w[off] + beta * a.pR[off];
      }
      a.ps[i] = -(a.rs[i] * a.inv_ms[i]) + beta * a.ps[i];
    }
  }
  if (first == 0) {
    float* s = a.sc;
    if (normal) {
      s[S_VDOTV] = vdotv + 2.f * alpha * vdotp + alpha * alpha * pdotp;
      s[S_VDOTP] = beta * (vdotp + alpha * pdotp);
      s[S_PDOTP] = beta * beta * pdotp + rdotz_new;
      s[S_RDOTR] = rdotr_new;
      s[S_RDOTZ] = rdotz_new;
    }
    s[S_ER] = small ? ER_SMALL_RDOTR
                    : (negcurv ? ER_NEGCURV
                               : (exceed ? ER_BOUNDARY
                                         : (superlin ? ER_SUPERLINEAR
                                                     : ER_MAX_INNER)));
    s[S_DONE] = (small || to_edge || superlin) ? 1.f : 0.f;
    s[S_I] = s_i + 1.f;
  }
  // no block of the cluster leaves while another may still read its mine[1]
  if (split) cg::this_cluster().sync();
}

// What launch_step has set up on one device for one instantiation: a CUDA
// function attribute holds for the device current when it was set, so
// each device keeps its own (the dynamic shared memory allowed so far, the
// non-portable cluster sizes allowed, and the last few geometries checked
// against the card: blocks, threads, shared memory, and whether a cluster
// of them fits).
struct Fit {
  int blocks, threads;
  size_t smem;
  bool ok;
};
struct LaunchState {
  size_t allowed;
  bool nonportable;
  Fit seen[16];
  int nseen;
};

// One tcg_step launch of `blocks` blocks of `threads` threads (the geometry
// of ops/fused_tcg.py step_geometry, or dense_geometry for DENSE): one block,
// a plain launch; several, one thread-block cluster.  A cluster the card
// cannot schedule returns cudaErrorLaunchOutOfResources.
template <int MAXO, bool DENSE>
int launch_step(const StepArgs& a, int blocks, int threads,
                cudaStream_t stream) {
  auto kern = tcg_step_kernel<MAXO, DENSE>;
  if (threads < 32 || threads % 32 != 0 ||
      threads > StepCap<MAXO, DENSE>::threads || blocks < 1 ||
      blocks > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  static LaunchState states[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchState fresh = {};
  LaunchState& st = dev < MAX_DEVICES ? states[dev] : fresh;
  size_t smem = 0;
  if constexpr (DENSE) {
    if (a.C == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    smem = sizeof(float) *
           dense_smem_floats(a.n, a.o, (a.n + blocks - 1) / blocks, threads);
    // raise the dynamic shared-memory cap as far as a launch needs (a size
    // the card refuses fails here)
    if (smem > 48 * 1024 && smem > st.allowed) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      st.allowed = smem;
    }
  }
  if (blocks == 1) {
    kern<<<1, threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // the non-portable sizes (above 8) are allowed once, and each (blocks,
  // threads, shared memory) is checked against the card once
  if (!st.nonportable) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    st.nonportable = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Fit* fit = nullptr;
  for (int k = 0; k < st.nseen && k < 16; ++k)
    if (st.seen[k].blocks == blocks && st.seen[k].threads == threads &&
        st.seen[k].smem == smem)
      fit = &st.seen[k];
  if (fit == nullptr) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    Fit& slot = st.seen[st.nseen++ % 16];
    slot = Fit{blocks, threads, smem, clusters > 0};
    fit = &slot;
  }
  if (!fit->ok) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool DENSE>
int launch_rank(const StepArgs& a, int blocks, int threads,
                cudaStream_t stream) {
  if (a.o <= 4) return launch_step<4, DENSE>(a, blocks, threads, stream);
  if (a.o <= 8) return launch_step<8, DENSE>(a, blocks, threads, stream);
  if (a.o <= 16) return launch_step<16, DENSE>(a, blocks, threads, stream);
  if (a.o <= 32) return launch_step<32, DENSE>(a, blocks, threads, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 on success).
int xm_tcg_step(const float* Rt, const float* s_ex, const float* sfree,
                const float* inv_s2, const float* egs, const float* Segrt,
                const float* CsRt, const float* minvRt, const float* inv_ms,
                const float* CWt, float* vR, float* vs, float* rR, float* rs,
                float* pR, float* ps, float* hvR, float* hvs, float* sc,
                const float* cfg, float* work, int n, int o, int max_inner,
                int blocks, int threads, void* stream) {
  StepArgs a{Rt, s_ex, sfree, inv_s2, egs, Segrt, CsRt, minvRt, inv_ms, CWt,
             vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg, work, n, o,
             max_inner, nullptr};
  return launch_rank<false>(a, blocks, threads,
                            static_cast<cudaStream_t>(stream));
}

// The dense variant: the same arguments after the row-major (3n, 3n) C;
// CWt receives this iteration's product.
int xm_tcg_step_dense(const float* C, const float* Rt, const float* s_ex,
                      const float* sfree, const float* inv_s2,
                      const float* egs, const float* Segrt, const float* CsRt,
                      const float* minvRt, const float* inv_ms, float* CWt,
                      float* vR, float* vs, float* rR, float* rs, float* pR,
                      float* ps, float* hvR, float* hvs, float* sc,
                      const float* cfg, float* work, int n, int o,
                      int max_inner, int blocks, int threads, void* stream) {
  StepArgs a{Rt, s_ex, sfree, inv_s2, egs, Segrt, CsRt, minvRt, inv_ms, CWt,
             vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg, work, n, o,
             max_inner, C};
  return launch_rank<true>(a, blocks, threads,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"

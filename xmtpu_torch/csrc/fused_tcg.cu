// Fused Steihaug-tCG kernels for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes); see xmtpu_torch/ops/fused_tcg.py.
//
// tcg_step replaces xmtpu/ops/pallas_tcg.py::_tcg_kernel (body _tcg_body):
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
//   up to 16 blocks on neighbouring SMs (the geometry comes from
//   ops/fused_tcg.py step_geometry: one block up to 128 cameras).  A single
//   block moved the whole ~5 MB working set through one SM (0.073 ms at
//   n=6144); the cluster moves it through 16.  Each thread owns the same
//   strided cameras in all three phases, so per-camera intermediates (rh, z)
//   go through a thread-private scratch buffer with no cross-thread hazard,
//   and the camera-lane-major (3o, n) layout keeps every load coalesced.
//   Each reduction is a fixed-order block sum (warp shuffles, then shared
//   memory), then cluster.sync() and every block reading all the blocks'
//   partials through distributed shared memory and adding them in block
//   order: every block holds the same bits, with no atomics and no global
//   scratch, so the Steihaug scalars agree across blocks and two launches
//   give the same bits.  The scalar carry lives in device memory: every
//   block reads it before the first barrier and one thread writes it after
//   the last, and every block returns at once when it says done or
//   i >= max_inner, so the host may enqueue several iterations between
//   reads of the flag and get the same result.  A cooperative grid over
//   more SMs (partials through global memory, grid.sync()) measured 3-6 %
//   faster at n=6144 but 7-23 % slower at n=1934, and needs global scratch.
//
// tcg_cw_dense replaces the in-kernel GEMM of
// xmtpu/ops/pallas_tcg.py::_tcg_kernel_dense (its lines building W and
// CW = 2 C W from the permuted Cp):
//   CWt = 2 C W with W = pR .* s_ex + R .* ps, written in the (3o, n) layout,
//   on the row-major f32 C (3n, 3n) — no permuted copy of C is needed.
//   Bound on the H100: bytes — C is 9 n^2 f32 (9.4 MB at n=512) read once
//   per iteration against 2 o flops per element.  Design: every block builds
//   W (3n x o) in shared memory (conflict-free column-major), then one warp
//   per output row streams that row of C with coalesced loads and reduces its
//   o dot products by warp shuffles in a fixed order (deterministic).  At the
//   gated sizes (n <= 512) C stays resident in the 50 MB L2 across the tCG
//   loop.
//
// Both kernels are templated on MAXO, an upper bound on the rank o: rows
// j >= o are loaded as zeros (they add exact zeros to every sum) and never
// stored.  Instantiated for MAXO = 4, 8, 16, 32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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
  const float* CWt;     // (3o, n) 2 Q W for this iteration
  float* vR; float* vs; float* rR; float* rs;
  float* pR; float* ps; float* hvR; float* hvs;
  float* sc;            // (8,) scalar carry, updated in place
  const float* cfg;     // (4,) lam, delta, gradnorm, rdotr_min
  float* work;          // ((2*3o + 1), n) thread-private scratch
  int n;
  int o;
  int max_inner;
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
template <int MAXO>
struct StepCap {
  static constexpr int threads = MAXO <= 8 ? 512 : 256;
};
constexpr int MAX_CLUSTER = 16;  // blocks of one tcg_step launch

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

template <int MAXO>
__global__ void __launch_bounds__(StepCap<MAXO>::threads)
    tcg_step_kernel(StepArgs a) {
  __shared__ float red[4 * 32];
  __shared__ float mine[2][4];  // this block's partials, one slot a reduction
  __shared__ float allp[4 * MAX_CLUSTER];
  const float* sc = a.sc;
  // uniform across the launch: sc is written only after the last barrier
  if (carry_stopped(sc, a.max_inner)) return;

  const int n = a.n, o = a.o;
  const bool split = gridDim.x > 1;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
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
  for (int i = first; i < n; i += stride) {
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
  for (int i = first; i < n; i += stride) {
    float R[3][MAXO], Rn[3][MAXO], Z[3][MAXO];
    load_rows<MAXO>(a.Rt, n, o, i, R);
    const float su = a.ps[i], is2 = a.inv_s2[i], rhs = rhs_w[i];
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
    const float rs = a.rs[i] + step_a * rhs;
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
    for (int i = first; i < n; i += stride) {
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

constexpr int kCwThreads = 256;

template <int MAXO>
__global__ void __launch_bounds__(kCwThreads)
    tcg_cw_dense_kernel(const float* __restrict__ C, const float* Rt,
                        const float* s_ex, const float* pR, const float* ps,
                        const float* sc, float* CWt, int n, int o,
                        int max_inner) {
  extern __shared__ float Wsh[];  // Wsh[j * 3n + r], r = 3i + k
  if (carry_stopped(sc, max_inner)) return;
  const int m = 3 * n;
  for (int idx = threadIdx.x; idx < m * o; idx += blockDim.x) {
    const int j = idx / m, r = idx - j * m;
    const int i = r / 3, k = r - 3 * i;
    const size_t off = static_cast<size_t>(k * o + j) * n + i;
    Wsh[idx] = pR[off] * s_ex[i] + Rt[off] * ps[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < m;
       r += gridDim.x * warps) {
    const float* row = C + static_cast<size_t>(r) * m;
    float acc[MAXO];
#pragma unroll
    for (int j = 0; j < MAXO; ++j) acc[j] = 0.f;
    for (int c = lane; c < m; c += 32) {
      const float cv = __ldg(row + c);
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        if (j < o) acc[j] += cv * Wsh[j * m + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
    if (lane == 0) {
      const int i = r / 3, k = r - 3 * i;
#pragma unroll
      for (int j = 0; j < MAXO; ++j)
        if (j < o) CWt[static_cast<size_t>(k * o + j) * n + i] = 2.f * acc[j];
    }
  }
}

// One tcg_step launch of `blocks` blocks of `threads` threads (the geometry
// of ops/fused_tcg.py step_geometry): one block, a plain launch; several,
// one thread-block cluster.  A cluster the card cannot schedule returns
// cudaErrorLaunchOutOfResources.
template <int MAXO>
int launch_step(const StepArgs& a, int blocks, int threads,
                cudaStream_t stream) {
  auto kern = tcg_step_kernel<MAXO>;
  if (threads < 32 || threads % 32 != 0 || threads > StepCap<MAXO>::threads ||
      blocks < 1 || blocks > MAX_CLUSTER)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks == 1) {
    kern<<<1, threads, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // per instantiation: the non-portable sizes (above 8) are allowed once,
  // and each (blocks, threads) is checked against the card once
  static bool nonportable = false;
  static signed char fits[MAX_CLUSTER + 1][StepCap<MAXO>::threads / 32 + 1];
  if (!nonportable) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    nonportable = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  signed char& fit = fits[blocks][threads / 32];
  if (fit == 0) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit = clusters > 0 ? 1 : -1;
  }
  if (fit < 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int MAXO>
int launch_cw(const float* C, const float* Rt, const float* s_ex,
              const float* pR, const float* ps, const float* sc, float* CWt,
              int n, int o, int max_inner, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(3 * n) * o;
  cudaError_t err = cudaFuncSetAttribute(
      tcg_cw_dense_kernel<MAXO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kCwThreads / 32;
  int blocks = (3 * n + warps - 1) / warps;
  if (blocks > 4 * 132) blocks = 4 * 132;
  tcg_cw_dense_kernel<MAXO><<<blocks, kCwThreads, smem, stream>>>(
      C, Rt, s_ex, pR, ps, sc, CWt, n, o, max_inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int xm_tcg_step(const float* Rt, const float* s_ex, const float* sfree,
                const float* inv_s2, const float* egs, const float* Segrt,
                const float* CsRt, const float* minvRt, const float* inv_ms,
                const float* CWt, float* vR, float* vs, float* rR, float* rs,
                float* pR, float* ps, float* hvR, float* hvs, float* sc,
                const float* cfg, float* work, int n, int o, int max_inner,
                int blocks, int threads, void* stream) {
  StepArgs a{Rt, s_ex, sfree, inv_s2, egs, Segrt, CsRt, minvRt, inv_ms, CWt,
             vR, vs, rR, rs, pR, ps, hvR, hvs, sc, cfg, work, n, o,
             max_inner};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o <= 4) return launch_step<4>(a, blocks, threads, s);
  if (o <= 8) return launch_step<8>(a, blocks, threads, s);
  if (o <= 16) return launch_step<16>(a, blocks, threads, s);
  if (o <= 32) return launch_step<32>(a, blocks, threads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int xm_tcg_cw_dense(const float* C, const float* Rt, const float* s_ex,
                    const float* pR, const float* ps, const float* sc,
                    float* CWt, int n, int o, int max_inner, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o <= 4) return launch_cw<4>(C, Rt, s_ex, pR, ps, sc, CWt, n, o, max_inner, s);
  if (o <= 8) return launch_cw<8>(C, Rt, s_ex, pR, ps, sc, CWt, n, o, max_inner, s);
  if (o <= 16) return launch_cw<16>(C, Rt, s_ex, pR, ps, sc, CWt, n, o, max_inner, s);
  if (o <= 32) return launch_cw<32>(C, Rt, s_ex, pR, ps, sc, CWt, n, o, max_inner, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

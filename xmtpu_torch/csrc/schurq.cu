// The float32 product of the implicit Schur-complement operator (SchurQ) for
// Hopper (sm_90a): four kernels around the VT_inv GEMM, bound to Python
// through a plain C interface (ctypes); see xmtpu_torch/ops/schurq.py
// (schurq_product).
//
// Replaces no TPU kernel: the reference leaves this product to XLA, which
// fuses its gathers and per-edge products around the segment-sum kernel
// (xmtpu/ops/schurq.py).  Run eagerly through the seams, each of the
// product's four edge sums builds an (E, D) block of edge rows from gathers,
// per-column products, adds and a cat, then sums it with sorted_segment_sum:
// 36 launches and 0.34 ms of device time a product on an H100 at BAL
// Ladybug-1723 (o = 3), most of it spent on those intermediates.  Here each
// edge row is made where it is summed.  With Y = Yb (n, 3, o), and Q1Y =
// Q1[f] Y[f], bA = V1[f] . Y[f] the seams' own two einsums:
//   1. by landmark: b_B = -sum_e wx_l[e, :] . Y[f_l[e]],  t = inv_sqrt_q3 b_B
//   2. by frame:    rhs[f - 1] = bA[f] + sum_e cf_f[e] t[l_f[e]],  f >= 1
//   3. (torch)      x_A = (VT_inv @ rhs)[: n - 1]
//   4. by landmark: x_B = inv_q3 b_B + inv_sqrt_q3 sum_e cf_l[e] x_pad[f_l[e]]
//   5. by frame:    out[f] = Q1Y[f]
//                            - (V1[f] (x) z_t[f] - sum_e wx_f[e, :] (x) x_B[l_f[e]])
// where x_pad = z_t = [0; x_A], its row 0 read as zero and never stored.
// The arithmetic is the seams' (SchurQ.apply, solve_M, _vtpT, _vtp) term
// for term: each product and sum rounded on its own (__fmul_rn, __fadd_rn:
// nothing contracted into an fma) in the seams' order, and each segment's
// rows added in row order from zero, as sorted_segment_sum adds them.  So
// the product has the seams' bits, on every run.
//   Bound on the H100: bytes.  A pass over an edge ordering reads each
// edge's index (8 B) and weights (4 or 12 B) once; the gathered rows (Y,
// 3n x o; t and x_B, m x o) sit in L2.  At Ladybug-1723 (E = 678,862) the
// four move 57.9 MB at o = 3 with their other inputs and outputs: 17.3 us at
// 3.35 TB/s.  In practice each sum waits for chains of loads (a row's
// index, then its gather) and for its chain of dependent adds.
//   Design.  Landmark sums (short segments: 4.3 rows a landmark at
// Ladybug-1723, heavy-tailed in BAL's real tracks): a thread a landmark
// walks its rows in order, WALK_U rows in flight (their indices and weights
// loaded, then their gathers, then their adds).  Frame sums (long
// segments: 394 rows a camera at Ladybug-1723), and each landmark of more
// than long_rows rows (listed by the bounds' host plan, ops/segsum.py
// CsrPlan): a block a segment; its threads make a tile of THREADS x TILE_U
// rows at once into shared memory, in row order, and one adder a value adds
// the tile's rows in that order, the next rows' loads issued before the
// current rows' adds.  No atomics anywhere.  A launch takes OC <= MAX_OC of
// the o columns (a template parameter); wider ranks launch each kernel once
// per chunk of columns.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;  // every block
constexpr int MAX_OC = 8;     // columns a launch (ops/schurq.py FUSED_COLUMNS)
constexpr int WALK_U = 4;     // rows a landmark's thread has in flight
constexpr int ADD_U = 8;      // rows an adder loads before it adds them

// A launch's columns: rows of o values, columns j0 .. j0 + OC - 1.
struct Cols {
  int o, j0;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ---- the edge rows of the four sums ----
// A row type gives edge(e) (its index and weights), gather(edge, g) (the
// gathered values) and values(edge, g, v) (the row's NV values, rounded as
// the seams round them); TILE_U rows a thread when a block stages a tile.

// 1: the landmark-sorted row sum_a wx_l[e, a] * Y[f_l[e], a, j]
// (_wx_dot_rows: the three products, then added a = 0, 1, 2).
template <int OC>
struct YRow {
  static constexpr int NV = OC, G = 3 * OC, TILE_U = OC <= 4 ? 4 : 2;
  struct Edge {
    int64_t f;
    float w[3];
  };
  const int64_t* f_l;
  const float* wx_l;
  const float* Y;
  Cols c;
  __device__ __forceinline__ Edge edge(int64_t e) const {
    Edge ed;
    ed.f = __ldg(f_l + e);
#pragma unroll
    for (int a = 0; a < 3; ++a) ed.w[a] = __ldg(wx_l + 3 * e + a);
    return ed;
  }
  __device__ __forceinline__ void gather(const Edge& ed, float (&g)[G]) const {
    const float* y = Y + ed.f * 3 * c.o + c.j0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int jj = 0; jj < OC; ++jj) g[a * OC + jj] = __ldg(y + a * c.o + jj);
  }
  __device__ __forceinline__ void values(const Edge& ed, const float (&g)[G],
                                         float (&v)[NV]) const {
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) {
      float r = mul(ed.w[0], g[jj]);
      r = add(r, mul(ed.w[1], g[OC + jj]));
      v[jj] = add(r, mul(ed.w[2], g[2 * OC + jj]));
    }
  }
};

// 2 and 4: the row w[e] * x[i[e], j] of a scalar weight and a gathered row
// of x; with PAD, row i of x is x's row i - 1 and row 0 reads zero (x_pad =
// [0; x_A]).  2: _cf_f_rows of t; 4: _cf_l_rows of x_pad.
template <int OC, bool PAD>
struct ScaledRow {
  static constexpr int NV = OC, G = OC, TILE_U = 4;
  struct Edge {
    int64_t i;
    float w;
  };
  const int64_t* idx;
  const float* cw;
  const float* x;
  Cols c;
  __device__ __forceinline__ Edge edge(int64_t e) const {
    return Edge{__ldg(idx + e), __ldg(cw + e)};
  }
  __device__ __forceinline__ void gather(const Edge& ed, float (&g)[G]) const {
    const int64_t r = PAD ? ed.i - 1 : ed.i;
    const float* xr = x + r * c.o + c.j0;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj)
      g[jj] = (!PAD || r >= 0) ? __ldg(xr + jj) : 0.0f;
  }
  __device__ __forceinline__ void values(const Edge& ed, const float (&g)[G],
                                         float (&v)[NV]) const {
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) v[jj] = mul(ed.w, g[jj]);
  }
};

// 5: the frame-sorted rows wx_f[e, a] * x_B[l_f[e], j], a-major
// (_wx_outer_rows).
template <int OC>
struct OuterRow {
  static constexpr int NV = 3 * OC, G = OC, TILE_U = OC <= 4 ? 4 : 2;
  struct Edge {
    int64_t l;
    float w[3];
  };
  const int64_t* l_f;
  const float* wx_f;
  const float* x_B;
  Cols c;
  __device__ __forceinline__ Edge edge(int64_t e) const {
    Edge ed;
    ed.l = __ldg(l_f + e);
#pragma unroll
    for (int a = 0; a < 3; ++a) ed.w[a] = __ldg(wx_f + 3 * e + a);
    return ed;
  }
  __device__ __forceinline__ void gather(const Edge& ed, float (&g)[G]) const {
    const float* xr = x_B + ed.l * c.o + c.j0;
#pragma unroll
    for (int jj = 0; jj < OC; ++jj) g[jj] = __ldg(xr + jj);
  }
  __device__ __forceinline__ void values(const Edge& ed, const float (&g)[G],
                                         float (&v)[NV]) const {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int jj = 0; jj < OC; ++jj) v[a * OC + jj] = mul(ed.w[a], g[jj]);
  }
};

// ---- the schedules ----

// A thread's walk: acc plus the rows [e, end) of `row`, added in row order,
// WALK_U rows at a time (their indices and weights loaded, then their
// gathers, then their adds).
template <class Row>
__device__ __forceinline__ void walk(const Row& row, int64_t e, int64_t end,
                                     float (&acc)[Row::NV]) {
  for (; e < end; e += WALK_U) {
    typename Row::Edge ed[WALK_U];
    float g[WALK_U][Row::G];
#pragma unroll
    for (int u = 0; u < WALK_U; ++u)
      if (e + u < end) ed[u] = row.edge(e + u);
#pragma unroll
    for (int u = 0; u < WALK_U; ++u)
      if (e + u < end) row.gather(ed[u], g[u]);
#pragma unroll
    for (int u = 0; u < WALK_U; ++u)
      if (e + u < end) {
        float v[Row::NV];
        row.values(ed[u], g[u], v);
#pragma unroll
        for (int k = 0; k < Row::NV; ++k) acc[k] = add(acc[k], v[k]);
      }
  }
}

// acc plus s[0], s[D], ..., s[(rows - 1) D] added in that order, ADD_U
// rows loaded from shared memory before the previous ADD_U are added.
template <int D>
__device__ __forceinline__ float add_rows(float acc, const float* s,
                                          int rows) {
  const int full = rows - rows % ADD_U;
  int i = 0;
  if (full > 0) {
    float x[ADD_U];
#pragma unroll
    for (int u = 0; u < ADD_U; ++u) x[u] = s[u * D];
    for (; i + ADD_U < full; i += ADD_U) {
      float y[ADD_U];
#pragma unroll
      for (int u = 0; u < ADD_U; ++u) y[u] = s[(i + ADD_U + u) * D];
#pragma unroll
      for (int u = 0; u < ADD_U; ++u) acc = add(acc, x[u]);
#pragma unroll
      for (int u = 0; u < ADD_U; ++u) x[u] = y[u];
    }
#pragma unroll
    for (int u = 0; u < ADD_U; ++u) acc = add(acc, x[u]);
    i = full;
  }
  for (; i < rows; ++i) acc = add(acc, s[i * D]);
  return acc;
}

// A block's segment: rows [r0, r1) of `row`, THREADS x TILE_U at a time.
// Thread k makes the tile's rows k, k + THREADS, ... (all their indices
// and weights loaded, then their gathers) into `tile`, row by row in edge
// order; then adder v < NV adds value v of the tile's rows in that order.
// Every thread of the block must call it; adder v returns the sum of
// value v (0 for an empty segment), the others 0.
template <class Row>
__device__ __forceinline__ float block_segment(const Row& row, int64_t r0,
                                               int64_t r1, float* tile) {
  constexpr int NV = Row::NV, TU = Row::TILE_U, T = THREADS * TU;
  const int k = threadIdx.x;
  float acc = 0.0f;
  for (int64_t base = r0; base < r1; base += T) {
    typename Row::Edge ed[TU];
    float g[TU][Row::G];
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (base + u * THREADS + k < r1) ed[u] = row.edge(base + u * THREADS + k);
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (base + u * THREADS + k < r1) row.gather(ed[u], g[u]);
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (base + u * THREADS + k < r1) {
        float v[NV];
        row.values(ed[u], g[u], v);
#pragma unroll
        for (int q = 0; q < NV; ++q) tile[(u * THREADS + k) * NV + q] = v[q];
      }
    __syncthreads();
    if (k < NV)
      acc = add_rows<NV>(acc, tile + k,
                         static_cast<int>(r1 - base < T ? r1 - base : T));
    __syncthreads();  // the tile is free for the next rows
  }
  return acc;
}

// A sum by landmark: block j < n_long sums the long segment longs[j] =
// (landmark, first row, end row) (block_segment); the rest give each
// landmark of at most long_rows rows a thread.  put(l, jj, s) stores value
// jj of landmark l's sum s.
template <class Row, class Put>
__device__ __forceinline__ void by_landmark(const Row& row, const Put& put,
                                            const int* bounds,
                                            const int* longs, int m,
                                            int n_long, int long_rows,
                                            float* tile) {
  const int j = blockIdx.x;
  if (j < n_long) {
    const float s = block_segment(row, __ldg(longs + 3 * j + 1),
                                  __ldg(longs + 3 * j + 2), tile);
    if (threadIdx.x < Row::NV) put(__ldg(longs + 3 * j), threadIdx.x, s);
    return;
  }
  const int l = (j - n_long) * THREADS + threadIdx.x;
  if (l >= m) return;
  const int r0 = __ldg(bounds + l), r1 = __ldg(bounds + l + 1);
  if (r1 - r0 > long_rows) return;  // a block of its own sums it
  float acc[Row::NV];
#pragma unroll
  for (int k = 0; k < Row::NV; ++k) acc[k] = 0.0f;
  walk(row, r0, r1, acc);
#pragma unroll
  for (int k = 0; k < Row::NV; ++k) put(l, k, acc[k]);
}

// ---- the four kernels ----

// 1: b_B = -(sum), t = inv_sqrt_q3 b_B.
template <int OC>
__global__ void __launch_bounds__(THREADS)
schurq_landmark_y(const float* __restrict__ Y, const int64_t* __restrict__ f_l,
                  const float* __restrict__ wx_l,
                  const int* __restrict__ bounds_l,
                  const int* __restrict__ longs,
                  const float* __restrict__ inv_sqrt_q3,
                  float* __restrict__ b_B, float* __restrict__ t, int m,
                  int n_long, int long_rows, Cols c) {
  using Row = YRow<OC>;
  __shared__ float tile[THREADS * Row::TILE_U * Row::NV];
  auto put = [&](int l, int jj, float s) {
    const int64_t i = static_cast<int64_t>(l) * c.o + c.j0 + jj;
    const float b = -s;
    b_B[i] = b;
    t[i] = mul(__ldg(inv_sqrt_q3 + l), b);
  };
  by_landmark(Row{f_l, wx_l, Y, c}, put, bounds_l, longs, m, n_long,
              long_rows, tile);
}

// 2: rhs[f - 1] = bA[f] + (sum), cameras f >= 1.
template <int OC>
__global__ void __launch_bounds__(THREADS)
schurq_frame_t(const float* __restrict__ bA, const int64_t* __restrict__ l_f,
               const float* __restrict__ cf_f,
               const int* __restrict__ bounds_f, const float* __restrict__ t,
               float* __restrict__ rhs, Cols c) {
  using Row = ScaledRow<OC, false>;
  __shared__ float tile[THREADS * Row::TILE_U * Row::NV];
  const int f = blockIdx.x + 1;
  const float s = block_segment(Row{l_f, cf_f, t, c}, __ldg(bounds_f + f),
                                __ldg(bounds_f + f + 1), tile);
  if (threadIdx.x < OC) {
    const int j = c.j0 + threadIdx.x;
    rhs[static_cast<int64_t>(f - 1) * c.o + j] =
        add(__ldg(bA + static_cast<int64_t>(f) * c.o + j), s);
  }
}

// 4: x_B = inv_q3 b_B + inv_sqrt_q3 (sum).
template <int OC>
__global__ void __launch_bounds__(THREADS)
schurq_landmark_x(const float* __restrict__ x_A,
                  const int64_t* __restrict__ f_l,
                  const float* __restrict__ cf_l,
                  const int* __restrict__ bounds_l,
                  const int* __restrict__ longs,
                  const float* __restrict__ inv_q3,
                  const float* __restrict__ inv_sqrt_q3,
                  const float* __restrict__ b_B, float* __restrict__ x_B,
                  int m, int n_long, int long_rows, Cols c) {
  using Row = ScaledRow<OC, true>;
  __shared__ float tile[THREADS * Row::TILE_U * Row::NV];
  auto put = [&](int l, int jj, float s) {
    const int64_t i = static_cast<int64_t>(l) * c.o + c.j0 + jj;
    x_B[i] = add(mul(__ldg(inv_q3 + l), __ldg(b_B + i)),
                 mul(__ldg(inv_sqrt_q3 + l), s));
  };
  by_landmark(Row{f_l, cf_l, x_A, c}, put, bounds_l, longs, m, n_long,
              long_rows, tile);
}

// 5: out[f, a] = Q1Y[f, a] - (V1[f, a] z_t[f] - (sum)[a]).
template <int OC>
__global__ void __launch_bounds__(THREADS)
schurq_frame_out(const float* __restrict__ Q1Y, const float* __restrict__ V1,
                 const float* __restrict__ x_A,
                 const int64_t* __restrict__ l_f,
                 const float* __restrict__ wx_f,
                 const int* __restrict__ bounds_f,
                 const float* __restrict__ x_B, float* __restrict__ out,
                 Cols c) {
  using Row = OuterRow<OC>;
  __shared__ float tile[THREADS * Row::TILE_U * Row::NV];
  const int f = blockIdx.x;
  const float s = block_segment(Row{l_f, wx_f, x_B, c}, __ldg(bounds_f + f),
                                __ldg(bounds_f + f + 1), tile);
  if (threadIdx.x < 3 * OC) {
    const int a = threadIdx.x / OC, j = c.j0 + threadIdx.x - a * OC;
    const int64_t i = static_cast<int64_t>(f) * 3 * c.o + a * c.o + j;
    const float z =
        f > 0 ? __ldg(x_A + static_cast<int64_t>(f - 1) * c.o + j) : 0.0f;
    out[i] = sub(__ldg(Q1Y + i), sub(mul(__ldg(V1 + 3 * f + a), z), s));
  }
}

// ---- launches ----

struct Forward {
  const float* Y;
  const float* bA;
  const int64_t* f_l;
  const float* wx_l;
  const int* bounds_l;
  const int* longs;
  const int64_t* l_f;
  const float* cf_f;
  const int* bounds_f;
  const float* inv_sqrt_q3;
  float *b_B, *t, *rhs;
  int n, m, o, n_long, long_rows;
};

struct Finish {
  const float *Q1Y, *V1, *x_A;
  const int64_t* f_l;
  const float* cf_l;
  const int* bounds_l;
  const int* longs;
  const int64_t* l_f;
  const float* wx_f;
  const int* bounds_f;
  const float *inv_q3, *inv_sqrt_q3, *b_B;
  float *x_B, *out;
  int n, m, o, n_long, long_rows;
};

unsigned landmark_blocks(int m, int n_long) {
  return static_cast<unsigned>(n_long + (m + THREADS - 1) / THREADS);
}

template <int OC>
struct ForwardChunk {
  static void run(const Forward& a, Cols c, cudaStream_t s) {
    if (a.m > 0)
      schurq_landmark_y<OC><<<landmark_blocks(a.m, a.n_long), THREADS, 0, s>>>(
          a.Y, a.f_l, a.wx_l, a.bounds_l, a.longs, a.inv_sqrt_q3, a.b_B, a.t,
          a.m, a.n_long, a.long_rows, c);
    if (a.n > 1)
      schurq_frame_t<OC><<<a.n - 1, THREADS, 0, s>>>(a.bA, a.l_f, a.cf_f,
                                                     a.bounds_f, a.t, a.rhs, c);
  }
};

template <int OC>
struct FinishChunk {
  static void run(const Finish& a, Cols c, cudaStream_t s) {
    if (a.m > 0)
      schurq_landmark_x<OC><<<landmark_blocks(a.m, a.n_long), THREADS, 0, s>>>(
          a.x_A, a.f_l, a.cf_l, a.bounds_l, a.longs, a.inv_q3, a.inv_sqrt_q3,
          a.b_B, a.x_B, a.m, a.n_long, a.long_rows, c);
    schurq_frame_out<OC><<<a.n, THREADS, 0, s>>>(
        a.Q1Y, a.V1, a.x_A, a.l_f, a.wx_f, a.bounds_f, a.x_B, a.out, c);
  }
};

// Each chunk of at most MAX_OC columns through the instantiation of its
// width.
template <class Args, template <int> class Chunk>
int by_chunks(const Args& a, cudaStream_t s) {
  if (a.n < 1 || a.o < 1 || a.m < 0 || a.n_long < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j0 = 0; j0 < a.o; j0 += MAX_OC) {
    const Cols c{a.o, j0};
    switch (a.o - j0 < MAX_OC ? a.o - j0 : MAX_OC) {
      case 1: Chunk<1>::run(a, c, s); break;
      case 2: Chunk<2>::run(a, c, s); break;
      case 3: Chunk<3>::run(a, c, s); break;
      case 4: Chunk<4>::run(a, c, s); break;
      case 5: Chunk<5>::run(a, c, s); break;
      case 6: Chunk<6>::run(a, c, s); break;
      case 7: Chunk<7>::run(a, c, s); break;
      default: Chunk<8>::run(a, c, s); break;
    }
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

}  // namespace

extern "C" {

// Stages 1 and 2 of the product (file comment): b_B, t (m x o) and rhs
// ((n - 1) x o) from Y (3n x o) and bA (n x o).  `longs` (on the card, or
// null with n_long = 0) holds the landmark ordering's n_long segments of
// more than long_rows rows as (landmark, first row, end row).  Returns the
// cudaError_t of the launches (0 on success).
int xm_schurq_forward(const float* Y, const float* bA, const int64_t* f_l,
                      const float* wx_l, const int* bounds_l,
                      const int* longs, const int64_t* l_f, const float* cf_f,
                      const int* bounds_f, const float* inv_sqrt_q3,
                      float* b_B, float* t, float* rhs, int n, int m, int o,
                      int n_long, int long_rows, void* stream) {
  const Forward a{Y,   bA,   f_l,      wx_l,        bounds_l, longs,
                  l_f, cf_f, bounds_f, inv_sqrt_q3, b_B,      t,
                  rhs, n,    m,        o,           n_long,   long_rows};
  return by_chunks<Forward, ForwardChunk>(a,
                                          static_cast<cudaStream_t>(stream));
}

// Stages 4 and 5: x_B (m x o) and the product out (3n x o) from Q1Y (3n x
// o), x_A ((n - 1) x o, stage 3's GEMM) and stage 1's b_B.
int xm_schurq_finish(const float* Q1Y, const float* V1, const float* x_A,
                     const int64_t* f_l, const float* cf_l,
                     const int* bounds_l, const int* longs,
                     const int64_t* l_f, const float* wx_f,
                     const int* bounds_f, const float* inv_q3,
                     const float* inv_sqrt_q3, const float* b_B, float* x_B,
                     float* out, int n, int m, int o, int n_long,
                     int long_rows, void* stream) {
  const Finish a{Q1Y,      V1,     x_A,         f_l,  cf_l,   bounds_l,
                 longs,    l_f,    wx_f,        bounds_f,     inv_q3,
                 inv_sqrt_q3,      b_B,         x_B,  out,    n,
                 m,        o,      n_long,      long_rows};
  return by_chunks<Finish, FinishChunk>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

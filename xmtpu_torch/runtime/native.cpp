// Native runtime kernel for xmtpu_torch: union-find connected components.
//
// A copy of xmtpu/runtime/native.cpp's xmtpu_connected_components (the
// port never loads the reference's library).  The view-graph cleanup keeps
// the largest connected component of the bipartite frame-landmark graph; a
// union-find over the edges is a pointer-chasing loop that numpy does not
// vectorize, so it is a small C ABI consumed through ctypes.
//
// Build: see xmtpu_torch/runtime/__init__.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <utility>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  std::vector<int8_t> rank_;

  explicit UnionFind(int64_t n) : parent(n), rank_(n, 0) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    // path compression
    while (parent[x] != root) {
      int64_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (rank_[a] < rank_[b]) std::swap(a, b);
    parent[b] = a;
    if (rank_[a] == rank_[b]) rank_[a]++;
  }
};

}  // namespace

extern "C" {

// Union-find over edges (u[i], v[i]) on nodes [0, n_nodes).
// labels[n] receives a compact component id in [0, n_components), numbered
// in order of each component's first node.  Returns the number of
// components.
int64_t xmtpu_connected_components(const int64_t* u, const int64_t* v,
                                   int64_t n_edges, int64_t n_nodes,
                                   int64_t* labels) {
  UnionFind uf(n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) uf.unite(u[e], v[e]);
  std::vector<int64_t> compact(n_nodes, -1);
  int64_t n_comp = 0;
  for (int64_t n = 0; n < n_nodes; ++n) {
    int64_t r = uf.find(n);
    if (compact[r] < 0) compact[r] = n_comp++;
    labels[n] = compact[r];
  }
  return n_comp;
}

}  // extern "C"

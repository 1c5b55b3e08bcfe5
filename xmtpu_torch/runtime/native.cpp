// Native runtime kernels for xmtpu_torch: union-find connected components
// and track establishment.
//
// A copy of xmtpu/runtime/native.cpp (the port never loads the reference's
// library).  The view-graph cleanup keeps the largest connected component of
// the bipartite frame-landmark graph, and the mapper merges pairwise feature
// matches into tracks; both are union-find loops that numpy does not
// vectorize, so they are a small C ABI consumed through ctypes.
//
// Build: see xmtpu_torch/runtime/__init__.py (g++ -O3 -shared -fPIC).

#include <algorithm>
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

// GLOMAP-style track establishment: pairwise feature matches (a[i], b[i])
// over pre-compacted observation node ids [0, n_nodes) are merged into
// tracks; track_of[n] receives the compact track id of node n, sized by
// descending track size (track 0 = largest), mirroring GLOMAP's
// size-ordered track ids.  Returns the number of tracks.  Kept identical to
// the reference's, std::sort included, so that tracks of equal size take
// the same ids in both packages.
int64_t xmtpu_establish_tracks(const int64_t* a, const int64_t* b,
                               int64_t n_matches, int64_t n_nodes,
                               int64_t* track_of) {
  UnionFind uf(n_nodes);
  for (int64_t e = 0; e < n_matches; ++e) uf.unite(a[e], b[e]);

  std::vector<int64_t> root_id(n_nodes, -1);
  std::vector<int64_t> sizes;
  for (int64_t n = 0; n < n_nodes; ++n) {
    int64_t r = uf.find(n);
    if (root_id[r] < 0) {
      root_id[r] = static_cast<int64_t>(sizes.size());
      sizes.push_back(0);
    }
    track_of[n] = root_id[r];
    sizes[root_id[r]]++;
  }
  // order track ids by descending size
  int64_t n_tracks = static_cast<int64_t>(sizes.size());
  std::vector<int64_t> order(n_tracks);
  for (int64_t i = 0; i < n_tracks; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t x, int64_t y) { return sizes[x] > sizes[y]; });
  std::vector<int64_t> remap(n_tracks);
  for (int64_t i = 0; i < n_tracks; ++i) remap[order[i]] = i;
  for (int64_t n = 0; n < n_nodes; ++n) track_of[n] = remap[track_of[n]];
  return n_tracks;
}

}  // extern "C"

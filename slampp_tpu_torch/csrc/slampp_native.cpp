// Host-side minimum-degree ordering for slampp_tpu_torch (a copy of the
// JAX package's native/slampp_native.cpp).
//
// The reference's symbolic machinery is C/C++ (bundled AMD/CAMD wrapped by
// OrderingMagic.cpp); this is the port's native minimum-degree ordering,
// called through ctypes by slampp_tpu_torch/core/ordering.py, whose
// pure-Python min_degree_ordering_py is its plain reference.
//
// Exposed C ABI:
//   slampp_min_degree_order(n, rowptr, colidx, constrained_last, n_last, perm)
//       minimum-degree ordering on an undirected CSR adjacency with
//       pin-to-last ordering constraints (CLastElementOrderingConstraint
//       analog); returns 0 on success.
//
// Built at first use with the host C++ compiler (-O2 -std=c++17 -fPIC
// -shared) into slampp_tpu_torch/_build/ (ops/_cuda.compile_shared).

#include <cstddef>
#include <cstdint>
#include <queue>
#include <unordered_set>
#include <vector>

extern "C" {

// Minimum-degree ordering with elimination-graph updates.  Matches the
// Python implementation in core/ordering.py (same tie-breaking:
// lazy heap with stale-entry skipping, smallest (degree, node) first).
int64_t slampp_min_degree_order(int64_t n, const int64_t* rowptr,
                                const int64_t* colidx,
                                const int64_t* constrained_last,
                                int64_t n_last, int64_t* perm) {
  std::vector<char> is_last(n, 0);
  for (int64_t i = 0; i < n_last; ++i) {
    if (constrained_last[i] < 0 || constrained_last[i] >= n) return -1;
    is_last[constrained_last[i]] = 1;
  }

  std::vector<std::unordered_set<int64_t>> nbrs(n);
  for (int64_t v = 0; v < n; ++v) {
    for (int64_t k = rowptr[v]; k < rowptr[v + 1]; ++k) {
      int64_t u = colidx[k];
      if (u != v) nbrs[v].insert(u);
    }
  }

  typedef std::pair<int64_t, int64_t> DegNode;  // (degree, node)
  std::priority_queue<DegNode, std::vector<DegNode>, std::greater<DegNode>> heap;
  for (int64_t v = 0; v < n; ++v) {
    if (!is_last[v]) heap.push({(int64_t)nbrs[v].size(), v});
  }

  std::vector<char> eliminated(n, 0);
  int64_t pos = 0;
  std::vector<int64_t> live;
  while (!heap.empty()) {
    auto [d, v] = heap.top();
    heap.pop();
    if (eliminated[v] || is_last[v]) continue;
    if (d != (int64_t)nbrs[v].size()) {
      heap.push({(int64_t)nbrs[v].size(), v});
      continue;
    }
    eliminated[v] = 1;
    perm[pos++] = v;
    live.clear();
    for (int64_t u : nbrs[v]) {
      if (!eliminated[u]) live.push_back(u);
    }
    for (int64_t a : live) {
      auto& s = nbrs[a];
      s.erase(v);
      size_t before = s.size();
      for (int64_t b : live) {
        if (b != a) s.insert(b);
      }
      if (s.size() != before) heap.push({(int64_t)s.size(), a});
    }
  }
  // constrained blocks last, ascending
  for (int64_t v = 0; v < n; ++v) {
    if (is_last[v]) perm[pos++] = v;
  }
  return pos == n ? 0 : -2;
}

}  // extern "C"

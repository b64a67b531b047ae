// Exact multi-label MRF minimization: alpha-expansion over max-flow.
//
// Native counterpart of the reference's gco subsystem
// (include/gco/GCoptimization.h:158-246, src/gco/maxflow.cpp) for the
// motion-segmentation energy of ops/graphcut.py:
//
//   E(l) = sum_i D(i, l_i) + sum_{ij in E} w_ij * [l_i != l_j]   (Potts)
//
// Design is original: Dinic's blocking-flow max-flow (not gco's
// Boykov-Kolmogorov tree-reuse algorithm) under the Boykov-Veksler-Zabih
// alpha-expansion move construction (auxiliary node per cross-label
// neighbor pair).  The device path (mean-field + ICM, ops/graphcut.segment)
// stays the production segmenter; this solver is the exactness oracle it
// is validated against (SURVEY.md §7 "Graph-cut exactness") and an
// offline refiner for host-side discovery.
//
// Build: make -C multimot_track_tpu/native libmmt_graphcut.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr double kInf = 1e30;

// ---------------------------------------------------------------- Dinic
struct Dinic {
  struct Edge {
    int to;
    double cap;
    int rev;  // index of the reverse edge in g[to]
  };
  std::vector<std::vector<Edge>> g;
  std::vector<int> level, it;
  int n;

  explicit Dinic(int n_) : g(n_), level(n_), it(n_), n(n_) {}

  void add_edge(int a, int b, double cap_ab, double cap_ba) {
    g[a].push_back({b, cap_ab, (int)g[b].size()});
    g[b].push_back({a, cap_ba, (int)g[a].size() - 1});
  }

  bool bfs(int s, int t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int> q;
    level[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : g[v])
        if (e.cap > 1e-12 && level[e.to] < 0) {
          level[e.to] = level[v] + 1;
          q.push(e.to);
        }
    }
    return level[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int& i = it[v]; i < (int)g[v].size(); ++i) {
      Edge& e = g[v][i];
      if (e.cap > 1e-12 && level[v] < level[e.to]) {
        double d = dfs(e.to, t, std::min(f, e.cap));
        if (d > 0) {
          e.cap -= d;
          g[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  double max_flow(int s, int t) {
    double flow = 0;
    while (bfs(s, t)) {
      std::fill(it.begin(), it.end(), 0);
      double f;
      while ((f = dfs(s, t, kInf)) > 0) flow += f;
    }
    return flow;
  }

  // After max_flow: nodes reachable from s in the residual graph.
  void min_cut_side(int s, std::vector<char>& in_source) const {
    in_source.assign(n, 0);
    std::queue<int> q;
    in_source[s] = 1;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : g[v])
        if (e.cap > 1e-12 && !in_source[e.to]) {
          in_source[e.to] = 1;
          q.push(e.to);
        }
    }
  }
};

double total_energy(int n_sites, int n_labels, const float* D, int n_edges,
                    const int32_t* ei, const int32_t* ej, const float* ew,
                    const int32_t* labels) {
  double e = 0;
  for (int i = 0; i < n_sites; ++i) e += D[(size_t)i * n_labels + labels[i]];
  for (int k = 0; k < n_edges; ++k)
    if (labels[ei[k]] != labels[ej[k]]) e += ew[k];
  return e;
}

// One alpha-expansion move (BVZ construction).  Returns the move's cut
// cost; labels are updated in place when the move lowers the energy.
//
// Convention (matches the construction in the file header comment):
//   source side = keep current label, sink side = switch to alpha.
//   t-link s->i: cap D(i, alpha);  t-link i->t: cap D(i, l_i)
//   (infinite for l_i == alpha: the uncuttable i->t edge forces those
//   sites onto the SINK side, i.e. they are assigned alpha — a no-op).
//   l_i == l_j: undirected edge cap w.
//   l_i != l_j: auxiliary node a with undirected edges i-a, a-j (cap w)
//   and t-link a->t (cap w).
void expand(int alpha, int n_sites, int n_labels, const float* D, int n_edges,
            const int32_t* ei, const int32_t* ej, const float* ew,
            std::vector<int32_t>& labels) {
  int n_aux = 0;
  for (int k = 0; k < n_edges; ++k)
    if (labels[ei[k]] != labels[ej[k]]) ++n_aux;

  const int S = n_sites + n_aux;
  const int T = S + 1;
  Dinic din(n_sites + n_aux + 2);

  for (int i = 0; i < n_sites; ++i) {
    double d_alpha = D[(size_t)i * n_labels + alpha];
    double d_cur =
        labels[i] == alpha ? kInf : D[(size_t)i * n_labels + labels[i]];
    din.add_edge(S, i, d_alpha, 0.0);
    din.add_edge(i, T, d_cur, 0.0);
  }
  int aux = n_sites;
  for (int k = 0; k < n_edges; ++k) {
    int i = ei[k], j = ej[k];
    double w = ew[k];
    if (w <= 0) continue;
    if (labels[i] == labels[j]) {
      din.add_edge(i, j, w, w);
    } else {
      din.add_edge(i, aux, w, w);
      din.add_edge(aux, j, w, w);
      din.add_edge(aux, T, w, 0.0);
      ++aux;
    }
  }

  din.max_flow(S, T);
  std::vector<char> in_source;
  din.min_cut_side(S, in_source);
  for (int i = 0; i < n_sites; ++i)
    if (!in_source[i]) labels[i] = alpha;  // sink side switches to alpha
}

}  // namespace

extern "C" {

// Exact (alpha-expansion, guaranteed within the usual 2x Potts bound and
// exact for 2 labels) minimization of the Potts MRF.  ``labels_io`` holds
// the initial labeling on entry and the result on exit; returns the
// number of full sweeps run.  Edges must be UNIQUE undirected pairs.
int mmt_alpha_expansion(int n_sites, int n_labels, const float* D,
                        int n_edges, const int32_t* ei, const int32_t* ej,
                        const float* ew, int max_sweeps, int32_t* labels_io,
                        float* energy_out) {
  std::vector<int32_t> labels(labels_io, labels_io + n_sites);
  double best =
      total_energy(n_sites, n_labels, D, n_edges, ei, ej, ew, labels.data());
  int sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    bool improved = false;
    for (int alpha = 0; alpha < n_labels; ++alpha) {
      std::vector<int32_t> trial = labels;
      expand(alpha, n_sites, n_labels, D, n_edges, ei, ej, ew, trial);
      double e = total_energy(n_sites, n_labels, D, n_edges, ei, ej, ew,
                              trial.data());
      if (e < best - 1e-9) {
        best = e;
        labels = std::move(trial);
        improved = true;
      }
    }
    if (!improved) break;
  }
  std::memcpy(labels_io, labels.data(), sizeof(int32_t) * n_sites);
  if (energy_out) *energy_out = (float)best;
  return sweep;
}

// Plain min-cut entry for tests: binary labeling (0 = source side / keep,
// 1 = sink side) minimizing sum_i t-link costs + Potts edges.
// cost_keep[i] is paid when x_i = 0, cost_switch[i] when x_i = 1.
float mmt_binary_cut(int n_sites, const float* cost_keep,
                     const float* cost_switch, int n_edges, const int32_t* ei,
                     const int32_t* ej, const float* ew, int32_t* labels_out) {
  const int S = n_sites, T = n_sites + 1;
  Dinic din(n_sites + 2);
  for (int i = 0; i < n_sites; ++i) {
    din.add_edge(S, i, cost_switch[i], 0.0);
    din.add_edge(i, T, cost_keep[i], 0.0);
  }
  for (int k = 0; k < n_edges; ++k)
    din.add_edge(ei[k], ej[k], ew[k], ew[k]);
  double flow = din.max_flow(S, T);
  std::vector<char> in_source;
  din.min_cut_side(S, in_source);
  for (int i = 0; i < n_sites; ++i) labels_out[i] = in_source[i] ? 0 : 1;
  return (float)flow;
}

}  // extern "C"

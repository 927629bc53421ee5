// Hierarchical Navigable Small World graph index (host-side).
//
// The reference vendors hnswlib (reference: internal/engine/index/impl/
// hnswlib/gamma_index_hnswlib.cc:130). This is an independent
// implementation of the HNSW algorithm (Malkov & Yashunin, 2016) written
// for this framework's host runtime: the TPU serves dense scans for
// HBM-resident rows; the graph serves the beyond-HBM / low-latency-
// single-query regime where a pointer walk on the host beats shipping a
// batch to the device (index/hnsw.py picks the path).
//
// Design:
//   - flat storage: one contiguous f32 data block (grown by doubling) +
//     per-level neighbor arrays, M neighbors per node per level
//     (2M at level 0, as in the paper);
//   - insert: geometric level draw, greedy descent from the entry point,
//     searchLayer(efConstruction) per level, neighbor selection by the
//     paper's heuristic (closest-first with dominance pruning);
//   - search: greedy descent to level 1, searchLayer(ef) at level 0 with
//     an optional validity bitmap (soft-deleted/filtered docs are
//     excluded from results but still traversed, the standard filtered-
//     HNSW behavior);
//   - exposed through opaque integer handles (no PyTypeObject needed);
//     the python wrapper (vearch_tpu/native/__init__.py) owns handle
//     lifetime and locking (single writer; readers serialized by GIL).
//
// Metric: L2 or inner product. Scores returned similarity-oriented
// (higher = better): -distance^2 for L2, dot for IP.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct Hnsw {
  int dim = 0;
  int M = 16;
  int M0 = 32;           // level-0 degree (2*M)
  int ef_construction = 200;
  bool ip = false;       // false: L2, true: inner product
  double level_mult = 0; // 1/ln(M)
  std::mt19937_64 rng{0x5eed};

  int64_t n = 0;
  std::vector<float> data;              // [n, dim]
  std::vector<int32_t> levels;          // level per node
  // links[l] is a flat [n_at_or_above_l? no: n] * degree array; we keep
  // per-node vectors per level for simplicity of growth
  std::vector<std::vector<std::vector<int32_t>>> links;  // [node][level] -> neighbors
  int32_t entry = -1;
  int32_t max_level = -1;

  const float* vec(int64_t i) const { return data.data() + i * dim; }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (ip) {
      for (int j = 0; j < dim; j++) acc += a[j] * b[j];
      return -acc;  // smaller = better internally
    }
    for (int j = 0; j < dim; j++) {
      const float t = a[j] - b[j];
      acc += t * t;
    }
    return acc;
  }

  int draw_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng);
    if (r < 1e-12) r = 1e-12;
    return static_cast<int>(-std::log(r) * level_mult);
  }

  // search one layer from `ep`, keeping up to `ef` best candidates.
  // `valid` (nullable) filters which nodes may land in `best`; the
  // traversal frontier still crosses invalid nodes (standard filtered-
  // HNSW: dense deletes must not strand the walk, and k valid results
  // must survive — the index contract in index/base.py).
  // visited marker array is caller-provided (epoch trick).
  void search_layer(const float* q, int32_t ep_node, float ep_d, int level,
                    size_t ef, const uint8_t* valid,
                    std::vector<uint32_t>& visited, uint32_t epoch,
                    std::priority_queue<std::pair<float, int32_t>>& best)
      const {
    // best: max-heap on distance (worst on top), size <= ef
    using PD = std::pair<float, int32_t>;
    std::priority_queue<PD, std::vector<PD>, std::greater<PD>> cand;
    cand.emplace(ep_d, ep_node);
    if (!valid || valid[ep_node]) best.emplace(ep_d, ep_node);
    visited[ep_node] = epoch;
    while (!cand.empty()) {
      auto [cd, cn] = cand.top();
      if (best.size() >= ef && cd > best.top().first) break;
      cand.pop();
      for (int32_t nb : links[cn][level]) {
        if (visited[nb] == epoch) continue;
        visited[nb] = epoch;
        const float d = dist(q, vec(nb));
        if (best.size() < ef || d < best.top().first) {
          cand.emplace(d, nb);
          if (!valid || valid[nb]) {
            best.emplace(d, nb);
            if (best.size() > ef) best.pop();
          }
        }
      }
    }
  }

  // neighbor selection heuristic (paper alg. 4): pick up to m closest
  // candidates such that each kept candidate is closer to q than to any
  // already-kept one (dominance pruning keeps the graph navigable).
  void select_neighbors(const float* q,
                        std::vector<std::pair<float, int32_t>>& cand,
                        int m, std::vector<int32_t>& out) const {
    std::sort(cand.begin(), cand.end());
    out.clear();
    for (const auto& [d, node] : cand) {
      if (static_cast<int>(out.size()) >= m) break;
      bool dominated = false;
      for (int32_t kept : out) {
        if (dist(vec(node), vec(kept)) < d) {
          dominated = true;
          break;
        }
      }
      if (!dominated) out.push_back(node);
    }
    // backfill with closest dominated candidates if underfull (keeps
    // degree up in clustered data)
    if (static_cast<int>(out.size()) < m) {
      for (const auto& [d, node] : cand) {
        if (static_cast<int>(out.size()) >= m) break;
        if (std::find(out.begin(), out.end(), node) == out.end())
          out.push_back(node);
      }
    }
  }

  std::vector<uint32_t> visited_;
  uint32_t epoch_ = 0;

  void add_one(const float* q) {
    const int32_t id = static_cast<int32_t>(n);
    const int lvl = draw_level();
    levels.push_back(lvl);
    links.emplace_back(lvl + 1);
    data.insert(data.end(), q, q + dim);
    n++;
    visited_.resize(n, 0);

    if (entry < 0) {
      entry = id;
      max_level = lvl;
      return;
    }
    int32_t ep = entry;
    float ep_d = dist(q, vec(ep));
    // greedy descent through levels above lvl
    for (int l = max_level; l > lvl; l--) {
      bool improved = true;
      while (improved) {
        improved = false;
        for (int32_t nb : links[ep][l]) {
          const float d = dist(q, vec(nb));
          if (d < ep_d) {
            ep_d = d;
            ep = nb;
            improved = true;
          }
        }
      }
    }
    // connect at each level from min(lvl, max_level) down to 0
    for (int l = std::min(lvl, max_level); l >= 0; l--) {
      std::priority_queue<std::pair<float, int32_t>> best;
      if (++epoch_ == 0) {  // epoch wrap: clear markers
        std::fill(visited_.begin(), visited_.end(), 0u);
        epoch_ = 1;
      }
      search_layer(q, ep, ep_d, l, ef_construction, nullptr, visited_,
                   epoch_, best);
      std::vector<std::pair<float, int32_t>> cand;
      cand.reserve(best.size());
      while (!best.empty()) {
        cand.push_back(best.top());
        best.pop();
      }
      const int m = (l == 0) ? M0 : M;
      std::vector<int32_t> nbrs;
      select_neighbors(q, cand, m, nbrs);
      links[id][l] = nbrs;
      // backlinks + prune overfull neighbors
      for (int32_t nb : nbrs) {
        auto& nl = links[nb][l];
        nl.push_back(id);
        if (static_cast<int>(nl.size()) > m) {
          std::vector<std::pair<float, int32_t>> nc;
          nc.reserve(nl.size());
          for (int32_t x : nl) nc.emplace_back(dist(vec(nb), vec(x)), x);
          std::vector<int32_t> pruned;
          select_neighbors(vec(nb), nc, m, pruned);
          nl = pruned;
        }
      }
      if (!cand.empty()) {
        ep = cand.front().second;
        ep_d = cand.front().first;
      }
    }
    if (lvl > max_level) {
      max_level = lvl;
      entry = id;
    }
  }

  // k best valid nodes for one query; valid==nullptr means all valid
  void search(const float* q, int k, int ef, const uint8_t* valid,
              std::vector<std::pair<float, int32_t>>& out) {
    out.clear();
    if (entry < 0) return;
    int32_t ep = entry;
    float ep_d = dist(q, vec(ep));
    for (int l = max_level; l > 0; l--) {
      bool improved = true;
      while (improved) {
        improved = false;
        for (int32_t nb : links[ep][l]) {
          const float d = dist(q, vec(nb));
          if (d < ep_d) {
            ep_d = d;
            ep = nb;
            improved = true;
          }
        }
      }
    }
    std::priority_queue<std::pair<float, int32_t>> best;
    if (++epoch_ == 0) {
      std::fill(visited_.begin(), visited_.end(), 0u);
      epoch_ = 1;
    }
    const size_t ef_eff = static_cast<size_t>(std::max(ef, k));
    search_layer(q, ep, ep_d, 0, ef_eff, valid, visited_, epoch_, best);
    std::vector<std::pair<float, int32_t>> cand;
    cand.reserve(best.size());
    while (!best.empty()) {
      cand.push_back(best.top());
      best.pop();
    }
    std::sort(cand.begin(), cand.end());
    for (const auto& [d, node] : cand) {
      if (static_cast<int>(out.size()) >= k) break;
      out.emplace_back(d, node);
    }
  }
};

std::unordered_map<int64_t, Hnsw*> g_graphs;
int64_t g_next = 1;

Hnsw* get_graph(int64_t h) {
  auto it = g_graphs.find(h);
  if (it == g_graphs.end()) {
    PyErr_SetString(PyExc_ValueError, "invalid hnsw handle");
    return nullptr;
  }
  return it->second;
}

// hnsw_new(dim, M, ef_construction, ip: int, seed) -> handle
PyObject* py_hnsw_new(PyObject*, PyObject* args) {
  int dim, M, efc, ip;
  unsigned long long seed = 0x5eed;
  if (!PyArg_ParseTuple(args, "iiii|K", &dim, &M, &efc, &ip, &seed))
    return nullptr;
  auto* g = new Hnsw();
  g->dim = dim;
  g->M = std::max(2, M);
  g->M0 = 2 * g->M;
  g->ef_construction = std::max(efc, g->M0);
  g->ip = ip != 0;
  g->level_mult = 1.0 / std::log(static_cast<double>(g->M));
  g->rng.seed(seed);
  const int64_t h = g_next++;
  g_graphs[h] = g;
  return PyLong_FromLongLong(h);
}

PyObject* py_hnsw_free(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  auto it = g_graphs.find(h);
  if (it != g_graphs.end()) {
    delete it->second;
    g_graphs.erase(it);
  }
  Py_RETURN_NONE;
}

// hnsw_add(handle, rows: buffer f32[b*dim], b) -> first assigned id
PyObject* py_hnsw_add(PyObject*, PyObject* args) {
  long long h;
  Py_buffer buf;
  Py_ssize_t b;
  if (!PyArg_ParseTuple(args, "Ly*n", &h, &buf, &b)) return nullptr;
  Hnsw* g = get_graph(h);
  if (!g) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  if (buf.len < static_cast<Py_ssize_t>(b * g->dim * sizeof(float))) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "row buffer too small");
    return nullptr;
  }
  const float* rows = static_cast<const float*>(buf.buf);
  const int64_t first = g->n;
  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t i = 0; i < b; i++) g->add_one(rows + i * g->dim);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  return PyLong_FromLongLong(first);
}

// hnsw_search(handle, queries f32[B*dim], B, k, ef, valid u8[n]|None)
//   -> (bytes f32 scores[B*k], bytes i64 ids[B*k])  (-inf/-1 padding)
PyObject* py_hnsw_search(PyObject*, PyObject* args) {
  long long h;
  Py_buffer qbuf;
  Py_ssize_t B, k;
  int ef;
  PyObject* valid_obj = Py_None;
  if (!PyArg_ParseTuple(args, "Ly*nni|O", &h, &qbuf, &B, &k, &ef,
                        &valid_obj))
    return nullptr;
  Hnsw* g = get_graph(h);
  if (!g) {
    PyBuffer_Release(&qbuf);
    return nullptr;
  }
  if (qbuf.len < static_cast<Py_ssize_t>(B * g->dim * sizeof(float))) {
    PyBuffer_Release(&qbuf);
    PyErr_SetString(PyExc_ValueError, "query buffer too small for B*dim");
    return nullptr;
  }
  Py_buffer vbuf;
  const uint8_t* valid = nullptr;
  bool have_v = false;
  if (valid_obj != Py_None) {
    if (PyObject_GetBuffer(valid_obj, &vbuf, PyBUF_SIMPLE) != 0) {
      PyBuffer_Release(&qbuf);
      return nullptr;
    }
    if (vbuf.len < g->n) {
      PyBuffer_Release(&vbuf);
      PyBuffer_Release(&qbuf);
      PyErr_SetString(PyExc_ValueError, "valid mask shorter than n");
      return nullptr;
    }
    valid = static_cast<const uint8_t*>(vbuf.buf);
    have_v = true;
  }
  PyObject* out_s = PyBytes_FromStringAndSize(nullptr, B * k * sizeof(float));
  PyObject* out_i =
      PyBytes_FromStringAndSize(nullptr, B * k * sizeof(int64_t));
  if (!out_s || !out_i) {
    Py_XDECREF(out_s);
    Py_XDECREF(out_i);
    if (have_v) PyBuffer_Release(&vbuf);
    PyBuffer_Release(&qbuf);
    return nullptr;
  }
  auto* os = reinterpret_cast<float*>(PyBytes_AS_STRING(out_s));
  auto* oi = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(out_i));
  const float* qs = static_cast<const float*>(qbuf.buf);
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::pair<float, int32_t>> hits;
  for (Py_ssize_t qi = 0; qi < B; qi++) {
    g->search(qs + qi * g->dim, static_cast<int>(k), ef, valid, hits);
    Py_ssize_t j = 0;
    for (; j < static_cast<Py_ssize_t>(hits.size()) && j < k; j++) {
      // similarity-oriented: -L2^2; for IP internal dist is -dot, so
      // negation yields the dot either way
      os[qi * k + j] = -hits[j].first;
      oi[qi * k + j] = hits[j].second;
    }
    for (; j < k; j++) {
      os[qi * k + j] = -HUGE_VALF;
      oi[qi * k + j] = -1;
    }
  }
  Py_END_ALLOW_THREADS;
  if (have_v) PyBuffer_Release(&vbuf);
  PyBuffer_Release(&qbuf);
  return PyTuple_Pack(2, out_s, out_i);
}

// hnsw_save(handle, path) / hnsw_load(dim,M,efc,ip,path) -> handle
PyObject* py_hnsw_save(PyObject*, PyObject* args) {
  long long h;
  const char* path;
  if (!PyArg_ParseTuple(args, "Ls", &h, &path)) return nullptr;
  Hnsw* g = get_graph(h);
  if (!g) return nullptr;
  FILE* f = fopen(path, "wb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  const uint32_t magic = 0x48565354u;  // "TSVH"
  int64_t n = g->n;
  fwrite(&magic, 4, 1, f);
  fwrite(&g->dim, 4, 1, f);
  fwrite(&g->M, 4, 1, f);
  fwrite(&n, 8, 1, f);
  fwrite(&g->entry, 4, 1, f);
  fwrite(&g->max_level, 4, 1, f);
  fwrite(g->levels.data(), 4, static_cast<size_t>(n), f);
  fwrite(g->data.data(), 4, static_cast<size_t>(n) * g->dim, f);
  for (int64_t i = 0; i < n; i++) {
    for (int l = 0; l <= g->levels[i]; l++) {
      const auto& nl = g->links[i][l];
      const int32_t sz = static_cast<int32_t>(nl.size());
      fwrite(&sz, 4, 1, f);
      fwrite(nl.data(), 4, static_cast<size_t>(sz), f);
    }
  }
  fclose(f);
  Py_RETURN_NONE;
}

PyObject* py_hnsw_load(PyObject*, PyObject* args) {
  int dim, M, efc, ip;
  const char* path;
  if (!PyArg_ParseTuple(args, "iiiis", &dim, &M, &efc, &ip, &path))
    return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  uint32_t magic = 0;
  int fdim = 0, fM = 0;
  int64_t n = 0;
  auto fail = [&](const char* msg) -> PyObject* {
    fclose(f);
    PyErr_SetString(PyExc_ValueError, msg);
    return nullptr;
  };
  if (fread(&magic, 4, 1, f) != 1 || magic != 0x48565354u)
    return fail("bad hnsw file magic");
  if (fread(&fdim, 4, 1, f) != 1 || fdim != dim)
    return fail("hnsw file dimension mismatch");
  if (fread(&fM, 4, 1, f) != 1) return fail("truncated hnsw file");
  if (fread(&n, 8, 1, f) != 1 || n < 0) return fail("truncated hnsw file");
  auto* g = new Hnsw();
  g->dim = dim;
  g->M = std::max(2, fM);
  g->M0 = 2 * g->M;
  g->ef_construction = std::max(efc, g->M0);
  g->ip = ip != 0;
  g->level_mult = 1.0 / std::log(static_cast<double>(g->M));
  bool ok = fread(&g->entry, 4, 1, f) == 1 &&
            fread(&g->max_level, 4, 1, f) == 1;
  // every loaded field that later indexes an array is bounds-checked:
  // a bit-flipped snapshot must fail the load, not segfault a search
  ok = ok && n <= (int64_t{1} << 40) && g->entry >= -1 && g->entry < n &&
       g->max_level >= -1 && g->max_level < 64 &&
       (n == 0) == (g->entry < 0);
  if (ok) {
    g->n = n;
    g->levels.resize(n);
    g->data.resize(static_cast<size_t>(n) * dim);
    g->visited_.resize(n, 0);
    ok = fread(g->levels.data(), 4, static_cast<size_t>(n), f) ==
             static_cast<size_t>(n) &&
         fread(g->data.data(), 4, static_cast<size_t>(n) * dim, f) ==
             static_cast<size_t>(n) * dim;
    for (int64_t i = 0; ok && i < n; i++)
      ok = g->levels[i] >= 0 && g->levels[i] <= g->max_level;
    // the greedy descent starts at entry and indexes links[entry][l]
    // for every l up to max_level — entry must actually live there
    if (ok && n > 0) ok = g->levels[g->entry] == g->max_level;
  }
  if (ok) {
    g->links.resize(n);
    for (int64_t i = 0; ok && i < n; i++) {
      g->links[i].resize(g->levels[i] + 1);
      for (int l = 0; ok && l <= g->levels[i]; l++) {
        int32_t sz = 0;
        ok = fread(&sz, 4, 1, f) == 1 && sz >= 0 && sz <= 4 * g->M0;
        if (ok) {
          g->links[i][l].resize(sz);
          ok = fread(g->links[i][l].data(), 4, static_cast<size_t>(sz),
                     f) == static_cast<size_t>(sz);
          for (int32_t nb : g->links[i][l])
            ok = ok && nb >= 0 && nb < n && g->levels[nb] >= l;
        }
      }
    }
  }
  fclose(f);
  if (!ok) {
    delete g;
    PyErr_SetString(PyExc_ValueError, "truncated/corrupt hnsw file");
    return nullptr;
  }
  const int64_t h = g_next++;
  g_graphs[h] = g;
  return PyLong_FromLongLong(h);
}

PyObject* py_hnsw_count(PyObject*, PyObject* args) {
  long long h;
  if (!PyArg_ParseTuple(args, "L", &h)) return nullptr;
  Hnsw* g = get_graph(h);
  if (!g) return nullptr;
  return PyLong_FromLongLong(g->n);
}

PyMethodDef methods[] = {
    {"hnsw_new", py_hnsw_new, METH_VARARGS, "Create a graph -> handle"},
    {"hnsw_free", py_hnsw_free, METH_VARARGS, "Destroy a graph"},
    {"hnsw_add", py_hnsw_add, METH_VARARGS, "Append rows -> first id"},
    {"hnsw_search", py_hnsw_search, METH_VARARGS,
     "Filtered k-NN search -> (scores bytes, ids bytes)"},
    {"hnsw_save", py_hnsw_save, METH_VARARGS, "Serialize graph to file"},
    {"hnsw_load", py_hnsw_load, METH_VARARGS, "Load graph from file"},
    {"hnsw_count", py_hnsw_count, METH_VARARGS, "Node count"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "vearch_hnsw",
    "HNSW graph index (host-side) for vearch-tpu", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_vearch_hnsw(void) { return PyModule_Create(&module); }

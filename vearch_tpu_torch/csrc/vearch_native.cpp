// Native host-side hot loops for vearch-tpu.
//
// The reference implements its entire engine in C++ (internal/engine/);
// in the TPU-native re-design the dense math lives on the accelerator and
// the *host* hot loops move here instead:
//   - murmur3_batch: bulk doc-key -> slot hashing for the router's
//     PartitionDocs path (reference: client/client.go:245 murmur3.Sum32)
//   - merge_topk: the router's cross-partition top-k merge
//     (reference: client/client.go:779 sorted merge)
//   - read_fvecs / write_fvecs: .fvecs/.ivecs dataset IO
//     (reference: test/utils/data_utils.py readers, engine tools/)
//
// Built as a plain CPython extension (no pybind11 in this image); the
// python wrapper (vearch_tpu/native/__init__.py) compiles it on demand
// with g++ and falls back to numpy implementations when unavailable.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  const uint32_t c1 = 0xcc9e2d51u, c2 = 0x1b873593u;
  uint32_t h = seed;
  const size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, data + i * 4, 4);
    k *= c1;
    k = (k << 15) | (k >> 17);
    k *= c2;
    h ^= k;
    h = (h << 13) | (h >> 19);
    h = h * 5 + 0xe6546b64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (len & 3) {
    case 3:
      k ^= static_cast<uint32_t>(tail[2]) << 16;
      [[fallthrough]];
    case 2:
      k ^= static_cast<uint32_t>(tail[1]) << 8;
      [[fallthrough]];
    case 1:
      k ^= tail[0];
      k *= c1;
      k = (k << 15) | (k >> 17);
      k *= c2;
      h ^= k;
  }
  h ^= static_cast<uint32_t>(len);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// murmur3_batch(keys: list[bytes|str], seed=0) -> bytes (u32 LE array)
PyObject* py_murmur3_batch(PyObject*, PyObject* args) {
  PyObject* keys;
  unsigned int seed = 0;
  if (!PyArg_ParseTuple(args, "O|I", &keys, &seed)) return nullptr;
  PyObject* seq = PySequence_Fast(keys, "keys must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * 4);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  auto* dst =
      reinterpret_cast<uint32_t*>(PyBytes_AS_STRING(out));
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    const char* buf;
    Py_ssize_t len;
    PyObject* tmp = nullptr;
    if (PyUnicode_Check(item)) {
      buf = PyUnicode_AsUTF8AndSize(item, &len);
      if (!buf) {
        Py_DECREF(seq);
        Py_DECREF(out);
        return nullptr;
      }
    } else if (PyBytes_Check(item)) {
      buf = PyBytes_AS_STRING(item);
      len = PyBytes_GET_SIZE(item);
    } else {
      tmp = PyObject_Str(item);
      if (!tmp) {
        Py_DECREF(seq);
        Py_DECREF(out);
        return nullptr;
      }
      buf = PyUnicode_AsUTF8AndSize(tmp, &len);
      if (!buf) {
        Py_XDECREF(tmp);
        Py_DECREF(seq);
        Py_DECREF(out);
        return nullptr;
      }
    }
    dst[i] = murmur3_32(reinterpret_cast<const uint8_t*>(buf),
                        static_cast<size_t>(len), seed);
    Py_XDECREF(tmp);
  }
  Py_DECREF(seq);
  return out;
}

// merge_topk(scores: bytes f32[B*M], ids: bytes i64[B*M], B, M, k,
//            descending) -> (bytes f32[B*k], bytes i64[B*k])
PyObject* py_merge_topk(PyObject*, PyObject* args) {
  Py_buffer scores_buf, ids_buf;
  Py_ssize_t b, m, k;
  int descending = 1;
  if (!PyArg_ParseTuple(args, "y*y*nnn|p", &scores_buf, &ids_buf, &b, &m,
                        &k, &descending))
    return nullptr;
  if (scores_buf.len < static_cast<Py_ssize_t>(b * m * sizeof(float)) ||
      ids_buf.len < static_cast<Py_ssize_t>(b * m * sizeof(int64_t))) {
    PyBuffer_Release(&scores_buf);
    PyBuffer_Release(&ids_buf);
    PyErr_SetString(PyExc_ValueError, "buffer too small for B*M");
    return nullptr;
  }
  if (k > m) k = m;
  const float* scores = static_cast<const float*>(scores_buf.buf);
  const int64_t* ids = static_cast<const int64_t*>(ids_buf.buf);
  PyObject* out_s = PyBytes_FromStringAndSize(nullptr, b * k * sizeof(float));
  PyObject* out_i =
      PyBytes_FromStringAndSize(nullptr, b * k * sizeof(int64_t));
  if (!out_s || !out_i) {
    Py_XDECREF(out_s);
    Py_XDECREF(out_i);
    PyBuffer_Release(&scores_buf);
    PyBuffer_Release(&ids_buf);
    return nullptr;
  }
  auto* os = reinterpret_cast<float*>(PyBytes_AS_STRING(out_s));
  auto* oi = reinterpret_cast<int64_t*>(PyBytes_AS_STRING(out_i));
  std::vector<int32_t> idx(m);
  Py_BEGIN_ALLOW_THREADS;
  for (Py_ssize_t row = 0; row < b; row++) {
    const float* s = scores + row * m;
    const int64_t* id = ids + row * m;
    for (Py_ssize_t j = 0; j < m; j++) idx[j] = static_cast<int32_t>(j);
    auto cmp = [&](int32_t a, int32_t c) {
      return descending ? s[a] > s[c] : s[a] < s[c];
    };
    std::partial_sort(idx.begin(), idx.begin() + k, idx.end(), cmp);
    for (Py_ssize_t j = 0; j < k; j++) {
      os[row * k + j] = s[idx[j]];
      oi[row * k + j] = id[idx[j]];
    }
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&scores_buf);
  PyBuffer_Release(&ids_buf);
  return PyTuple_Pack(2, out_s, out_i);
}

// read_fvecs(path, max_n=-1) -> (bytes f32 data, n, d); .ivecs identical
// layout with i32 payload (caller reinterprets).
PyObject* py_read_fvecs(PyObject*, PyObject* args) {
  const char* path;
  Py_ssize_t max_n = -1;
  if (!PyArg_ParseTuple(args, "s|n", &path, &max_n)) return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  int32_t d = 0;
  if (fread(&d, 4, 1, f) != 1 || d <= 0 || d > (1 << 20)) {
    fclose(f);
    PyErr_SetString(PyExc_ValueError, "bad fvecs header");
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  long row_bytes = 4L + 4L * d;
  long n = size / row_bytes;
  if (max_n >= 0 && n > max_n) n = max_n;
  fseek(f, 0, SEEK_SET);
  PyObject* out = PyBytes_FromStringAndSize(nullptr, n * 4L * d);
  if (!out) {
    fclose(f);
    return nullptr;
  }
  char* dst = PyBytes_AS_STRING(out);
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS;
  for (long i = 0; i < n; i++) {
    int32_t dim;
    if (fread(&dim, 4, 1, f) != 1 || dim != d ||
        fread(dst + i * 4L * d, 4, static_cast<size_t>(d), f) !=
            static_cast<size_t>(d)) {
      ok = false;
      break;
    }
  }
  Py_END_ALLOW_THREADS;
  fclose(f);
  if (!ok) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_ValueError, "truncated/inconsistent fvecs file");
    return nullptr;
  }
  return Py_BuildValue("(Nnn)", out, static_cast<Py_ssize_t>(n),
                       static_cast<Py_ssize_t>(d));
}

PyMethodDef methods[] = {
    {"murmur3_batch", py_murmur3_batch, METH_VARARGS,
     "Batch murmur3-32 of a sequence of keys -> u32 LE bytes"},
    {"merge_topk", py_merge_topk, METH_VARARGS,
     "Per-row partial-sort top-k merge over concatenated candidates"},
    {"read_fvecs", py_read_fvecs, METH_VARARGS,
     "Read an .fvecs/.ivecs file -> (bytes, n, d)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "vearch_native",
    "Native host hot loops for vearch-tpu", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_vearch_native(void) { return PyModule_Create(&module); }

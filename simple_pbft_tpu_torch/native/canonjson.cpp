// Native canonical-JSON encoder (CPython extension).
//
// Canonical encoding (sorted keys, no whitespace, ensure_ascii) is the
// wire format AND the digest/signing preimage of every consensus message
// (simple_pbft_tpu/messages.py:canonical_json), so the committee-wide
// CPU profile is dominated by message volume x codec cost — measured
// ~20% of committee CPU in json.dumps/json.loads at n=100
// (bench_results/cpu_budget_r04.md). This module encodes the exact wire
// subset {dict[str->*], list, str, int, bool, None} byte-identically to
//
//     json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()
//
// and raises TypeError for anything outside the subset (floats, exotic
// key types), which the Python wrapper treats as "fall back to json" —
// a digest divergence between the two encoders would fork the
// committee, so equivalence is enforced by differential fuzz tests
// (tests/test_native_canonjson.py) covering control characters, astral
// planes, lone surrogates, and big ints.
//
// Key ordering uses PyList_Sort on the key list — exactly sorted()'s
// comparison — rather than a reimplementation of str ordering.
//
// The reference has no codec layer at all (its wire format is Go's
// encoding/json over HTTP, reference pbft/network/
// consensusInterface.go:47-107); this is new framework infrastructure.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string>

namespace {

constexpr int kMaxDepth = 64;  // mirrors messages.MAX_NESTING with margin

const char kHex[] = "0123456789abcdef";

void append_escaped(std::string &out, PyObject *str) {
  // str is guaranteed PyUnicode by the caller (may be unready only for
  // exotic subclasses; PyUnicode_READY is a no-op post-3.12 but cheap)
  Py_ssize_t n = PyUnicode_GET_LENGTH(str);
  int kind = PyUnicode_KIND(str);
  const void *data = PyUnicode_DATA(str);
  out.push_back('"');
  for (Py_ssize_t i = 0; i < n; i++) {
    Py_UCS4 c = PyUnicode_READ(kind, data, i);
    switch (c) {
      case '"':
        out += "\\\"";
        continue;
      case '\\':
        out += "\\\\";
        continue;
      case '\b':
        out += "\\b";
        continue;
      case '\f':
        out += "\\f";
        continue;
      case '\n':
        out += "\\n";
        continue;
      case '\r':
        out += "\\r";
        continue;
      case '\t':
        out += "\\t";
        continue;
      default:
        break;
    }
    if (c >= 0x20 && c < 0x7f) {
      out.push_back(static_cast<char>(c));
    } else if (c <= 0xffff) {
      // includes lone surrogates, exactly as the json module emits them
      out += "\\u";
      out.push_back(kHex[(c >> 12) & 0xf]);
      out.push_back(kHex[(c >> 8) & 0xf]);
      out.push_back(kHex[(c >> 4) & 0xf]);
      out.push_back(kHex[c & 0xf]);
    } else {
      Py_UCS4 v = c - 0x10000;
      Py_UCS4 hi = 0xd800 + (v >> 10);
      Py_UCS4 lo = 0xdc00 + (v & 0x3ff);
      out += "\\u";
      out.push_back(kHex[(hi >> 12) & 0xf]);
      out.push_back(kHex[(hi >> 8) & 0xf]);
      out.push_back(kHex[(hi >> 4) & 0xf]);
      out.push_back(kHex[hi & 0xf]);
      out += "\\u";
      out.push_back(kHex[(lo >> 12) & 0xf]);
      out.push_back(kHex[(lo >> 8) & 0xf]);
      out.push_back(kHex[(lo >> 4) & 0xf]);
      out.push_back(kHex[lo & 0xf]);
    }
  }
  out.push_back('"');
}

// returns false with a Python exception set (TypeError for out-of-subset
// input -> wrapper falls back; RecursionError/MemoryError otherwise)
bool encode(std::string &out, PyObject *obj, int depth) {
  if (depth > kMaxDepth) {
    PyErr_SetString(PyExc_RecursionError, "canonical json too deep");
    return false;
  }
  if (obj == Py_None) {
    out += "null";
    return true;
  }
  if (obj == Py_True) {
    out += "true";
    return true;
  }
  if (obj == Py_False) {
    out += "false";
    return true;
  }
  if (PyUnicode_Check(obj)) {
    append_escaped(out, obj);
    return true;
  }
  if (PyLong_Check(obj)) {
    // exact-int fast path; big ints go through Python's own str()
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
    if (!overflow && !(v == -1 && PyErr_Occurred())) {
      out += std::to_string(v);
      return true;
    }
    PyErr_Clear();
    // json.dumps formats ints via int.__repr__ REGARDLESS of subclass
    // overrides — going through PyObject_Str here would let an int
    // subclass with a custom __str__ change the encoding (a digest fork
    // and possibly invalid JSON); call the base type's repr slot
    PyObject *s = PyLong_Type.tp_repr(obj);
    if (s == nullptr) return false;
    Py_ssize_t sz = 0;
    const char *buf = PyUnicode_AsUTF8AndSize(s, &sz);
    if (buf == nullptr) {
      Py_DECREF(s);
      return false;
    }
    out.append(buf, static_cast<size_t>(sz));
    Py_DECREF(s);
    return true;
  }
  if (PyList_Check(obj)) {
    out.push_back('[');
    Py_ssize_t n = PyList_GET_SIZE(obj);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (i) out.push_back(',');
      // borrow is safe: no Python code runs between READ and use
      if (!encode(out, PyList_GET_ITEM(obj, i), depth + 1)) return false;
    }
    out.push_back(']');
    return true;
  }
  if (PyTuple_Check(obj)) {
    // json encodes tuples as arrays; our wire never produces them but a
    // caller-side structure might
    out.push_back('[');
    Py_ssize_t n = PyTuple_GET_SIZE(obj);
    for (Py_ssize_t i = 0; i < n; i++) {
      if (i) out.push_back(',');
      if (!encode(out, PyTuple_GET_ITEM(obj, i), depth + 1)) return false;
    }
    out.push_back(']');
    return true;
  }
  if (PyDict_Check(obj)) {
    PyObject *keys = PyDict_Keys(obj);
    if (keys == nullptr) return false;
    // exact sorted() semantics — mixed/non-str keys fail the sort or the
    // per-key check below and fall back
    if (PyList_Sort(keys) < 0) {
      Py_DECREF(keys);
      PyErr_Clear();
      PyErr_SetString(PyExc_TypeError, "unsortable dict keys");
      return false;
    }
    out.push_back('{');
    Py_ssize_t n = PyList_GET_SIZE(keys);
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject *k = PyList_GET_ITEM(keys, i);
      if (!PyUnicode_Check(k)) {
        Py_DECREF(keys);
        PyErr_SetString(PyExc_TypeError, "non-str dict key");
        return false;
      }
      if (i) out.push_back(',');
      append_escaped(out, k);
      out.push_back(':');
      PyObject *v = PyDict_GetItemWithError(obj, k);  // borrowed
      if (v == nullptr) {
        Py_DECREF(keys);
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_RuntimeError, "dict mutated during encode");
        return false;
      }
      if (!encode(out, v, depth + 1)) {
        Py_DECREF(keys);
        return false;
      }
    }
    Py_DECREF(keys);
    out.push_back('}');
    return true;
  }
  PyErr_Format(PyExc_TypeError, "unsupported type for canonical json: %s",
               Py_TYPE(obj)->tp_name);
  return false;
}

PyObject *py_encode(PyObject *, PyObject *obj) {
  std::string out;
  out.reserve(256);
  if (!encode(out, obj, 0)) return nullptr;
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyMethodDef kMethods[] = {
    {"encode", py_encode, METH_O,
     "encode(obj) -> bytes identical to json.dumps(obj, sort_keys=True, "
     "separators=(',', ':')).encode() for the wire subset; raises "
     "TypeError outside it."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_canonjson",
    "Native canonical-JSON encoder for consensus wire messages.", -1,
    kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__canonjson(void) { return PyModule_Create(&kModule); }

/* Native hot-path kernels for the corrosion_tpu_torch host runtime.
 *
 * A copy of corrosion_tpu/native/_corrosion_native.cc.  The reference
 * implements its entire runtime in Rust; the device path here is
 * PyTorch and CUDA, and this extension is the native runtime layer
 * around it for the host agent's hottest per-row / per-message work:
 *
 *   - pack_values / unpack_values: the packed-pk codec invoked by the
 *     CRR triggers (corro_pack UDF) on EVERY row write and by change
 *     collection / subscription bookkeeping
 *     (reference: crates/corro-types/src/pubsub.rs:2302-2449);
 *   - value_cmp: cr-sqlite's merge tie-break total order (type-enum
 *     rank first, then within-type comparison);
 *   - deframe: the u32-BE LengthDelimited splitter on the gossip/sync
 *     wire (tokio_util's codec in the reference);
 *   - speedy_encode_changes / speedy_decode_changes: the change-array
 *     loops of the speedy wire codec.
 *
 * Semantics are pinned to the pure-Python twins in agent/pack.py and
 * bridge/speedy.py; tests/test_torch_native.py cross-checks them on
 * random inputs.  Python remains the fallback when no compiler is
 * available.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>

namespace {

constexpr uint8_t T_NULL = 0;
constexpr uint8_t T_INT = 1;
constexpr uint8_t T_REAL = 2;
constexpr uint8_t T_TEXT = 3;
constexpr uint8_t T_BLOB = 4;

void put_u32(std::string &out, uint32_t v) {
  char b[4] = {static_cast<char>(v >> 24), static_cast<char>(v >> 16),
               static_cast<char>(v >> 8), static_cast<char>(v)};
  out.append(b, 4);
}

void put_u64(std::string &out, uint64_t v) {
  char b[8];
  for (int i = 0; i < 8; i++) b[i] = static_cast<char>(v >> (56 - 8 * i));
  out.append(b, 8);
}

uint32_t get_u32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint64_t get_u64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

/* -- pack_values ----------------------------------------------------- */

PyObject *pack_values(PyObject *, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "pack_values expects a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::string out;
  out.reserve(16 * static_cast<size_t>(n) + 8);
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *v = PySequence_Fast_GET_ITEM(seq, i);
    if (v == Py_None) {
      out.push_back(static_cast<char>(T_NULL));
    } else if (PyBool_Check(v)) {
      out.push_back(static_cast<char>(T_INT));
      put_u64(out, v == Py_True ? 1 : 0);
    } else if (PyLong_Check(v)) {
      int overflow = 0;
      long long ll = PyLong_AsLongLongAndOverflow(v, &overflow);
      if (overflow != 0 || (ll == -1 && PyErr_Occurred())) {
        if (!PyErr_Occurred())
          PyErr_SetString(PyExc_OverflowError,
                          "int too large for packed i64");
        Py_DECREF(seq);
        return nullptr;
      }
      out.push_back(static_cast<char>(T_INT));
      put_u64(out, static_cast<uint64_t>(ll));
    } else if (PyFloat_Check(v)) {
      double d = PyFloat_AS_DOUBLE(v);
      uint64_t bits;
      std::memcpy(&bits, &d, 8);
      out.push_back(static_cast<char>(T_REAL));
      put_u64(out, bits);
    } else if (PyUnicode_Check(v)) {
      Py_ssize_t len = 0;
      const char *s = PyUnicode_AsUTF8AndSize(v, &len);
      if (!s) {
        Py_DECREF(seq);
        return nullptr;
      }
      out.push_back(static_cast<char>(T_TEXT));
      put_u32(out, static_cast<uint32_t>(len));
      out.append(s, static_cast<size_t>(len));
    } else if (PyBytes_Check(v) || PyByteArray_Check(v) ||
               PyMemoryView_Check(v)) {
      /* exactly the types the Python twin accepts — a generic buffer
       * check would silently pack array/numpy/mmap objects that the
       * fallback rejects with TypeError */
      Py_buffer buf;
      if (PyObject_GetBuffer(v, &buf, PyBUF_SIMPLE) != 0) {
        Py_DECREF(seq);
        return nullptr;
      }
      out.push_back(static_cast<char>(T_BLOB));
      put_u32(out, static_cast<uint32_t>(buf.len));
      out.append(static_cast<const char *>(buf.buf),
                 static_cast<size_t>(buf.len));
      PyBuffer_Release(&buf);
    } else {
      PyErr_Format(PyExc_TypeError, "unsupported SQL value: %R",
                   reinterpret_cast<PyObject *>(Py_TYPE(v)));
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

/* -- unpack_values --------------------------------------------------- */

PyObject *unpack_values(PyObject *, PyObject *arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  const uint8_t *p = static_cast<const uint8_t *>(buf.buf);
  Py_ssize_t n = buf.len;
  PyObject *out = PyList_New(0);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t i = 0;
  while (i < n) {
    uint8_t tag = p[i];
    i += 1;
    PyObject *item = nullptr;
    if (tag == T_NULL) {
      item = Py_NewRef(Py_None);
    } else if (tag == T_INT || tag == T_REAL) {
      if (i + 8 > n) {
        PyErr_SetString(PyExc_ValueError, "truncated packed value");
        goto fail;
      }
      uint64_t bits = get_u64(p + i);
      i += 8;
      if (tag == T_INT) {
        item = PyLong_FromLongLong(static_cast<long long>(bits));
      } else {
        double d;
        std::memcpy(&d, &bits, 8);
        item = PyFloat_FromDouble(d);
      }
    } else if (tag == T_TEXT || tag == T_BLOB) {
      if (i + 4 > n) {
        PyErr_SetString(PyExc_ValueError, "truncated packed value");
        goto fail;
      }
      uint32_t len = get_u32(p + i);
      i += 4;
      if (i + static_cast<Py_ssize_t>(len) > n) {
        PyErr_SetString(PyExc_ValueError, "truncated packed value");
        goto fail;
      }
      const char *s = reinterpret_cast<const char *>(p + i);
      item = (tag == T_TEXT)
                 ? PyUnicode_DecodeUTF8(s, len, nullptr)
                 : PyBytes_FromStringAndSize(s, len);
      i += len;
    } else {
      PyErr_Format(PyExc_ValueError, "bad tag %d at offset %zd", tag, i - 1);
      goto fail;
    }
    if (!item || PyList_Append(out, item) != 0) {
      Py_XDECREF(item);
      goto fail;
    }
    Py_DECREF(item);
  }
  PyBuffer_Release(&buf);
  return out;
fail:
  PyBuffer_Release(&buf);
  Py_DECREF(out);
  return nullptr;
}

/* -- value_cmp ------------------------------------------------------- */

int type_rank(PyObject *v) {
  if (v == Py_None) return 0;
  if (PyBool_Check(v) || PyLong_Check(v)) return 4;
  if (PyFloat_Check(v)) return 3;
  if (PyUnicode_Check(v)) return 2;
  if (PyBytes_Check(v) || PyByteArray_Check(v) || PyMemoryView_Check(v))
    return 1;
  return -1;
}

PyObject *value_cmp(PyObject *, PyObject *args) {
  PyObject *a, *b;
  if (!PyArg_ParseTuple(args, "OO", &a, &b)) return nullptr;
  int ra = type_rank(a), rb = type_rank(b);
  if (ra < 0 || rb < 0) {
    PyErr_Format(PyExc_TypeError, "unsupported SQL value: %R",
                 reinterpret_cast<PyObject *>(Py_TYPE(ra < 0 ? a : b)));
    return nullptr;
  }
  if (ra != rb) return PyLong_FromLong(ra < rb ? -1 : 1);
  if (ra == 0) return PyLong_FromLong(0);
  if (ra == 2) {
    /* compare UTF-8 bytes, like the Python twin */
    Py_ssize_t la = 0, lb = 0;
    const char *sa = PyUnicode_AsUTF8AndSize(a, &la);
    const char *sb = PyUnicode_AsUTF8AndSize(b, &lb);
    if (!sa || !sb) return nullptr;
    int c = std::memcmp(sa, sb, static_cast<size_t>(la < lb ? la : lb));
    if (c == 0) c = (la > lb) - (la < lb);
    return PyLong_FromLong(c > 0 ? 1 : (c < 0 ? -1 : 0));
  }
  if (ra == 1) {
    Py_buffer ba, bb;
    if (PyObject_GetBuffer(a, &ba, PyBUF_SIMPLE) != 0) return nullptr;
    if (PyObject_GetBuffer(b, &bb, PyBUF_SIMPLE) != 0) {
      PyBuffer_Release(&ba);
      return nullptr;
    }
    int c = std::memcmp(ba.buf, bb.buf,
                        static_cast<size_t>(ba.len < bb.len ? ba.len : bb.len));
    if (c == 0) c = (ba.len > bb.len) - (ba.len < bb.len);
    PyBuffer_Release(&ba);
    PyBuffer_Release(&bb);
    return PyLong_FromLong(c > 0 ? 1 : (c < 0 ? -1 : 0));
  }
  /* numerics: defer to Python comparison (bigints, NaN semantics) */
  int lt = PyObject_RichCompareBool(a, b, Py_LT);
  if (lt < 0) return nullptr;
  int gt = PyObject_RichCompareBool(a, b, Py_GT);
  if (gt < 0) return nullptr;
  return PyLong_FromLong(gt - lt);
}

/* -- deframe --------------------------------------------------------- */

PyObject *deframe(PyObject *, PyObject *args) {
  Py_buffer buf;
  unsigned int max_len = 8 * 1024 * 1024;
  if (!PyArg_ParseTuple(args, "y*|I", &buf, &max_len)) return nullptr;
  const uint8_t *p = static_cast<const uint8_t *>(buf.buf);
  Py_ssize_t n = buf.len;
  PyObject *frames = PyList_New(0);
  if (!frames) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t pos = 0;
  while (pos + 4 <= n) {
    uint32_t len = get_u32(p + pos);
    if (len > max_len) {
      PyErr_Format(PyExc_ValueError, "frame length %u exceeds max %u", len,
                   max_len);
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    if (pos + 4 + static_cast<Py_ssize_t>(len) > n) break;
    PyObject *payload = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(p + pos + 4), len);
    if (!payload || PyList_Append(frames, payload) != 0) {
      Py_XDECREF(payload);
      Py_DECREF(frames);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    Py_DECREF(payload);
    pos += 4 + len;
  }
  PyObject *rest = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(p + pos), n - pos);
  PyBuffer_Release(&buf);
  if (!rest) {
    Py_DECREF(frames);
    return nullptr;
  }
  PyObject *out = PyTuple_Pack(2, frames, rest);
  Py_DECREF(frames);
  Py_DECREF(rest);
  return out;
}

/* -- speedy change-array codec ---------------------------------------
 *
 * The live gossip/sync wire serializes Vec<Change> with the Rust
 * `speedy` layout (little-endian; bridge/speedy.py documents the full
 * format).  The change array is the bulk of every broadcast frame and
 * sync chunk, so the per-row field packing runs here; the Python twin
 * (_w_change/_r_change) stays the fallback and the semantic reference.
 */

void put_u32le(std::string &out, uint32_t v) {
  char b[4] = {static_cast<char>(v), static_cast<char>(v >> 8),
               static_cast<char>(v >> 16), static_cast<char>(v >> 24)};
  out.append(b, 4);
}

void put_u64le(std::string &out, uint64_t v) {
  char b[8];
  for (int i = 0; i < 8; i++) b[i] = static_cast<char>(v >> (8 * i));
  out.append(b, 8);
}

uint32_t get_u32le(const uint8_t *p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

uint64_t get_u64le(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}

bool put_lp_str(std::string &out, PyObject *v, const char *field) {
  if (!PyUnicode_Check(v)) {
    PyErr_Format(PyExc_TypeError, "%s must be str, not %R", field,
                 reinterpret_cast<PyObject *>(Py_TYPE(v)));
    return false;
  }
  Py_ssize_t len = 0;
  const char *s = PyUnicode_AsUTF8AndSize(v, &len);
  if (!s) return false;
  put_u32le(out, static_cast<uint32_t>(len));
  out.append(s, static_cast<size_t>(len));
  return true;
}

bool put_i64_attr(std::string &out, PyObject *obj, PyObject *name) {
  PyObject *v = PyObject_GetAttr(obj, name);
  if (!v) return false;
  long long ll = PyLong_AsLongLong(v);
  Py_DECREF(v);
  if (ll == -1 && PyErr_Occurred()) return false;
  put_u64le(out, static_cast<uint64_t>(ll));
  return true;
}

bool put_u64_attr(std::string &out, PyObject *obj, PyObject *name) {
  /* db_version/seq span the full u64 domain (Python twin uses '<Q') */
  PyObject *v = PyObject_GetAttr(obj, name);
  if (!v) return false;
  unsigned long long u = PyLong_AsUnsignedLongLong(v);
  Py_DECREF(v);
  if (u == static_cast<unsigned long long>(-1) && PyErr_Occurred())
    return false;
  put_u64le(out, static_cast<uint64_t>(u));
  return true;
}

bool put_lp_buffer(std::string &out, PyObject *v, const char *field) {
  /* bytes/bytearray/memoryview, matching the Python twin's accepts */
  if (!PyBytes_Check(v) && !PyByteArray_Check(v) && !PyMemoryView_Check(v)) {
    PyErr_Format(PyExc_TypeError, "%s must be bytes-like, not %R", field,
                 reinterpret_cast<PyObject *>(Py_TYPE(v)));
    return false;
  }
  Py_buffer buf;
  if (PyObject_GetBuffer(v, &buf, PyBUF_SIMPLE) != 0) return false;
  put_u32le(out, static_cast<uint32_t>(buf.len));
  out.append(static_cast<const char *>(buf.buf),
             static_cast<size_t>(buf.len));
  PyBuffer_Release(&buf);
  return true;
}

struct ChangeAttrs {
  PyObject *table, *pk, *cid, *val, *col_version, *db_version, *seq,
      *site_id, *cl;
  bool init() {
    table = PyUnicode_InternFromString("table");
    pk = PyUnicode_InternFromString("pk");
    cid = PyUnicode_InternFromString("cid");
    val = PyUnicode_InternFromString("val");
    col_version = PyUnicode_InternFromString("col_version");
    db_version = PyUnicode_InternFromString("db_version");
    seq = PyUnicode_InternFromString("seq");
    site_id = PyUnicode_InternFromString("site_id");
    cl = PyUnicode_InternFromString("cl");
    return table && pk && cid && val && col_version && db_version && seq &&
           site_id && cl;
  }
};

ChangeAttrs g_attrs;

PyObject *speedy_encode_changes(PyObject *, PyObject *arg) {
  PyObject *seq = PySequence_Fast(arg, "expects a sequence of Change");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::string out;
  out.reserve(96 * static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject *c = PySequence_Fast_GET_ITEM(seq, i);
    PyObject *table = PyObject_GetAttr(c, g_attrs.table);
    PyObject *pk = table ? PyObject_GetAttr(c, g_attrs.pk) : nullptr;
    PyObject *cid = pk ? PyObject_GetAttr(c, g_attrs.cid) : nullptr;
    PyObject *val = cid ? PyObject_GetAttr(c, g_attrs.val) : nullptr;
    PyObject *site = val ? PyObject_GetAttr(c, g_attrs.site_id) : nullptr;
    bool ok = site != nullptr;
    if (ok) ok = put_lp_str(out, table, "table");
    if (ok) ok = put_lp_buffer(out, pk, "pk");
    if (ok) ok = put_lp_str(out, cid, "cid");
    if (ok) {
      /* SqliteValue: u8 tag then the value (bridge/speedy.py _w_value) */
      if (val == Py_None) {
        out.push_back(0);
      } else if (PyBool_Check(val)) {
        out.push_back(1);
        put_u64le(out, val == Py_True ? 1 : 0);
      } else if (PyLong_Check(val)) {
        long long ll = PyLong_AsLongLong(val);
        if (ll == -1 && PyErr_Occurred()) {
          ok = false;
        } else {
          out.push_back(1);
          put_u64le(out, static_cast<uint64_t>(ll));
        }
      } else if (PyFloat_Check(val)) {
        double d = PyFloat_AS_DOUBLE(val);
        uint64_t bits;
        std::memcpy(&bits, &d, 8);
        out.push_back(2);
        put_u64le(out, bits);
      } else if (PyUnicode_Check(val)) {
        out.push_back(3);
        ok = put_lp_str(out, val, "val");
        if (!ok) out.pop_back();
      } else if (PyBytes_Check(val) || PyByteArray_Check(val) ||
                 PyMemoryView_Check(val)) {
        out.push_back(4);
        ok = put_lp_buffer(out, val, "val");
        if (!ok) out.pop_back();
      } else {
        PyErr_Format(PyExc_TypeError, "unsupported SqliteValue: %R",
                     reinterpret_cast<PyObject *>(Py_TYPE(val)));
        ok = false;
      }
    }
    if (ok) ok = put_i64_attr(out, c, g_attrs.col_version);
    if (ok) ok = put_u64_attr(out, c, g_attrs.db_version);
    if (ok) ok = put_u64_attr(out, c, g_attrs.seq);
    if (ok) {
      if (!PyBytes_Check(site) || PyBytes_GET_SIZE(site) != 16) {
        PyErr_SetString(PyExc_ValueError, "site_id must be 16 bytes");
        ok = false;
      } else {
        out.append(PyBytes_AS_STRING(site), 16);
      }
    }
    if (ok) ok = put_i64_attr(out, c, g_attrs.cl);
    Py_XDECREF(table);
    Py_XDECREF(pk);
    Py_XDECREF(cid);
    Py_XDECREF(val);
    Py_XDECREF(site);
    if (!ok) {
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

#define NEED(k)                                                     \
  if (pos + static_cast<Py_ssize_t>(k) > n) {                       \
    PyErr_SetString(PyExc_ValueError, "truncated change array");    \
    goto fail;                                                      \
  }

PyObject *speedy_decode_changes(PyObject *, PyObject *args) {
  Py_buffer buf;
  Py_ssize_t offset = 0;
  long long count = 0;
  if (!PyArg_ParseTuple(args, "y*nL", &buf, &offset, &count)) return nullptr;
  const uint8_t *p = static_cast<const uint8_t *>(buf.buf);
  Py_ssize_t n = buf.len;
  if (offset < 0 || offset > n || count < 0) {
    PyErr_SetString(PyExc_ValueError, "offset/count out of range");
    PyBuffer_Release(&buf);
    return nullptr;
  }
  Py_ssize_t pos = offset;
  PyObject *out = PyList_New(0);
  if (!out) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  for (long long i = 0; i < count; i++) {
    PyObject *tup = nullptr;
    PyObject *table = nullptr, *pk = nullptr, *cid = nullptr,
             *val = nullptr, *site = nullptr;
    uint32_t len;
    uint64_t col_version, db_version, seqno, cl;
    uint8_t tag;
    /* table */
    NEED(4); len = get_u32le(p + pos); pos += 4;
    NEED(len);
    table = PyUnicode_DecodeUTF8(
        reinterpret_cast<const char *>(p + pos), len, nullptr);
    pos += len;
    if (!table) goto fail;
    /* pk */
    NEED(4); len = get_u32le(p + pos); pos += 4;
    NEED(len);
    pk = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(p + pos), len);
    pos += len;
    if (!pk) goto fail;
    /* cid */
    NEED(4); len = get_u32le(p + pos); pos += 4;
    NEED(len);
    cid = PyUnicode_DecodeUTF8(
        reinterpret_cast<const char *>(p + pos), len, nullptr);
    pos += len;
    if (!cid) goto fail;
    /* val */
    NEED(1); tag = p[pos]; pos += 1;
    if (tag == 0) {
      val = Py_NewRef(Py_None);
    } else if (tag == 1) {
      NEED(8);
      val = PyLong_FromLongLong(
          static_cast<long long>(get_u64le(p + pos)));
      pos += 8;
    } else if (tag == 2) {
      NEED(8);
      uint64_t bits = get_u64le(p + pos);
      pos += 8;
      double d;
      std::memcpy(&d, &bits, 8);
      val = PyFloat_FromDouble(d);
    } else if (tag == 3 || tag == 4) {
      NEED(4); len = get_u32le(p + pos); pos += 4;
      NEED(len);
      val = (tag == 3)
                ? PyUnicode_DecodeUTF8(
                      reinterpret_cast<const char *>(p + pos), len, nullptr)
                : PyBytes_FromStringAndSize(
                      reinterpret_cast<const char *>(p + pos), len);
      pos += len;
    } else {
      PyErr_Format(PyExc_ValueError, "unknown SqliteValue variant %d", tag);
      goto fail;
    }
    if (!val) goto fail;
    /* fixed tail */
    NEED(8 + 8 + 8 + 16 + 8);
    col_version = get_u64le(p + pos); pos += 8;
    db_version = get_u64le(p + pos); pos += 8;
    seqno = get_u64le(p + pos); pos += 8;
    site = PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(p + pos), 16);
    pos += 16;
    if (!site) goto fail;
    cl = get_u64le(p + pos); pos += 8;
    tup = Py_BuildValue(
        "(NNNNLKKNL)", table, pk, cid, val,
        static_cast<long long>(col_version), db_version, seqno, site,
        static_cast<long long>(cl));
    if (!tup) {
      /* Py_BuildValue with N consumed the refs */
      Py_DECREF(out);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    table = pk = cid = val = site = nullptr;
    if (PyList_Append(out, tup) != 0) {
      Py_DECREF(tup);
      Py_DECREF(out);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    Py_DECREF(tup);
    continue;
  fail:
    Py_XDECREF(table);
    Py_XDECREF(pk);
    Py_XDECREF(cid);
    Py_XDECREF(val);
    Py_XDECREF(site);
    Py_DECREF(out);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  PyBuffer_Release(&buf);
  PyObject *res = Py_BuildValue("(Nn)", out, pos);
  if (!res) Py_DECREF(out);
  return res;
}

#undef NEED

PyMethodDef methods[] = {
    {"pack_values", pack_values, METH_O,
     "Pack a sequence of SQL values into one self-describing blob."},
    {"unpack_values", unpack_values, METH_O,
     "Inverse of pack_values."},
    {"value_cmp", value_cmp, METH_VARARGS,
     "cr-sqlite merge tie-break comparison (-1/0/1)."},
    {"deframe", deframe, METH_VARARGS,
     "Split complete u32-BE length-delimited frames off the front."},
    {"speedy_encode_changes", speedy_encode_changes, METH_O,
     "Encode a sequence of Change rows in the speedy wire layout."},
    {"speedy_decode_changes", speedy_decode_changes, METH_VARARGS,
     "(buf, offset, count) -> (list of field tuples, end offset)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_corrosion_native",
    "Native hot-path kernels (packed-pk codec, merge compare, framing).",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__corrosion_native(void) {
  if (!g_attrs.init()) return nullptr;
  return PyModule_Create(&moduledef);
}

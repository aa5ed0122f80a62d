// Host padding of a read list for tpu_debruijn_torch's count.
//
// filter.pad_reads stacks a Python list of base arrays, or of (bases,
// seq_exts, label) items, into one zero-padded (R, L) uint8 matrix with the
// rows' lengths (and the items' exts and labels).  These entry points walk
// the list with the CPython API, so the whole list costs one call instead of
// one interpreter iteration a row.  host_pad.py builds this file with the host
// C++ compiler at first use and binds it with ctypes.PyDLL, which holds the
// GIL through each call.
//
// Two passes, as the matrix's width is the longest row's: a measure pass
// reads each row's len() (and an item's exts and label), a copy pass each
// row's bytes.  A row's bytes are taken only where the Python loop would give
// the same: bases that export a 1-D C-contiguous buffer of unsigned bytes
// (format "B"; not a bytes object, which NumPy reads as a string) as long as
// the row's len().  An item's exts and label are taken where they are Python
// ints within int32.  A pass stops at the first row it cannot take and
// returns that row's index, with no Python error left set; the caller reads
// or pads the rows from there on its own.
//
// Functions (each over rows [0, n) of a list or tuple; `items` nonzero for
// (bases, seq_exts, label) items, zero for base arrays)
//   tdb_pad_measure : rows -> lengths; items -> exts and (labels non-null) labels
//   tdb_pad_copy    : rows' bases -> rows of the (n, width) matrix

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

// The row's bytes as a 1-D C-contiguous unsigned-byte buffer; false (and
// no Python error set) where the object exports none.
bool row_buffer(PyObject* obj, Py_buffer* view) {
  if (PyBytes_Check(obj)) return false;
  if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
    PyErr_Clear();
    return false;
  }
  if (view->ndim == 1 && view->itemsize == 1 &&
      (view->format == nullptr || std::strcmp(view->format, "B") == 0))
    return true;
  PyBuffer_Release(view);
  return false;
}

bool int32_value(PyObject* obj, int32_t* out) {
  if (obj == nullptr || !PyLong_Check(obj)) return false;
  int overflow = 0;
  long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
  if (overflow != 0 || v < INT32_MIN || v > INT32_MAX) {
    PyErr_Clear();
    return false;
  }
  *out = static_cast<int32_t>(v);
  return true;
}

// Field i of an item: a tuple or a list holding at least `need` fields.
PyObject* field(PyObject* item, Py_ssize_t i, Py_ssize_t need) {
  if (PyTuple_Check(item))
    return PyTuple_GET_SIZE(item) >= need ? PyTuple_GET_ITEM(item, i) : nullptr;
  if (PyList_Check(item))
    return PyList_GET_SIZE(item) >= need ? PyList_GET_ITEM(item, i) : nullptr;
  return nullptr;
}

PyObject* bases_of(PyObject* row, bool items) {
  return items ? field(row, 0, 2) : row;
}

// One loop for both list forms and both passes.  With `out` null it
// measures (lengths, and for items exts and labels); else it copies row r's
// bytes, lengths[r] of them, into out[r] and zeroes the tail to `width`.
int64_t walk(PyObject* seqs, int64_t n, bool items, int32_t* lengths, int32_t* exts,
             int32_t* labels, uint8_t* out, int64_t width) {
  if (!PyList_Check(seqs) && !PyTuple_Check(seqs)) return 0;
  PyObject** rows = PySequence_Fast_ITEMS(seqs);
  if (n > PySequence_Fast_GET_SIZE(seqs)) n = PySequence_Fast_GET_SIZE(seqs);
  for (int64_t r = 0; r < n; ++r) {
    PyObject* bases = bases_of(rows[r], items);
    if (bases == nullptr) return r;
    if (out == nullptr) {
      const Py_ssize_t len = PyObject_Size(bases);
      if (len < 0 || len > INT32_MAX) {
        PyErr_Clear();
        return r;
      }
      lengths[r] = static_cast<int32_t>(len);
      if (items) {
        if (!int32_value(field(rows[r], 1, 2), &exts[r])) return r;
        if (labels != nullptr && !int32_value(field(rows[r], 2, 3), &labels[r])) return r;
      }
      continue;
    }
    Py_buffer view;
    if (!row_buffer(bases, &view)) return r;
    const int64_t len = view.len;
    if (len != lengths[r] || len > width) {
      PyBuffer_Release(&view);
      return r;
    }
    uint8_t* dst = out + r * width;
    std::memcpy(dst, view.buf, static_cast<size_t>(len));
    std::memset(dst + len, 0, static_cast<size_t>(width - len));
    PyBuffer_Release(&view);
  }
  return n;
}

}  // namespace

extern "C" {

int64_t tdb_pad_measure(PyObject* seqs, int64_t n, int32_t items, int32_t* lengths,
                        int32_t* exts, int32_t* labels) {
  return walk(seqs, n, items != 0, lengths, exts, labels, nullptr, 0);
}

int64_t tdb_pad_copy(PyObject* seqs, int64_t n, int32_t items, const int32_t* lengths,
                     uint8_t* out, int64_t width) {
  return walk(seqs, n, items != 0, const_cast<int32_t*>(lengths), nullptr, nullptr, out, width);
}

}  // extern "C"

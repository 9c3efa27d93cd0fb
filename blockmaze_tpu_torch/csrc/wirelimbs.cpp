// The prover's witness to one 64-bit word a wire in one pass over the
// interpreter's lists (groth16/prover.py _wire_words): row 0 the constant
// 1, then primary's values, then aux's, each an unsigned little-endian
// word that the card widens to the 16 16-bit limbs of fields/tfield.py
// ints_to_limbs (csrc/widen.cu).
//
// An exact int (bool included) below 2^64 is read with the public C API
// and written here. Every other element (an int at or above 2^64, a
// negative int, any other object: an int subclass, numpy.int64) is left to
// the caller, which makes its 16 limbs with int(x).to_bytes(32, "little")
// and raises what that raises; its word is 0 and its row number goes to
// `wide`.
//
// C ABI for ctypes.PyDLL (the interpreter lock stays held while the lists
// are read): bm_wire_words returns how many rows it left to the caller, or
// -1 with a Python exception set.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {

// list's values into out from `row` on; the rows left to the caller into
// wide[*k], wide[*k + 1], ...
void fill(PyObject *list, uint64_t *out, long long row, long long *wide,
          long long *k) {
  const Py_ssize_t n = PyList_GET_SIZE(list);
  for (Py_ssize_t i = 0; i < n; ++i, ++row) {
    PyObject *x = PyList_GET_ITEM(list, i);
    if (PyLong_CheckExact(x) || PyBool_Check(x)) {
      const unsigned long long v = PyLong_AsUnsignedLongLong(x);
      if (v != ~0ULL || !PyErr_Occurred()) {
        out[row] = v;
        continue;
      }
      PyErr_Clear();  // OverflowError: negative, or 2^64 and above
    }
    out[row] = 0;
    wide[(*k)++] = row;
  }
}

}  // namespace

extern "C" long long bm_wire_words(PyObject *primary, PyObject *aux,
                                   uint64_t *out, long long n,
                                   long long *wide) {
  if (!PyList_Check(primary) || !PyList_Check(aux)) {
    PyErr_SetString(PyExc_TypeError,
                    "bm_wire_words: primary and aux must be lists");
    return -1;
  }
  const long long n_primary = PyList_GET_SIZE(primary);
  if (1 + n_primary + PyList_GET_SIZE(aux) != n) {
    PyErr_SetString(PyExc_ValueError,
                    "bm_wire_words: the output's words are not 1 + "
                    "len(primary) + len(aux)");
    return -1;
  }
  out[0] = 1;
  long long k = 0;
  fill(primary, out, 1, wide, &k);
  fill(aux, out, 1 + n_primary, wide, &k);
  return k;
}

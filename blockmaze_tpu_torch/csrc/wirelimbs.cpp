// The prover's witness to standard-form limbs in one pass over the
// interpreter's lists (groth16/prover.py _wire_limbs): row 0 the constant
// 1, then primary's values, then aux's, each row 16 little-endian 16-bit
// limbs in 32-bit lanes, as fields/tfield.py ints_to_limbs writes them.
//
// An exact int (bool included) below 2^64 is read with the public C API
// and written here. Every other element (an int at or above 2^64, a
// negative int, any other object: an int subclass, numpy.int64) is left to
// the caller, which fills its row with int(x).to_bytes(32, "little") and
// raises what that raises; its row number goes to `wide`.
//
// C ABI for ctypes.PyDLL (the interpreter lock stays held while the lists
// are read): bm_wire_limbs returns how many rows it left to the caller, or
// -1 with a Python exception set.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kLimbs = 16;

// list's values into out's rows from `row` on; the rows left to the
// caller into wide[*k], wide[*k + 1], ...
void fill(PyObject *list, uint32_t *out, long long row, long long *wide,
          long long *k) {
  const Py_ssize_t n = PyList_GET_SIZE(list);
  for (Py_ssize_t i = 0; i < n; ++i, ++row) {
    PyObject *x = PyList_GET_ITEM(list, i);
    if (PyLong_CheckExact(x) || PyBool_Check(x)) {
      const unsigned long long v = PyLong_AsUnsignedLongLong(x);
      if (v != ~0ULL || !PyErr_Occurred()) {
        uint32_t *limbs = out + row * kLimbs;
        limbs[0] = static_cast<uint32_t>(v & 0xffff);
        limbs[1] = static_cast<uint32_t>((v >> 16) & 0xffff);
        limbs[2] = static_cast<uint32_t>((v >> 32) & 0xffff);
        limbs[3] = static_cast<uint32_t>(v >> 48);
        std::memset(limbs + 4, 0, (kLimbs - 4) * sizeof(uint32_t));
        continue;
      }
      PyErr_Clear();  // OverflowError: negative, or 2^64 and above
    }
    wide[(*k)++] = row;
  }
}

}  // namespace

extern "C" long long bm_wire_limbs(PyObject *primary, PyObject *aux,
                                   uint32_t *out, long long n,
                                   long long *wide) {
  if (!PyList_Check(primary) || !PyList_Check(aux)) {
    PyErr_SetString(PyExc_TypeError,
                    "bm_wire_limbs: primary and aux must be lists");
    return -1;
  }
  const long long n_primary = PyList_GET_SIZE(primary);
  if (1 + n_primary + PyList_GET_SIZE(aux) != n) {
    PyErr_SetString(PyExc_ValueError,
                    "bm_wire_limbs: the output's rows are not 1 + "
                    "len(primary) + len(aux)");
    return -1;
  }
  std::memset(out, 0, kLimbs * sizeof(uint32_t));
  out[0] = 1;
  long long k = 0;
  fill(primary, out, 1, wide, &k);
  fill(aux, out, 1 + n_primary, wide, &k);
  return k;
}

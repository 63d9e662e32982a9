// The witness encode in one pass on the host: a constraint system's
// assignment (a Python sequence of ints, in the order it was allocated)
// -> the padded (n_rows, 16) uint16 rows of its Fr limbs, little-endian,
// each value written at its input-major row remap[i].
//
// Built with the host's C++ compiler against the running interpreter's
// Python.h (`groth16/witness.py`) and loaded with ctypes.PyDLL: the pass
// reads PyObjects, so it runs holding the GIL, and an exception it sets
// is raised by ctypes when the call returns.
//
// A value is exported as 32 bytes; it is reduced mod r (PyNumber_Remainder)
// only when it is negative, at least 2^256 or at least r.  The constraint
// system keeps its values canonical, so the reduction is the rare case.

#include <Python.h>

#include <cstdint>
#include <cstring>

#if !defined(__BYTE_ORDER__) || __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "the limb rows are the values' little-endian bytes"
#endif

namespace {

constexpr int kBytes = 32;  // 16 limbs of 16 bits

// v's low 32 bytes, little-endian; -1 (no exception left set) when v is
// negative or does not fit.
int to_bytes32(PyObject *v, uint8_t *buf) {
#if PY_VERSION_HEX >= 0x030D0000
    int rc = _PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(v), buf,
                                 kBytes, /*little_endian=*/1,
                                 /*is_signed=*/0, /*with_exceptions=*/1);
#else
    int rc = _PyLong_AsByteArray(reinterpret_cast<PyLongObject *>(v), buf,
                                 kBytes, /*little_endian=*/1,
                                 /*is_signed=*/0);
#endif
    if (rc < 0) {
        PyErr_Clear();
    }
    return rc;
}

// a < m, both 32 little-endian bytes.
bool below(const uint8_t *a, const uint8_t *m) {
    for (int b = kBytes - 1; b >= 0; --b) {
        if (a[b] != m[b]) {
            return a[b] < m[b];
        }
    }
    return false;
}

}  // namespace

// values: a sequence of ints.  remap: len(values) int32 rows, or NULL for
// row i.  modulus: r as an int; mod_le: its 32 little-endian bytes.  out:
// n_rows * 16 uint16, zeroed by the caller.  n_reduced: set to the number
// of values that were reduced.
//
// Returns the number of values written; -2 when a value is None (the
// system is not in proving mode); -1 with an exception set otherwise
// (TypeError for a value that is not an int, ValueError for a row outside
// out, or the remainder's own error).
extern "C" int64_t bz_encode_assignment(PyObject *values,
                                        const int32_t *remap,
                                        PyObject *modulus,
                                        const uint8_t *mod_le, uint16_t *out,
                                        int64_t n_rows, int64_t *n_reduced) {
    *n_reduced = 0;
    PyObject *fast = PySequence_Fast(values, "the assignment is not a "
                                             "sequence");
    if (fast == nullptr) {
        return -1;
    }
    const int64_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    int64_t rc = n;
    for (int64_t i = 0; i < n; ++i) {
        PyObject *v = items[i];
        const int64_t row = remap != nullptr ? remap[i] : i;
        if (row < 0 || row >= n_rows) {
            PyErr_Format(PyExc_ValueError,
                         "value %lld goes to row %lld of %lld",
                         static_cast<long long>(i),
                         static_cast<long long>(row),
                         static_cast<long long>(n_rows));
            rc = -1;
            break;
        }
        if (v == Py_None) {
            rc = -2;
            break;
        }
        if (!PyLong_Check(v)) {
            PyErr_Format(PyExc_TypeError,
                         "assignment value %lld is %.100s, not int",
                         static_cast<long long>(i), Py_TYPE(v)->tp_name);
            rc = -1;
            break;
        }
        uint8_t buf[kBytes];
        if (to_bytes32(v, buf) < 0 || !below(buf, mod_le)) {
            PyObject *red = PyNumber_Remainder(v, modulus);
            if (red == nullptr) {
                rc = -1;
                break;
            }
            const int ok = to_bytes32(red, buf);
            Py_DECREF(red);
            if (ok < 0) {
                PyErr_SetString(PyExc_ValueError,
                                "a value mod r does not fit 32 bytes");
                rc = -1;
                break;
            }
            ++*n_reduced;
        }
        std::memcpy(out + row * 16, buf, kBytes);
    }
    Py_DECREF(fast);
    return rc;
}

"""The reference's proving-key text file through the host tokenizer.

Port of blockmaze_tpu/serialization/native_io.py. BlockMaze keeps its
proving keys as libsnark decimal text (85 MB for mint, 253 MB for
deposit), every point compressed to x and the parity of y. The JAX
package's native parser (C++ over GMP) decompressed every point on the
host; here the C++ tokenizer (csrc/keyparse.cpp, built at first use with
g++ into _build/ and bound by utils/kernels.host_lib, no GMP) turns the
decimal tokens into limbs and nothing more, and keys.load_text_pk
decompresses the points on the device (curves/decompress.py). A failed
build or parse raises: there is no fallback to the Python reader.
"""

from __future__ import annotations

import ctypes as C
import dataclasses

import numpy as np

from ..fields import tfield as tf
from ..utils import kernels as kn
from . import libsnark_io as io

_P = C.c_void_p


@dataclasses.dataclass
class Compressed:
    """Compressed points: x in standard form as 16-bit limbs in uint32
    lanes ((n, 16) G1, (n, 2, 16) G2: c0 then c1), the parity bit of y
    (of y.c0 for G2) and the zero flag, uint8 (n,)."""
    x: np.ndarray
    lsb: np.ndarray
    zero: np.ndarray


@dataclasses.dataclass
class TextKey:
    """A proving key's text as the tokenizer leaves it. g1 holds every G1
    point of the queries in file order A, B (its G1 half), H, L
    (g1_counts gives their sizes), g2 B's G2 points; rows, vars and coeffs
    the COO of the constraint matrices a, b, c in that order (nnz gives
    each one's length), constraint by constraint, terms in file order,
    coefficients reduced mod r in standard form. The five group constants
    are host affine ints, decompressed on the host."""
    primary_input_size: int
    aux_input_size: int
    num_constraints: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    g1: Compressed
    g1_counts: dict
    g2: Compressed
    B_idx: np.ndarray
    rows: np.ndarray
    vars: np.ndarray
    coeffs: np.ndarray
    nnz: dict


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def _points(n: int, coords: tuple) -> Compressed:
    return Compressed(np.empty((n,) + coords, np.uint32),
                      np.empty(n, np.uint8), np.empty(n, np.uint8))


def parse_pk_text(path: str) -> TextKey:
    """Tokenize the proving key at `path` (libsnark_io.load_proving_key's
    layout). Raises ValueError on a malformed or truncated file (with the
    byte offset), and on a group constant off its curve."""
    lib = kn.host_lib("keyparse.cpp")
    meta = (C.c_longlong * 10)()
    err = C.create_string_buffer(512)
    handle = lib.bm_keytext_parse(path.encode(), meta, err, len(err))
    if not handle:
        raise ValueError(f"{path}: {err.value.decode()}")
    try:
        primary, aux, ncons, nA, nB, nH, nL, nnz_a, nnz_b, nnz_c = list(meta)
        c1, c2 = _points(3, (16,)), _points(2, (2, 16))
        g1 = _points(nA + nB + nH + nL, (16,))
        g2 = _points(nB, (2, 16))
        B_idx = np.empty(nB, np.int32)
        nnz = nnz_a + nnz_b + nnz_c
        rows, vars_ = np.empty(nnz, np.int32), np.empty(nnz, np.int32)
        coeffs = np.empty((nnz, 16), np.uint32)
        lib.bm_keytext_fill(C.c_void_p(handle),
                            *(_ptr(a) for p in (c1, c2, g1, g2)
                              for a in (p.x, p.lsb, p.zero)),
                            _ptr(B_idx), _ptr(rows), _ptr(vars_),
                            _ptr(coeffs))
    finally:
        lib.bm_keytext_free(C.c_void_p(handle))

    x1, x2 = tf.limbs_to_ints(c1.x), tf.limbs_to_ints(c2.x)

    def g1c(i):
        return io.g1_from_compressed(int(c1.zero[i]), x1[i], int(c1.lsb[i]))

    def g2c(i):
        return io.g2_from_compressed(int(c2.zero[i]),
                                     (x2[2 * i], x2[2 * i + 1]),
                                     int(c2.lsb[i]))

    return TextKey(
        primary_input_size=primary, aux_input_size=aux,
        num_constraints=ncons, alpha_g1=g1c(0), beta_g1=g1c(1),
        beta_g2=g2c(0), delta_g1=g1c(2), delta_g2=g2c(1), g1=g1,
        g1_counts={"A": nA, "B1": nB, "H": nH, "L": nL}, g2=g2, B_idx=B_idx,
        rows=rows, vars=vars_, coeffs=coeffs,
        nnz={"a": nnz_a, "b": nnz_b, "c": nnz_c})

"""The proof's host group law in native code: csrc/hostcurve.cpp, built
with g++ at first use and bound by utils/kernels.host_lib (its HOST_LIBS
entry: -O3, the interpreter lock released through each call).

Points are host affine tuples as curves/host_curve.py has them, (x, y,
inf) for G1 and ((x0, x1), (y0, y1), inf) for G2, with (0, 0, 1) and
((0, 0), (0, 0), 1) at infinity; scalars are any ints, taken mod r. Every
result equals host_curve's for the same inputs (affine coordinates are
unique), which stays the exact oracle of the tests.

muls() counts the scalar products the calling thread has made in the
library: the prover's spans prover.blinds, prover.unblind and
prover.group carry their rise as {"muls": n}."""

from __future__ import annotations

import ctypes

import numpy as np

from ..fields.constants import R_MOD
from ..utils import kernels as kn

WORDS = {"g1": 9, "g2": 17}         # 64-bit words of an affine point
_FQ_LIMBS = {"g1": 16, "g2": 32}    # card limbs of one coordinate


def lib():
    """csrc/hostcurve.cpp's library, built and bound at the first call."""
    return kn.host_lib("hostcurve.cpp")


def muls() -> int:
    """The scalar products this thread has made in the library."""
    return lib().bm_hc_muls()


def _fq(x: int) -> bytes:
    return int(x).to_bytes(32, "little")


def _scalar(k: int) -> bytes:
    return (k % R_MOD).to_bytes(32, "little")


def _pack(curve: str, p) -> bytes:
    x, y, inf = p
    coords = (x, y) if curve == "g1" else (*x, *y)
    return b"".join(map(_fq, coords)) + (1 if inf else 0).to_bytes(8,
                                                                   "little")


def _unpack(curve: str, raw: bytes, off: int = 0):
    w = [int.from_bytes(raw[off + 32 * i:off + 32 * i + 32], "little")
         for i in range(2 if curve == "g1" else 4)]
    inf = int.from_bytes(raw[off + 32 * len(w):off + 32 * len(w) + 8],
                         "little")
    if curve == "g1":
        return (w[0], w[1], inf)
    return ((w[0], w[1]), (w[2], w[3]), inf)


def _call(fn, curve: str, *args):
    out = ctypes.create_string_buffer(8 * WORDS[curve])
    fn(kn.CURVE_ID[curve], *args, out)
    return _unpack(curve, out.raw)


def mul(curve: str, p, k: int):
    """k * p (host_curve.g1_mul / g2_mul)."""
    return _call(lib().bm_hc_mul, curve, _pack(curve, p), _scalar(k))


def add(curve: str, p, q):
    """p + q (host_curve.g1_add / g2_add): the group law's exceptional
    cases (infinity, P + P, P + (-P)) held to host_curve by the tests."""
    return _call(lib().bm_hc_add, curve, _pack(curve, p), _pack(curve, q))


def msub(curve: str, p, R, m: int):
    """p - m * R, one scalar product."""
    return _call(lib().bm_hc_msub, curve, _pack(curve, p), _pack(curve, R),
                 _scalar(m))


def unblind(curve: str, jac, R, m: int):
    """The card's Jacobian point jac = (X, Y, Z), each Montgomery limbs
    ((16,) G1, (2, 16) G2; int32 arrays as the MSM returns them), less
    m * R, affine: what tcurve.g?_jacobian_to_host gives less m * R, one
    scalar product."""
    X, Y, Z = (np.ascontiguousarray(v, dtype=np.int32) for v in jac)
    for v in (X, Y, Z):
        if v.size != _FQ_LIMBS[curve]:
            raise ValueError(f"a {curve} coordinate has {_FQ_LIMBS[curve]} "
                             f"limbs, got shape {v.shape}")
    return _call(lib().bm_hc_unblind, curve, X.ctypes.data, Y.ctypes.data,
                 Z.ctypes.data, _pack(curve, R), _scalar(m))


def combine(consts, terms, r: int, s: int):
    """The proof's (A, B, C) from the key's (alpha_g1, beta_g1, beta_g2,
    delta_g1, delta_g2) and the unblinded MSM results (At, Bt2, Bt1, Ht,
    Lt):
      A = alpha + At + r*delta,  B = beta + Bt + s*delta (G2 and G1),
      C = Ht + Lt + s*A + r*B1 - (r*s mod r)*delta,
    six scalar products."""
    g = ("g1", "g1", "g2", "g1", "g2")
    t = ("g1", "g2", "g1", "g1", "g1")
    out = ctypes.create_string_buffer(8 * (2 * WORDS["g1"] + WORDS["g2"]))
    lib().bm_hc_combine(
        b"".join(_pack(c, p) for c, p in zip(g, consts)),
        b"".join(_pack(c, p) for c, p in zip(t, terms)),
        _scalar(r) + _scalar(s) + _scalar(r * s), out)
    raw = out.raw
    return (_unpack("g1", raw), _unpack("g2", raw, 8 * WORDS["g1"]),
            _unpack("g1", raw, 8 * (WORDS["g1"] + WORDS["g2"])))

"""alt_bn128 group law on torch tensors: the plain versions of the point
kernels, and host conversions.

Same formulas and the same branchless selects as the JAX package
(blockmaze_tpu/curves/jcurve.py): dbl-2009-l, add-2007-bl and madd-2007-bl
for a = 0, with infinity encoded as Z == 0. Every field op returns the
canonical residue, so any evaluation of the same formulas gives the same
Jacobian triple bit for bit; the CUDA versions (csrc/curve.cuh) rely on this.

G1 coordinates are (..., 16) Fq limb tensors, G2 coordinates (..., 2, 16)
over Fq2 = Fq[u]/(u^2 + 1). Points are (X, Y, Z) Jacobian or (x, y, inf)
affine tuples.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import host as hf
from ..fields import tfield as tf
from ..fields.constants import Q_MOD

FQ = tf.FQ


class FqOps:
    """Fq on (..., 16) limb tensors."""

    @staticmethod
    def mul(a, b):
        return tf.mont_mul(FQ, a, b)

    @staticmethod
    def sqr(a):
        return tf.mont_mul(FQ, a, a)

    @staticmethod
    def add(a, b):
        return tf.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return tf.sub(FQ, a, b)

    @staticmethod
    def inv(a):
        return tf.inv(FQ, a)

    is_zero = staticmethod(tf.is_zero)
    select = staticmethod(tf.select)

    @staticmethod
    def one_like(a):
        return tf.const(FQ.one_mont, a).expand(a.shape)


class Fq2Ops:
    """Fq2 on (..., 2, 16) limb tensors; the three Fq products of a
    Karatsuba multiply run as one batched mont_mul."""

    @staticmethod
    def mul(a, b):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        sums = tf.add(FQ, torch.stack([a0, b0], -2), torch.stack([a1, b1], -2))
        t = tf.mont_mul(FQ, torch.stack([a0, a1, sums[..., 0, :]], -2),
                        torch.stack([b0, b1, sums[..., 1, :]], -2))
        t0, t1, s = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        c0 = tf.sub(FQ, t0, t1)
        c1 = tf.sub(FQ, tf.sub(FQ, s, t0), t1)
        return torch.stack([c0, c1], -2)

    @staticmethod
    def sqr(a):
        a0, a1 = a[..., 0, :], a[..., 1, :]
        t = tf.mont_mul(FQ, torch.stack([tf.add(FQ, a0, a1), a0], -2),
                        torch.stack([tf.sub(FQ, a0, a1), a1], -2))
        c1 = t[..., 1, :]
        return torch.stack([t[..., 0, :], tf.add(FQ, c1, c1)], -2)

    @staticmethod
    def inv(a):
        """(a0 - a1 u) / (a0^2 + a1^2); 0 maps to 0."""
        a0, a1 = a[..., 0, :], a[..., 1, :]
        ti = tf.inv(FQ, tf.add(FQ, tf.mont_mul(FQ, a0, a0),
                               tf.mont_mul(FQ, a1, a1)))
        return torch.stack([tf.mont_mul(FQ, a0, ti),
                            tf.neg(FQ, tf.mont_mul(FQ, a1, ti))], -2)

    @staticmethod
    def add(a, b):
        return tf.add(FQ, a, b)

    @staticmethod
    def sub(a, b):
        return tf.sub(FQ, a, b)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1).all(dim=-1)

    @staticmethod
    def select(mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    @staticmethod
    def one_like(a):
        one = torch.zeros((2, tf.N), dtype=torch.int64, device=a.device)
        one[0] = tf.const(FQ.one_mont, a)
        return one.expand(a.shape)


def ops(curve: str):
    return FqOps if curve == "g1" else Fq2Ops


def coord_tail(curve: str) -> tuple:
    return (tf.N,) if curve == "g1" else (2, tf.N)


# ---------------------------------------------------------------------------
# Formulas (jcurve.py:254-311)
# ---------------------------------------------------------------------------

def _dbl(F, X, Y, Z):
    """dbl-2009-l (a = 0)."""
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.sub(F.sub(F.sqr(F.add(X, B)), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = F.add(C, C)
    C8 = F.add(C8, C8)
    C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    YZ = F.mul(Y, Z)
    Z3 = F.add(YZ, YZ)
    return X3, Y3, Z3


def _add_core(F, X1, Y1, Z1, X2, Y2, Z2):
    """add-2007-bl without the exceptional cases."""
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
    S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
    H = F.sub(U2, U1)
    r = F.sub(S2, S1)
    r = F.add(r, r)
    I = F.sqr(F.add(H, H))
    J = F.mul(H, I)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.add(V, V))
    SJ = F.mul(S1, J)
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(SJ, SJ))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return X3, Y3, Z3, H, r


def _madd_core(F, X1, Y1, Z1, Qx, Qy):
    """madd-2007-bl (Z2 = 1) without the exceptional cases."""
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(Qx, Z1Z1)
    S2 = F.mul(Qy, F.mul(Z1, Z1Z1))
    H = F.sub(U2, X1)
    HH = F.sqr(H)
    I = F.add(HH, HH)
    I = F.add(I, I)
    J = F.mul(H, I)
    r = F.sub(S2, Y1)
    r = F.add(r, r)
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.add(V, V))
    YJ = F.mul(Y1, J)
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.add(YJ, YJ))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    return X3, Y3, Z3, H, r


# ---------------------------------------------------------------------------
# Point ops with the JAX package's selects (jcurve.py:314-417)
# ---------------------------------------------------------------------------

def point_double(F, P):
    return _dbl(F, *P)


def point_add(F, P, Q):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    X3, Y3, Z3, H, r = _add_core(F, X1, Y1, Z1, X2, Y2, Z2)
    DX, DY, DZ = _dbl(F, X1, Y1, Z1)
    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    is_dbl = F.is_zero(H) & F.is_zero(r) & ~p_inf & ~q_inf
    X3 = F.select(is_dbl, DX, X3)
    Y3 = F.select(is_dbl, DY, Y3)
    Z3 = F.select(is_dbl, DZ, Z3)
    X3 = F.select(p_inf, X2, X3)
    Y3 = F.select(p_inf, Y2, Y3)
    Z3 = F.select(p_inf, Z2, Z3)
    keep_p = q_inf & ~p_inf
    X3 = F.select(keep_p, X1, X3)
    Y3 = F.select(keep_p, Y1, Y3)
    Z3 = F.select(keep_p, Z1, Z3)
    return (X3, Y3, Z3)


def point_mixed_add(F, P, Qx, Qy, q_inf):
    X1, Y1, Z1 = P
    X3, Y3, Z3, H, r = _madd_core(F, X1, Y1, Z1, Qx, Qy)
    DX, DY, DZ = _dbl(F, X1, Y1, Z1)
    p_inf = F.is_zero(Z1)
    is_dbl = F.is_zero(H) & F.is_zero(r) & ~p_inf & ~q_inf
    X3 = F.select(is_dbl, DX, X3)
    Y3 = F.select(is_dbl, DY, Y3)
    Z3 = F.select(is_dbl, DZ, Z3)
    X3 = F.select(p_inf, Qx, X3)
    Y3 = F.select(p_inf, Qy, Y3)
    Z3 = F.select(p_inf, F.one_like(Z1), Z3)
    keep_p = q_inf & ~p_inf
    X3 = F.select(keep_p, X1, X3)
    Y3 = F.select(keep_p, Y1, Y3)
    Z3 = F.select(keep_p, Z1, Z3)
    Z3 = F.select(q_inf & p_inf, torch.zeros_like(Z3), Z3)
    return (X3, Y3, Z3)


def point_mixed_add_noexc(F, P, Qx, Qy, q_inf):
    """Mixed add without the doubling and infinity cases: exact whenever
    the accumulator is neither infinity nor ±Q (the blinded accumulations
    of msm/pippenger.py and groth16/generator.py)."""
    X1, Y1, Z1 = P
    X3, Y3, Z3, _, _ = _madd_core(F, X1, Y1, Z1, Qx, Qy)
    return (F.select(q_inf, X1, X3), F.select(q_inf, Y1, Y3),
            F.select(q_inf, Z1, Z3))


def jacobian_to_affine(curve: str, P):
    """Jacobian batch -> affine (x, y) Montgomery int32 tensors and a bool
    infinity mask, as the proving key stores points (infinity: x = y = 0).
    Z^-1 by Fermat; Z = 0 inverts to 0, which zeroes x and y."""
    F = ops(curve)
    X, Y, Z = P
    zi = F.inv(Z)
    zi2 = F.sqr(zi)
    return (F.mul(X, zi2).to(torch.int32),
            F.mul(Y, F.mul(zi2, zi)).to(torch.int32), F.is_zero(Z))


# ---------------------------------------------------------------------------
# Host conversions (jcurve.py:424-483)
# ---------------------------------------------------------------------------

def g1_affine_to_device(points) -> tuple:
    """Host affine (x, y, inf) list -> (X (n,16), Y (n,16), inf (n,))
    Montgomery numpy arrays."""
    xs = tf.to_mont_host(FQ, [p[0] for p in points])
    ys = tf.to_mont_host(FQ, [p[1] for p in points])
    inf = np.array([bool(p[2]) for p in points], dtype=bool)
    return xs, ys, inf


def g2_affine_to_device(points) -> tuple:
    xs = np.stack([tf.to_mont_host(FQ, [p[0][0] for p in points]),
                   tf.to_mont_host(FQ, [p[0][1] for p in points])], axis=1)
    ys = np.stack([tf.to_mont_host(FQ, [p[1][0] for p in points]),
                   tf.to_mont_host(FQ, [p[1][1] for p in points])], axis=1)
    inf = np.array([bool(p[2]) for p in points], dtype=bool)
    return xs, ys, inf


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def g1_jacobian_to_host(P) -> list:
    """Jacobian G1 batch -> host affine list (one Fq inversion per batch)."""
    X = tf.from_mont_host(FQ, _host(P[0]))
    Y = tf.from_mont_host(FQ, _host(P[1]))
    Z = tf.from_mont_host(FQ, _host(P[2]))
    zi = _inv_all(Z, lambda a, b: a * b % Q_MOD, lambda a: pow(a, -1, Q_MOD))
    out = []
    for x, y, z, i in zip(X, Y, Z, zi):
        if z == 0:
            out.append((0, 0, 1))
        else:
            i2 = i * i % Q_MOD
            out.append((x * i2 % Q_MOD, y * i2 % Q_MOD * i % Q_MOD, 0))
    return out


def g2_jacobian_to_host(P) -> list:
    def unmont(t, k):
        return tf.from_mont_host(FQ, _host(t)[..., k, :])

    X0, X1 = unmont(P[0], 0), unmont(P[0], 1)
    Y0, Y1 = unmont(P[1], 0), unmont(P[1], 1)
    Z = list(zip(unmont(P[2], 0), unmont(P[2], 1)))
    zi = _inv_all(Z, hf.fq2_mul, hf.fq2_inv, zero=hf.FQ2_ZERO)
    out = []
    for x0, x1, y0, y1, z, i in zip(X0, X1, Y0, Y1, Z, zi):
        if z == hf.FQ2_ZERO:
            out.append((hf.FQ2_ZERO, hf.FQ2_ZERO, 1))
        else:
            i2 = hf.fq2_sqr(i)
            out.append((hf.fq2_mul((x0, x1), i2),
                        hf.fq2_mul((y0, y1), hf.fq2_mul(i2, i)), 0))
    return out


def _inv_all(vals, mul, inv, zero=0):
    """Montgomery batch inversion: inverses of the nonzero entries (zero
    entries map to None) with a single field inversion."""
    before = []          # product of the nonzero entries before index i
    acc = None
    for v in vals:
        before.append(acc)
        if v != zero:
            acc = v if acc is None else mul(acc, v)
    out = [None] * len(vals)
    if acc is None:
        return out
    acc_inv = inv(acc)   # inverse of the product of all nonzero entries
    for i in range(len(vals) - 1, -1, -1):
        v = vals[i]
        if v == zero:
            continue
        out[i] = acc_inv if before[i] is None else mul(acc_inv, before[i])
        acc_inv = mul(acc_inv, v)
    return out

"""Optimal ate pairing over alt_bn128 (host-side exact arithmetic).

The Groth16 verifier's acceptance check is pairing-based; correctness matters
far more than speed here (3 Miller loops + 1 final exponentiation per verify,
~5 ms in CPython). Mirrors the algorithm of alt_bn128_pairing.cpp:110-470
(flipped Miller loop with precomputed line coefficients, Fuentes-Castaneda
final exponentiation) as an independent Python implementation.
"""

from __future__ import annotations

from ..fields import host as F
from ..fields.constants import (
    ATE_LOOP_COUNT,
    FINAL_EXPONENT_Z,
    G2_TWIST,
    Q_MOD,
)
from . import host_curve as HC


# ---------------------------------------------------------------------------
# Line-function steps (alt_bn128_pairing.cpp:241-288)
# ---------------------------------------------------------------------------

_TWO_INV = pow(2, -1, Q_MOD)


def _twist_coeff_b():
    return HC.g2_b_coeff()


def _dbl_step(current):
    """Doubling step; returns (new_current, (ell_0, ell_VW, ell_VV)).
    current is (X, Y, Z) in homogeneous projective coords over Fq2."""
    X, Y, Z = current
    A = F.fq2_mul_scalar(F.fq2_mul(X, Y), _TWO_INV)
    B = F.fq2_sqr(Y)
    C = F.fq2_sqr(Z)
    D = F.fq2_add(C, F.fq2_add(C, C))
    E = F.fq2_mul(_twist_coeff_b(), D)
    Fv = F.fq2_add(E, F.fq2_add(E, E))
    G = F.fq2_mul_scalar(F.fq2_add(B, Fv), _TWO_INV)
    H = F.fq2_sub(F.fq2_sqr(F.fq2_add(Y, Z)), F.fq2_add(B, C))
    I = F.fq2_sub(E, B)
    J = F.fq2_sqr(X)
    E2 = F.fq2_sqr(E)

    nX = F.fq2_mul(A, F.fq2_sub(B, Fv))
    nY = F.fq2_sub(F.fq2_sqr(G), F.fq2_add(E2, F.fq2_add(E2, E2)))
    nZ = F.fq2_mul(B, H)
    ell_0 = F.fq2_mul(G2_TWIST, I)
    ell_VW = F.fq2_neg(H)
    ell_VV = F.fq2_add(J, F.fq2_add(J, J))
    return (nX, nY, nZ), (ell_0, ell_VW, ell_VV)


def _add_step(base_xy, current):
    """Mixed addition step with affine base; returns (new_current, coeffs)."""
    x2, y2 = base_xy
    X1, Y1, Z1 = current
    D = F.fq2_sub(X1, F.fq2_mul(x2, Z1))
    E = F.fq2_sub(Y1, F.fq2_mul(y2, Z1))
    Fv = F.fq2_sqr(D)
    G = F.fq2_sqr(E)
    H = F.fq2_mul(D, Fv)
    I = F.fq2_mul(X1, Fv)
    J = F.fq2_sub(F.fq2_add(H, F.fq2_mul(Z1, G)), F.fq2_add(I, I))

    nX = F.fq2_mul(D, J)
    nY = F.fq2_sub(F.fq2_mul(E, F.fq2_sub(I, J)), F.fq2_mul(H, Y1))
    nZ = F.fq2_mul(Z1, H)
    ell_0 = F.fq2_mul(G2_TWIST, F.fq2_sub(F.fq2_mul(E, x2), F.fq2_mul(D, y2)))
    ell_VV = F.fq2_neg(E)
    ell_VW = D
    return (nX, nY, nZ), (ell_0, ell_VW, ell_VV)


def precompute_g2(q):
    """Line coefficients for the flipped Miller loop
    (alt_bn128_ate_precompute_G2, pairing.cpp:305-365)."""
    assert not q[2], "cannot precompute the zero point"
    xq, yq = q[0], q[1]
    R = (xq, yq, F.FQ2_ONE)
    coeffs = []
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip the MSB itself
    for bit in bits:
        R, c = _dbl_step(R)
        coeffs.append(c)
        if bit == "1":
            R, c = _add_step((xq, yq), R)
            coeffs.append(c)

    q1 = HC.g2_mul_by_q((xq, yq, 0))
    q2 = HC.g2_mul_by_q(q1)
    q2 = (q2[0], F.fq2_neg(q2[1]), 0)

    R, c = _add_step((q1[0], q1[1]), R)
    coeffs.append(c)
    R, c = _add_step((q2[0], q2[1]), R)
    coeffs.append(c)
    return coeffs


def _mul_by_024(f, ell_0, ell_vw, ell_vv):
    """f * (ell_0 + ell_VV*v^2 + ell_VW*w) — generic sparse product
    (semantics of Fp12::mul_by_024, fp12_2over3over2.tcc:239-259)."""
    a = ((ell_0, F.FQ2_ZERO, ell_vv), (F.FQ2_ZERO, ell_vw, F.FQ2_ZERO))
    return F.fq12_mul(f, a)


def miller_loop(p, q_coeffs):
    """Single Miller loop; p is an affine nonzero G1 point."""
    px, py = p[0], p[1]
    f = F.FQ12_ONE
    idx = 0
    bits = bin(ATE_LOOP_COUNT)[3:]
    for bit in bits:
        c = q_coeffs[idx]
        idx += 1
        f = F.fq12_sqr(f)
        f = _mul_by_024(f, c[0], F.fq2_mul_scalar(c[1], py), F.fq2_mul_scalar(c[2], px))
        if bit == "1":
            c = q_coeffs[idx]
            idx += 1
            f = _mul_by_024(f, c[0], F.fq2_mul_scalar(c[1], py), F.fq2_mul_scalar(c[2], px))
    c = q_coeffs[idx]
    idx += 1
    f = _mul_by_024(f, c[0], F.fq2_mul_scalar(c[1], py), F.fq2_mul_scalar(c[2], px))
    c = q_coeffs[idx]
    f = _mul_by_024(f, c[0], F.fq2_mul_scalar(c[1], py), F.fq2_mul_scalar(c[2], px))
    return f


def _cyclotomic_exp(a, e: int):
    r = F.FQ12_ONE
    started = False
    for bit in bin(e)[2:]:
        if started:
            r = F.fq12_cyclotomic_sqr(r)
        if bit == "1":
            r = F.fq12_mul(r, a) if started else a
            started = True
    return r


def _exp_by_neg_z(a):
    # z positive => result = conj(a^z) (pairing.cpp:137-148)
    return F.fq12_conj(_cyclotomic_exp(a, FINAL_EXPONENT_Z))


def final_exponentiation(f):
    """(q^12-1)/r exponentiation (pairing.cpp:110-236)."""
    # first chunk: f^((q^6-1)(q^2+1))
    A = F.fq12_conj(f)
    B = F.fq12_inv(f)
    Cv = F.fq12_mul(A, B)
    D = F.fq12_frobenius(Cv, 2)
    elt = F.fq12_mul(D, Cv)

    # last chunk (Fuentes-Castaneda addition chain)
    A = _exp_by_neg_z(elt)
    B = F.fq12_cyclotomic_sqr(A)
    Cc = F.fq12_cyclotomic_sqr(B)
    D = F.fq12_mul(Cc, B)
    E = _exp_by_neg_z(D)
    Fv = F.fq12_cyclotomic_sqr(E)
    G = _exp_by_neg_z(Fv)
    H = F.fq12_conj(D)
    I = F.fq12_conj(G)
    J = F.fq12_mul(I, E)
    K = F.fq12_mul(J, H)
    L = F.fq12_mul(K, B)
    M = F.fq12_mul(K, E)
    N = F.fq12_mul(M, elt)
    O = F.fq12_frobenius(L, 1)
    P = F.fq12_mul(O, N)
    Q = F.fq12_frobenius(K, 2)
    R = F.fq12_mul(Q, P)
    S = F.fq12_conj(elt)
    T = F.fq12_mul(S, L)
    U = F.fq12_frobenius(T, 3)
    V = F.fq12_mul(U, R)
    return V


def pairing(p, q):
    """Reduced ate pairing e(P, Q) for affine P in G1, Q in G2."""
    if p[2] or q[2]:
        return F.FQ12_ONE
    return final_exponentiation(miller_loop(p, precompute_g2(q)))


def double_miller_loop(p1, coeffs1, p2, coeffs2):
    """Product of two Miller loops sharing the squaring schedule
    (alt_bn128_ate_double_miller_loop)."""
    f = F.FQ12_ONE
    idx = 0
    bits = bin(ATE_LOOP_COUNT)[3:]

    def ml(f, p, c):
        return _mul_by_024(f, c[0], F.fq2_mul_scalar(c[1], p[1]),
                           F.fq2_mul_scalar(c[2], p[0]))

    for bit in bits:
        c1, c2 = coeffs1[idx], coeffs2[idx]
        idx += 1
        f = F.fq12_sqr(f)
        f = ml(ml(f, p1, c1), p2, c2)
        if bit == "1":
            c1, c2 = coeffs1[idx], coeffs2[idx]
            idx += 1
            f = ml(ml(f, p1, c1), p2, c2)
    for _ in range(2):
        c1, c2 = coeffs1[idx], coeffs2[idx]
        idx += 1
        f = ml(ml(f, p1, c1), p2, c2)
    return f

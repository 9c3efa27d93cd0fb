"""Host-side (Python int) alt_bn128 G1/G2 group operations.

Exact-arithmetic oracle used by the verifier, serialization, and kernel
golden tests. Group law formulas match the reference Jacobian implementation
(alt_bn128_g1.cpp:208-350, alt_bn128_g2.cpp) but points here are kept affine:
(x, y, is_zero) for G1, ((x0,x1),(y0,y1),is_zero) for G2.
"""

from __future__ import annotations

from ..fields import host as F
from ..fields.constants import Q_MOD, R_MOD, G1_B, G2_TWIST, G1_ONE, G2_ONE
from ..fields.constants import TWIST_MUL_BY_Q_X, TWIST_MUL_BY_Q_Y

G1_ZERO = (0, 0, 1)
G2_ZERO = (F.FQ2_ZERO, F.FQ2_ZERO, 1)

_g2_b = None


def g2_b_coeff():
    """b' = b / twist = 3 / (9 + u)  (alt_bn128_init.cpp:250)."""
    global _g2_b
    if _g2_b is None:
        _g2_b = F.fq2_mul_scalar(F.fq2_inv(G2_TWIST), G1_B)
    return _g2_b


# ---------------------------------------------------------------------------
# G1 (affine)
# ---------------------------------------------------------------------------

def g1_is_on_curve(p) -> bool:
    x, y, inf = p
    if inf:
        return True
    return (y * y - (x * x % Q_MOD * x + G1_B)) % Q_MOD == 0


def g1_neg(p):
    x, y, inf = p
    if inf:
        return p
    return (x, (-y) % Q_MOD, 0)


def g1_add(p, q):
    if p[2]:
        return q
    if q[2]:
        return p
    x1, y1, _ = p
    x2, y2, _ = q
    if x1 == x2:
        if (y1 + y2) % Q_MOD == 0:
            return G1_ZERO
        # doubling
        lam = 3 * x1 * x1 % Q_MOD * pow(2 * y1 % Q_MOD, -1, Q_MOD) % Q_MOD
    else:
        lam = (y2 - y1) * pow((x2 - x1) % Q_MOD, -1, Q_MOD) % Q_MOD
    x3 = (lam * lam - x1 - x2) % Q_MOD
    y3 = (lam * (x1 - x3) - y1) % Q_MOD
    return (x3, y3, 0)


def g1_mul(p, k: int):
    k %= R_MOD
    r = G1_ZERO
    base = p
    while k:
        if k & 1:
            r = g1_add(r, base)
        base = g1_add(base, base)
        k >>= 1
    return r


# ---------------------------------------------------------------------------
# G2 (affine over Fq2)
# ---------------------------------------------------------------------------

def g2_is_on_curve(p) -> bool:
    x, y, inf = p
    if inf:
        return True
    lhs = F.fq2_sqr(y)
    rhs = F.fq2_add(F.fq2_mul(F.fq2_sqr(x), x), g2_b_coeff())
    return lhs == rhs


def g2_neg(p):
    x, y, inf = p
    if inf:
        return p
    return (x, F.fq2_neg(y), 0)


def g2_add(p, q):
    if p[2]:
        return q
    if q[2]:
        return p
    x1, y1, _ = p
    x2, y2, _ = q
    if x1 == x2:
        if F.fq2_add(y1, y2) == F.FQ2_ZERO:
            return G2_ZERO
        num = F.fq2_mul_scalar(F.fq2_sqr(x1), 3)
        den = F.fq2_mul_scalar(y1, 2)
        lam = F.fq2_mul(num, F.fq2_inv(den))
    else:
        lam = F.fq2_mul(F.fq2_sub(y2, y1), F.fq2_inv(F.fq2_sub(x2, x1)))
    x3 = F.fq2_sub(F.fq2_sub(F.fq2_sqr(lam), x1), x2)
    y3 = F.fq2_sub(F.fq2_mul(lam, F.fq2_sub(x1, x3)), y1)
    return (x3, y3, 0)


def g2_mul(p, k: int):
    k %= R_MOD
    r = G2_ZERO
    base = p
    while k:
        if k & 1:
            r = g2_add(r, base)
        base = g2_add(base, base)
        k >>= 1
    return r


def g2_mul_by_q(p):
    """Untwist-Frobenius-twist endomorphism (alt_bn128_g2.cpp:367-372)."""
    x, y, inf = p
    if inf:
        return p
    return (
        F.fq2_mul(TWIST_MUL_BY_Q_X, F.fq2_frobenius(x, 1)),
        F.fq2_mul(TWIST_MUL_BY_Q_Y, F.fq2_frobenius(y, 1)),
        0,
    )


def g1_generator():
    return (G1_ONE[0], G1_ONE[1], 0)


def g2_generator():
    return (G2_ONE[0], G2_ONE[1], 0)

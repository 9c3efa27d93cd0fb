"""Host-side (Python int) arithmetic for Fr / Fq and the Fq2/Fq6/Fq12 tower.

This is the exact-arithmetic oracle used for (a) serialization/interop,
(b) the pairing-based Groth16 verifier, (c) golden tests of the TPU kernels.
Semantics mirror the reference field tower
(libff/algebra/fields/{fp,fp2,fp6_3over2,fp12_2over3over2}.tcc) but the code
is an independent implementation over Python integers.

Representation:
  Fq / Fr : int in [0, p)
  Fq2     : tuple (c0, c1)          -- c0 + c1*u,  u^2 = -1
  Fq6     : tuple of 3 Fq2          -- c0 + c1*v + c2*v^2,  v^3 = 9 + u
  Fq12    : tuple of 2 Fq6          -- c0 + c1*w,  w^2 = v
"""

from .constants import (
    Q_MOD,
    R_MOD,
    FQ2_NON_RESIDUE,
    FQ6_NON_RESIDUE,
    FQ2_FROBENIUS_C1,
    FQ6_FROBENIUS_C1,
    FQ6_FROBENIUS_C2,
    FQ12_FROBENIUS_C1,
    FQ_T_MINUS_1_OVER_2,
)

# ---------------------------------------------------------------------------
# Fp (works for both Fr and Fq — pass the modulus)
# ---------------------------------------------------------------------------


def fp_inv(a: int, p: int) -> int:
    return pow(a, -1, p)


def fq_sqrt(a: int):
    """Square root in Fq. Since q ≡ 3 (mod 4) (s=1), sqrt = a^((q+1)/4).

    Returns None if a is not a QR. Mirrors the Tonelli–Shanks special case the
    reference hits with Fq::s == 1 (fp.tcc sqrt via field_utils).
    """
    a %= Q_MOD
    if a == 0:
        return 0
    # (q+1)/4 = (t+1)/2 with t = (q-1)/2 ... for s=1: q-1 = 2t, (q+1)/4 = (t+1)/2
    x = pow(a, (FQ_T_MINUS_1_OVER_2 * 2 + 1 + 1) // 2, Q_MOD)
    if x * x % Q_MOD != a:
        return None
    return x


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q_MOD, (a[1] + b[1]) % Q_MOD)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q_MOD, (a[1] - b[1]) % Q_MOD)


def fq2_neg(a):
    return ((-a[0]) % Q_MOD, (-a[1]) % Q_MOD)


def fq2_mul(a, b):
    # u^2 = non_residue = -1
    a0b0 = a[0] * b[0]
    a1b1 = a[1] * b[1]
    c0 = (a0b0 + FQ2_NON_RESIDUE * a1b1) % Q_MOD
    c1 = ((a[0] + a[1]) * (b[0] + b[1]) - a0b0 - a1b1) % Q_MOD
    return (c0, c1)


def fq2_mul_scalar(a, k: int):
    return (a[0] * k % Q_MOD, a[1] * k % Q_MOD)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_inv(a):
    # (c0 - c1 u) / (c0^2 + c1^2)   [non_residue = -1]
    t = (a[0] * a[0] - FQ2_NON_RESIDUE * a[1] * a[1]) % Q_MOD
    ti = fp_inv(t, Q_MOD)
    return (a[0] * ti % Q_MOD, (-a[1] * ti) % Q_MOD)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q_MOD)


def fq2_frobenius(a, power: int):
    return (a[0], a[1] * FQ2_FROBENIUS_C1[power % 2] % Q_MOD)


def fq2_mul_by_non_residue(a):
    """Multiply by (9 + u), the Fq6 non-residue (fp6_3over2 mul_by_non_residue)."""
    nr = FQ6_NON_RESIDUE
    return fq2_mul(nr, a)


def fq2_pow(a, e: int):
    r = FQ2_ONE
    while e:
        if e & 1:
            r = fq2_mul(r, a)
        a = fq2_sqr(a)
        e >>= 1
    return r


def fq2_sqrt(a):
    """Tonelli–Shanks in Fq2 (s = 4). Used for G2 point decompression."""
    from .constants import Q_MOD as q

    if a == FQ2_ZERO:
        return FQ2_ZERO
    # constants from alt_bn128_init.cpp:148-151
    s = 4
    t = 29943448501038927652624252826042421299953269783193801402277987640879380855398639840490065738714866998199264519675818766364765977133724184290399563929243
    t_minus_1_over_2 = (t - 1) // 2
    nqr_to_t = (
        5033503716262624267312492558379982687175200734934877598599011485707452665730,
        314498342015008975724433667930697407966947188435857772134235984660852259084,
    )
    v = s
    z = nqr_to_t
    w = fq2_pow(a, t_minus_1_over_2)
    x = fq2_mul(a, w)
    b = fq2_mul(x, w)
    # check QR: b^(2^(s-1)) must be 1
    chk = b
    for _ in range(s - 1):
        chk = fq2_sqr(chk)
    if chk != FQ2_ONE:
        return None
    while b != FQ2_ONE:
        m = 0
        b2m = b
        while b2m != FQ2_ONE:
            b2m = fq2_sqr(b2m)
            m += 1
        j = v - m - 1
        w = z
        for _ in range(j):
            w = fq2_sqr(w)
        z = fq2_sqr(w)
        b = fq2_mul(b, z)
        x = fq2_mul(x, w)
        v = m
    return x


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v]/(v^3 - (9+u))
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0 = fq2_mul(a0, b0)
    v1 = fq2_mul(a1, b1)
    v2 = fq2_mul(a2, b2)
    c0 = fq2_add(v0, fq2_mul_by_non_residue(
        fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(v1, v2))))
    c1 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(v0, v1)),
        fq2_mul_by_non_residue(v2))
    c2 = fq2_add(
        fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(v0, v2)), v1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_non_residue(a):
    """Multiply by v: (c0,c1,c2) -> (nr*c2, c0, c1)."""
    return (fq2_mul_by_non_residue(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    t0 = fq2_sqr(a0)
    t1 = fq2_sqr(a1)
    t2 = fq2_sqr(a2)
    t3 = fq2_mul(a0, a1)
    t4 = fq2_mul(a0, a2)
    t5 = fq2_mul(a1, a2)
    c0 = fq2_sub(t0, fq2_mul_by_non_residue(t5))
    c1 = fq2_sub(fq2_mul_by_non_residue(t2), t3)
    c2 = fq2_sub(t1, t4)
    t6 = fq2_inv(fq2_add(fq2_mul(a0, c0),
                         fq2_mul_by_non_residue(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2)))))
    return (fq2_mul(t6, c0), fq2_mul(t6, c1), fq2_mul(t6, c2))


def fq6_frobenius(a, power: int):
    return (
        fq2_frobenius(a[0], power),
        fq2_mul(FQ6_FROBENIUS_C1[power % 6], fq2_frobenius(a[1], power)),
        fq2_mul(FQ6_FROBENIUS_C2[power % 6], fq2_frobenius(a[2], power)),
    )


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    v0 = fq6_mul(a0, b0)
    v1 = fq6_mul(a1, b1)
    c0 = fq6_add(v0, fq6_mul_by_non_residue(v1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), v0), v1)
    return (c0, c1)


def fq12_sqr(a):
    # complex squaring
    a0, a1 = a
    ab = fq6_mul(a0, a1)
    c0 = fq6_sub(
        fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_non_residue(a1))), ab),
        fq6_mul_by_non_residue(ab))
    c1 = fq6_add(ab, ab)
    return (c0, c1)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_inv(fq6_sub(fq6_sqr(a0), fq6_mul_by_non_residue(fq6_sqr(a1))))
    return (fq6_mul(a0, t), fq6_neg(fq6_mul(a1, t)))


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_frobenius(a, power: int):
    c0 = fq6_frobenius(a[0], power)
    b = fq6_frobenius(a[1], power)
    coef = FQ12_FROBENIUS_C1[power % 12]
    return (c0, (fq2_mul(b[0], coef), fq2_mul(b[1], coef), fq2_mul(b[2], coef)))


def fq12_pow(a, e: int):
    r = FQ12_ONE
    while e:
        if e & 1:
            r = fq12_mul(r, a)
        a = fq12_sqr(a)
        e >>= 1
    return r


def fq12_cyclotomic_sqr(a):
    """Squaring in the cyclotomic subgroup (Granger–Scott),
    mirroring alt_bn128_Fq12::cyclotomic_squared semantics."""
    (c00, c01, c02), (c10, c11, c12) = a
    z0, z4, z3, z2, z1, z5 = c00, c01, c02, c10, c11, c12

    def m(x, y):
        return fq2_mul(x, y)

    tmp = m(z0, z1)
    t0 = fq2_sub(fq2_sub(m(fq2_add(z0, z1), fq2_add(z0, fq2_mul_by_non_residue(z1))), tmp),
                 fq2_mul_by_non_residue(tmp))
    t1 = fq2_add(tmp, tmp)
    tmp = m(z2, z3)
    t2 = fq2_sub(fq2_sub(m(fq2_add(z2, z3), fq2_add(z2, fq2_mul_by_non_residue(z3))), tmp),
                 fq2_mul_by_non_residue(tmp))
    t3 = fq2_add(tmp, tmp)
    tmp = m(z4, z5)
    t4 = fq2_sub(fq2_sub(m(fq2_add(z4, z5), fq2_add(z4, fq2_mul_by_non_residue(z5))), tmp),
                 fq2_mul_by_non_residue(tmp))
    t5 = fq2_add(tmp, tmp)

    z0 = fq2_add(fq2_mul_scalar(fq2_sub(t0, z0), 2), t0)
    z1 = fq2_add(fq2_mul_scalar(fq2_add(t1, z1), 2), t1)
    tmp = fq2_mul_by_non_residue(t5)
    z2 = fq2_add(fq2_mul_scalar(fq2_add(tmp, z2), 2), tmp)
    z3 = fq2_add(fq2_mul_scalar(fq2_sub(t4, z3), 2), t4)
    z4 = fq2_add(fq2_mul_scalar(fq2_sub(t2, z4), 2), t2)
    z5 = fq2_add(fq2_mul_scalar(fq2_add(t3, z5), 2), t3)
    return ((z0, z4, z3), (z2, z1, z5))

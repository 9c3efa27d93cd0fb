"""Plain BN254 (alt_bn128) arithmetic for the benchmark's reference: Fq,
the Fq2/Fq6/Fq12 tower, G1 and G2 in affine form, and the optimal ate
pairing over Python integers.

A frozen copy of the port's host field, curve and pairing modules
(blockmaze_tpu_torch/fields/{constants,host}.py, curves/host_curve.py,
curves/pairing.py), concatenated with their imports taken out, so that the
benchmark's judge imports nothing of the program it judges. Points are
(x, y, is_zero) in G1 and ((x0, x1), (y0, y1), is_zero) in G2; Fq2 is
(c0, c1), Fq6 three Fq2, Fq12 two Fq6.
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# Prime moduli (alt_bn128_init.cpp:96 and :122)
# ---------------------------------------------------------------------------
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617  # Fr: scalar field
Q_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583  # Fq: base field

# ---------------------------------------------------------------------------
# Curve equations / generators (alt_bn128_init.cpp:200-270)
# ---------------------------------------------------------------------------
G1_B = 3
G1_ONE = (1, 2)  # affine generator

# Fq2 = Fq[u]/(u^2 - non_residue); non_residue = -1
FQ2_NON_RESIDUE = Q_MOD - 1

# twist = (9, 1); G2 curve: y^2 = x^3 + b/twist
G2_TWIST = (9, 1)
G2_ONE = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# Fq6 = Fq2[v]/(v^3 - (9+u));  Fq12 = Fq6[w]/(w^2 - v)
FQ6_NON_RESIDUE = (9, 1)

# ---------------------------------------------------------------------------
# Pairing parameters (alt_bn128_init.cpp:271-277)
# ---------------------------------------------------------------------------
ATE_LOOP_COUNT = 29793968203157093288
ATE_IS_LOOP_COUNT_NEG = False
FINAL_EXPONENT_Z = 4965661367192848881
FINAL_EXPONENT_IS_Z_NEG = False

# Frobenius coefficients (alt_bn128_init.cpp:152-196)
FQ2_FROBENIUS_C1 = (1, Q_MOD - 1)

FQ6_FROBENIUS_C1 = (
    (1, 0),
    (21575463638280843010398324269430826099269044274347216827212613867836435027261,
     10307601595873709700152284273816112264069230130616436755625194854815875713954),
    (21888242871839275220042445260109153167277707414472061641714758635765020556616, 0),
    (3772000881919853776433695186713858239009073593817195771773381919316419345261,
     2236595495967245188281701248203181795121068902605861227855261137820944008926),
    (2203960485148121921418603742825762020974279258880205651966, 0),
    (18429021223477853657660792034369865839114504446431234726392080002137598044644,
     9344045779998320333812420223237981029506012124075525679208581902008406485703),
)
FQ6_FROBENIUS_C2 = (
    (1, 0),
    (2581911344467009335267311115468803099551665605076196740867805258568234346338,
     19937756971775647987995932169929341994314640652964949448313374472400716661030),
    (2203960485148121921418603742825762020974279258880205651966, 0),
    (5324479202449903542726783395506214481928257762400643279780343368557297135718,
     16208900380737693084919495127334387981393726419856888799917914180988844123039),
    (21888242871839275220042445260109153167277707414472061641714758635765020556616, 0),
    (13981852324922362344252311234282257507216387789820983642040889267519694726527,
     7629828391165209371577384193250820201684255241773809077146787135900891633097),
)
FQ12_FROBENIUS_C1 = (
    (1, 0),
    (8376118865763821496583973867626364092589906065868298776909617916018768340080,
     16469823323077808223889137241176536799009286646108169935659301613961712198316),
    (21888242871839275220042445260109153167277707414472061641714758635765020556617, 0),
    (11697423496358154304825782922584725312912383441159505038794027105778954184319,
     303847389135065887422783454877609941456349188919719272345083954437860409601),
    (21888242871839275220042445260109153167277707414472061641714758635765020556616, 0),
    (3321304630594332808241809054958361220322477375291206261884409189760185844239,
     5722266937896532885780051958958348231143373700109372999374820235121374419868),
    (21888242871839275222246405745257275088696311157297823662689037894645226208582, 0),
    (13512124006075453725662431877630910996106405091429524885779419978626457868503,
     5418419548761466998357268504080738289687024511189653727029736280683514010267),
    (2203960485148121921418603742825762020974279258880205651966, 0),
    (10190819375481120917420622822672549775783927716138318623895010788866272024264,
     21584395482704209334823622290379665147239961968378104390343953940207365798982),
    (2203960485148121921418603742825762020974279258880205651967, 0),
    (18566938241244942414004596690298913868373833782006617400804628704885040364344,
     16165975933942742336466353786298926857552937457188450663314217659523851788715),
)

# twist endomorphism coefficients (alt_bn128_init.cpp:252-257)
TWIST_MUL_BY_Q_X = (
    21575463638280843010398324269430826099269044274347216827212613867836435027261,
    10307601595873709700152284273816112264069230130616436755625194854815875713954,
)
TWIST_MUL_BY_Q_Y = (
    2821565182194536844548159561693502659359617185244120367078079554186484126554,
    3505843767911556378687030309984248845540243509899259641013678093033130930403,
)


# ---------------------------------------------------------------------------
# Fp (works for both Fr and Fq — pass the modulus)
# ---------------------------------------------------------------------------


def fp_inv(a: int, p: int) -> int:
    return pow(a, -1, p)




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

# ---------------------------------------------------------------------------

G1_ZERO = (0, 0, 1)
G2_ZERO = (FQ2_ZERO, FQ2_ZERO, 1)

_g2_b = None


def g2_b_coeff():
    """b' = b / twist = 3 / (9 + u)  (alt_bn128_init.cpp:250)."""
    global _g2_b
    if _g2_b is None:
        _g2_b = fq2_mul_scalar(fq2_inv(G2_TWIST), G1_B)
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
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), g2_b_coeff())
    return lhs == rhs


def g2_neg(p):
    x, y, inf = p
    if inf:
        return p
    return (x, fq2_neg(y), 0)


def g2_add(p, q):
    if p[2]:
        return q
    if q[2]:
        return p
    x1, y1, _ = p
    x2, y2, _ = q
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return G2_ZERO
        num = fq2_mul_scalar(fq2_sqr(x1), 3)
        den = fq2_mul_scalar(y1, 2)
        lam = fq2_mul(num, fq2_inv(den))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sqr(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
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
        fq2_mul(TWIST_MUL_BY_Q_X, fq2_frobenius(x, 1)),
        fq2_mul(TWIST_MUL_BY_Q_Y, fq2_frobenius(y, 1)),
        0,
    )


def g1_generator():
    return (G1_ONE[0], G1_ONE[1], 0)


def g2_generator():
    return (G2_ONE[0], G2_ONE[1], 0)

# ---------------------------------------------------------------------------
# Line-function steps (alt_bn128_pairing.cpp:241-288)
# ---------------------------------------------------------------------------

_TWO_INV = pow(2, -1, Q_MOD)


def _twist_coeff_b():
    return g2_b_coeff()


def _dbl_step(current):
    """Doubling step; returns (new_current, (ell_0, ell_VW, ell_VV)).
    current is (X, Y, Z) in homogeneous projective coords over Fq2."""
    X, Y, Z = current
    A = fq2_mul_scalar(fq2_mul(X, Y), _TWO_INV)
    B = fq2_sqr(Y)
    C = fq2_sqr(Z)
    D = fq2_add(C, fq2_add(C, C))
    E = fq2_mul(_twist_coeff_b(), D)
    Fv = fq2_add(E, fq2_add(E, E))
    G = fq2_mul_scalar(fq2_add(B, Fv), _TWO_INV)
    H = fq2_sub(fq2_sqr(fq2_add(Y, Z)), fq2_add(B, C))
    I = fq2_sub(E, B)
    J = fq2_sqr(X)
    E2 = fq2_sqr(E)

    nX = fq2_mul(A, fq2_sub(B, Fv))
    nY = fq2_sub(fq2_sqr(G), fq2_add(E2, fq2_add(E2, E2)))
    nZ = fq2_mul(B, H)
    ell_0 = fq2_mul(G2_TWIST, I)
    ell_VW = fq2_neg(H)
    ell_VV = fq2_add(J, fq2_add(J, J))
    return (nX, nY, nZ), (ell_0, ell_VW, ell_VV)


def _add_step(base_xy, current):
    """Mixed addition step with affine base; returns (new_current, coeffs)."""
    x2, y2 = base_xy
    X1, Y1, Z1 = current
    D = fq2_sub(X1, fq2_mul(x2, Z1))
    E = fq2_sub(Y1, fq2_mul(y2, Z1))
    Fv = fq2_sqr(D)
    G = fq2_sqr(E)
    H = fq2_mul(D, Fv)
    I = fq2_mul(X1, Fv)
    J = fq2_sub(fq2_add(H, fq2_mul(Z1, G)), fq2_add(I, I))

    nX = fq2_mul(D, J)
    nY = fq2_sub(fq2_mul(E, fq2_sub(I, J)), fq2_mul(H, Y1))
    nZ = fq2_mul(Z1, H)
    ell_0 = fq2_mul(G2_TWIST, fq2_sub(fq2_mul(E, x2), fq2_mul(D, y2)))
    ell_VV = fq2_neg(E)
    ell_VW = D
    return (nX, nY, nZ), (ell_0, ell_VW, ell_VV)


def precompute_g2(q):
    """Line coefficients for the flipped Miller loop
    (alt_bn128_ate_precompute_G2, pairing.cpp:305-365)."""
    assert not q[2], "cannot precompute the zero point"
    xq, yq = q[0], q[1]
    R = (xq, yq, FQ2_ONE)
    coeffs = []
    bits = bin(ATE_LOOP_COUNT)[3:]  # skip the MSB itself
    for bit in bits:
        R, c = _dbl_step(R)
        coeffs.append(c)
        if bit == "1":
            R, c = _add_step((xq, yq), R)
            coeffs.append(c)

    q1 = g2_mul_by_q((xq, yq, 0))
    q2 = g2_mul_by_q(q1)
    q2 = (q2[0], fq2_neg(q2[1]), 0)

    R, c = _add_step((q1[0], q1[1]), R)
    coeffs.append(c)
    R, c = _add_step((q2[0], q2[1]), R)
    coeffs.append(c)
    return coeffs


def _mul_by_024(f, ell_0, ell_vw, ell_vv):
    """f * (ell_0 + ell_VV*v^2 + ell_VW*w) — generic sparse product
    (semantics of Fp12::mul_by_024, fp12_2over3over2.tcc:239-259)."""
    a = ((ell_0, FQ2_ZERO, ell_vv), (FQ2_ZERO, ell_vw, FQ2_ZERO))
    return fq12_mul(f, a)


def miller_loop(p, q_coeffs):
    """Single Miller loop; p is an affine nonzero G1 point."""
    px, py = p[0], p[1]
    f = FQ12_ONE
    idx = 0
    bits = bin(ATE_LOOP_COUNT)[3:]
    for bit in bits:
        c = q_coeffs[idx]
        idx += 1
        f = fq12_sqr(f)
        f = _mul_by_024(f, c[0], fq2_mul_scalar(c[1], py), fq2_mul_scalar(c[2], px))
        if bit == "1":
            c = q_coeffs[idx]
            idx += 1
            f = _mul_by_024(f, c[0], fq2_mul_scalar(c[1], py), fq2_mul_scalar(c[2], px))
    c = q_coeffs[idx]
    idx += 1
    f = _mul_by_024(f, c[0], fq2_mul_scalar(c[1], py), fq2_mul_scalar(c[2], px))
    c = q_coeffs[idx]
    f = _mul_by_024(f, c[0], fq2_mul_scalar(c[1], py), fq2_mul_scalar(c[2], px))
    return f


def _cyclotomic_exp(a, e: int):
    r = FQ12_ONE
    started = False
    for bit in bin(e)[2:]:
        if started:
            r = fq12_cyclotomic_sqr(r)
        if bit == "1":
            r = fq12_mul(r, a) if started else a
            started = True
    return r


def _exp_by_neg_z(a):
    # z positive => result = conj(a^z) (pairing.cpp:137-148)
    return fq12_conj(_cyclotomic_exp(a, FINAL_EXPONENT_Z))


def final_exponentiation(f):
    """(q^12-1)/r exponentiation (pairing.cpp:110-236)."""
    # first chunk: f^((q^6-1)(q^2+1))
    A = fq12_conj(f)
    B = fq12_inv(f)
    Cv = fq12_mul(A, B)
    D = fq12_frobenius(Cv, 2)
    elt = fq12_mul(D, Cv)

    # last chunk (Fuentes-Castaneda addition chain)
    A = _exp_by_neg_z(elt)
    B = fq12_cyclotomic_sqr(A)
    Cc = fq12_cyclotomic_sqr(B)
    D = fq12_mul(Cc, B)
    E = _exp_by_neg_z(D)
    Fv = fq12_cyclotomic_sqr(E)
    G = _exp_by_neg_z(Fv)
    H = fq12_conj(D)
    I = fq12_conj(G)
    J = fq12_mul(I, E)
    K = fq12_mul(J, H)
    L = fq12_mul(K, B)
    M = fq12_mul(K, E)
    N = fq12_mul(M, elt)
    O = fq12_frobenius(L, 1)
    P = fq12_mul(O, N)
    Q = fq12_frobenius(K, 2)
    R = fq12_mul(Q, P)
    S = fq12_conj(elt)
    T = fq12_mul(S, L)
    U = fq12_frobenius(T, 3)
    V = fq12_mul(U, R)
    return V


def pairing(p, q):
    """Reduced ate pairing e(P, Q) for affine P in G1, Q in G2."""
    if p[2] or q[2]:
        return FQ12_ONE
    return final_exponentiation(miller_loop(p, precompute_g2(q)))


def double_miller_loop(p1, coeffs1, p2, coeffs2):
    """Product of two Miller loops sharing the squaring schedule
    (alt_bn128_ate_double_miller_loop)."""
    f = FQ12_ONE
    idx = 0
    bits = bin(ATE_LOOP_COUNT)[3:]

    def ml(f, p, c):
        return _mul_by_024(f, c[0], fq2_mul_scalar(c[1], p[1]),
                           fq2_mul_scalar(c[2], p[0]))

    for bit in bits:
        c1, c2 = coeffs1[idx], coeffs2[idx]
        idx += 1
        f = fq12_sqr(f)
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

"""Point decompression on a torch device: the proving key's compressed
points (x in standard form, the parity bit of y, the zero flag) to the
affine Montgomery limbs the DevicePK stores.

The kernels (csrc/keyload.cu, decompress_g1 and decompress_g2, one
thread a point) take the place of the host decompression of the JAX
package's native parser (blockmaze_tpu/native/keyparse.cpp g1_decompress,
g2_decompress) and of the Python reader (serialization/libsnark_io.py
read_g1 / read_g2). Beside each is its plain version on tfield's int64
limb ops, which the wrappers run for CPU tensors; both run the chains of
fields/host.py, so G2's root is host.fq2_sqrt's (Tonelli-Shanks, s = 4)
also where the parity of y.c0 = 0 cannot pick it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import tfield as tf
from ..fields.constants import G1_B, Q_MOD
from ..utils import kernels as kn
from . import tcurve as tc
from .host_curve import g2_b_coeff

FQ = tf.FQ
# y = y2^((q + 1) / 4) in Fq (q = 3 mod 4)
G1_SQRT_EXP = (Q_MOD + 1) // 4
# Tonelli-Shanks in Fq2 (alt_bn128_init.cpp:148-151): q^2 - 1 = 2^S t
TS_S = 4
TS_T = (Q_MOD * Q_MOD - 1) >> TS_S
G2_SQRT_EXP = (TS_T - 1) // 2
NQR_TO_T = (  # nqr^t, host.fq2_sqrt's z
    int("5033503716262624267312492558379982687175200734934877598599011485"
        "707452665730"),
    int("3144983420150089757244336679306974079669471884358577721342359846"
        "60852259084"),
)
# Fq products of the chains (left-to-right square-and-multiply from the top
# bit): squarings, then multiplies
G1_CHAIN = (G1_SQRT_EXP.bit_length() - 1, bin(G1_SQRT_EXP).count("1") - 1)
G2_CHAIN = (G2_SQRT_EXP.bit_length() - 1, bin(G2_SQRT_EXP).count("1") - 1)
# Fq products per nonzero point around the root: x to Montgomery form,
# x^3, the check y*y and y's parity (G2: in Fq2, a square 2 Fq products
# and a product 3)
G2_SQR, G2_MUL = 2, 3
G1_AROUND = 1 + 2 + 1 + 1
G2_AROUND = 2 + (G2_SQR + G2_MUL) + G2_SQR + 1


def _mont(vals) -> np.ndarray:
    return tf.to_mont_host(FQ, vals)


def _plain_one(like):
    one = torch.zeros(tf.N, dtype=torch.int64, device=like.device)
    one[0] = 1
    return one


def _pow(F, a, e: int):
    """a^e, left to right from e's top bit (csrc/keyload.cu pow_const)."""
    r = a
    for bit in bin(e)[3:]:
        r = F.sqr(r)
        if bit == "1":
            r = F.mul(r, a)
    return r


def _eq(a, b):
    return (a == b).flatten(1).all(1)


def _finish(x, y, zero, bad):
    """Zero points as the key stores infinity: x = y = 0, inf set, not bad."""
    z = zero.to(torch.bool)
    mask = z.reshape((-1,) + (1,) * (x.dim() - 1))
    return (torch.where(mask, 0, x).to(torch.int32),
            torch.where(mask, 0, y).to(torch.int32), z, bad & ~z)


def decompress_g1_plain(xs, lsb, zero):
    """The kernel's function in plain torch ops: (x, y) (n, 16) int32
    Montgomery, inf and bad (x off the curve) bool (n,)."""
    F = tc.FqOps
    x = tf.mont_mul(FQ, xs, tf.const(FQ.r2_limbs, xs))
    y2 = F.add(F.mul(F.sqr(x), x), tf.const(_mont([G1_B])[0], x))
    y = _pow(F, y2, G1_SQRT_EXP)
    bad = ~_eq(F.sqr(y), y2)
    odd = tf.mont_mul(FQ, y, _plain_one(y))[:, 0] & 1
    y = tf.select(odd != lsb.to(torch.int64), tf.neg(FQ, y), y)
    return _finish(x, y, zero, bad)


def fq2_sqrt_plain(a):
    """host.fq2_sqrt on (n, 2, 16) Montgomery limbs: (root, is_square);
    the root of a non-square is meaningless."""
    F = tc.Fq2Ops
    one = F.one_like(a)
    n = a.shape[0]
    w0 = _pow(F, a, G2_SQRT_EXP)
    x = F.mul(a, w0)
    b = F.mul(x, w0)
    chk = b
    for _ in range(TS_S - 1):
        chk = F.sqr(chk)
    a_zero = F.is_zero(a)
    square = _eq(chk, one) | a_zero
    z = torch.from_numpy(_mont(NQR_TO_T).astype(np.int64)).to(a.device) \
        .expand(a.shape)
    v = torch.full((n,), TS_S, dtype=torch.int64, device=a.device)
    active = square & ~a_zero & ~_eq(b, one)
    for _ in range(TS_S):
        if not bool(active.any()):
            break
        # m: the fewest squarings that take b to one (at most S - 1)
        m = torch.zeros_like(v)
        b2m, found = b, ~active
        for k in range(1, TS_S):
            b2m = F.sqr(b2m)
            hit = _eq(b2m, one) & ~found
            m = torch.where(hit, k, m)
            found = found | hit
        j = v - m - 1
        w = z
        for k in range(TS_S - 1):
            w = F.select(active & (k < j), F.sqr(w), w)
        z_next = F.sqr(w)
        z = F.select(active, z_next, z)
        b = F.select(active, F.mul(b, z_next), b)
        x = F.select(active, F.mul(x, w), x)
        v = torch.where(active, m, v)
        active = active & ~_eq(b, one)
    return F.select(a_zero, torch.zeros_like(x), x), square


def decompress_g2_plain(xs, lsb, zero):
    """The kernel's function in plain torch ops: (x, y) (n, 2, 16) int32
    Montgomery, inf and bad bool (n,)."""
    F = tc.Fq2Ops
    x = tf.mont_mul(FQ, xs, tf.const(FQ.r2_limbs, xs))
    b2 = torch.from_numpy(_mont(g2_b_coeff()).astype(np.int64)).to(x.device)
    y2 = F.add(F.mul(F.sqr(x), x), b2.expand(x.shape))
    y, square = fq2_sqrt_plain(y2)
    bad = ~square | ~_eq(F.sqr(y), y2)
    odd = tf.mont_mul(FQ, y[:, 0], _plain_one(y))[:, 0] & 1
    neg = torch.stack([tf.neg(FQ, y[:, 0]), tf.neg(FQ, y[:, 1])], 1)
    y = F.select(odd != lsb.to(torch.int64), neg, y)
    return _finish(x, y, zero, bad)


PLAIN = {"g1": decompress_g1_plain, "g2": decompress_g2_plain}


def _check_shapes(curve, xs, lsb, zero):
    n = xs.shape[0]
    if xs.shape != (n,) + tc.coord_tail(curve) or lsb.shape != (n,) or \
            zero.shape != (n,):
        raise ValueError(f"decompress_{curve}: bad shapes "
                         f"{tuple(xs.shape)}, {tuple(lsb.shape)}, "
                         f"{tuple(zero.shape)}")


def decompress_raw(curve: str, xs, lsb, zero):
    """(x, y, inf, bad) of compressed points: the kernel on a card, the
    plain version on the CPU; xs int32 standard-form limbs ((n, 16) G1,
    (n, 2, 16) G2), lsb and zero uint8 (n,)."""
    _check_shapes(curve, xs, lsb, zero)
    if kn.on_cpu(xs, lsb, zero):
        return kn.plain_by_rows(PLAIN[curve], xs, lsb, zero)
    xs = xs.to(torch.int32).contiguous()
    lsb, zero = lsb.to(torch.uint8).contiguous(), \
        zero.to(torch.uint8).contiguous()
    kn.check_cuda(f"decompress_{curve}", xs, lsb, zero)
    x, y = torch.empty_like(xs), torch.empty_like(xs)
    n = xs.shape[0]
    inf = torch.empty(n, dtype=torch.uint8, device=xs.device)
    bad = torch.empty_like(inf)
    if n:
        kn.K[f"decompress_{curve}"](kn.CURVE_ID[curve], x, y, inf, bad, xs,
                                    lsb, zero, n)
    return x, y, inf.view(torch.bool), bad.view(torch.bool)


def decompress(curve: str, xs, lsb, zero, queries=None):
    """Affine Montgomery (x, y, inf) of compressed points (decompress_raw).
    Raises ValueError, naming the query and the index, if a point's x is
    not on the curve; queries lists (name, count) of the consecutive
    queries the points belong to (default one query "points")."""
    x, y, inf, bad = decompress_raw(curve, xs, lsb, zero)
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0, 0])
        for name, count in queries or [("points", xs.shape[0])]:
            if i < count:
                break
            i -= count
        what = "G1 x-coordinate not on curve" if curve == "g1" else \
            "G2 x-coordinate not on twist curve"
        raise ValueError(f"{what}: {name}[{i}]")
    return x, y, inf

"""The proof's native host group law (blockmaze_tpu_torch/curves/native.py,
csrc/hostcurve.cpp) against curves/host_curve.py, the exact oracle, on the
CPU: scalar products and adds with their edge cases, the MSM results read
from the card's Jacobian Montgomery limbs, the unblinding, the proof's A,
B and C, and a whole Prover.prove with host_curve's scalar products made
to raise."""

import random

import numpy as np
import pytest
import torch

from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.curves import native
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import host as hf
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import Q_MOD, R_MOD
from blockmaze_tpu_torch.groth16 import generator, keys, verifier
from blockmaze_tpu_torch.groth16 import prover as gp
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.utils import spans

from test_torch_host_copies import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

C = 4                       # the window of the blinds' counts here
W = pp.n_windows(C)
CURVES = {
    "g1": (HC.g1_generator(), HC.g1_mul, HC.g1_add, HC.g1_neg, HC.G1_ZERO),
    "g2": (HC.g2_generator(), HC.g2_mul, HC.g2_add, HC.g2_neg, HC.G2_ZERO),
}
EDGE_SCALARS = [0, 1, 2, 15, 16, R_MOD - 1, R_MOD, R_MOD + 1, 2 ** 256 - 1,
                -1]


def point(curve, k):
    g, mul = CURVES[curve][:2]
    return mul(g, k)


def card_jacobian(curve, p, z):
    """p as the card's Jacobian (X, Y, Z) Montgomery limbs, with Z = z (an
    Fq or Fq2 value), (16,) or (2, 16) int32 arrays; Z = 0 at infinity."""
    if curve == "g1":
        if p[2]:
            xyz = (1, 1, 0)
        else:
            z2 = z * z % Q_MOD
            xyz = (p[0] * z2 % Q_MOD, p[1] * z2 % Q_MOD * z % Q_MOD, z)
        return tuple(tf.to_mont_host(tf.FQ, [v])[0].view(np.int32)
                     for v in xyz)
    if p[2]:
        xyz = (hf.FQ2_ONE, hf.FQ2_ONE, hf.FQ2_ZERO)
    else:
        z2 = hf.fq2_sqr(z)
        xyz = (hf.fq2_mul(p[0], z2), hf.fq2_mul(p[1], hf.fq2_mul(z2, z)), z)
    return tuple(tf.to_mont_host(tf.FQ, list(v)).view(np.int32)
                 for v in xyz)


def z_value(curve, rng):
    v = rng.randrange(1, Q_MOD)
    return v if curve == "g1" else (v, rng.randrange(Q_MOD))


def hc_surplus(wts, c):
    """The blind's multiple, summed here from the window counts' columns."""
    cols = np.asarray(wts, np.int64)
    cols = cols.reshape(-1, cols.shape[-1]).sum(0)
    return sum(int(x) << (c * i) for i, x in enumerate(cols)) % R_MOD


# -- scalar products and adds ----------------------------------------------

@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mul_and_add_match_host_curve_on_random_points(curve, seed):
    _, mul, add, neg, zero = CURVES[curve]
    rng = random.Random(seed)
    P = point(curve, rng.randrange(1, R_MOD))
    Q = point(curve, rng.randrange(1, R_MOD))
    k = rng.randrange(2 ** 256)
    assert native.mul(curve, P, k) == mul(P, k)
    assert native.add(curve, P, Q) == add(P, Q)
    assert native.add(curve, P, P) == add(P, P)
    assert native.add(curve, P, neg(P)) == zero == add(P, neg(P))
    assert native.add(curve, P, zero) == P
    assert native.add(curve, zero, Q) == Q
    assert native.add(curve, zero, zero) == zero


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("k", EDGE_SCALARS)
def test_mul_edge_scalars(curve, k):
    _, mul, _, _, zero = CURVES[curve]
    P = point(curve, 5)
    assert native.mul(curve, P, k) == mul(P, k)
    assert native.mul(curve, zero, k) == zero


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_products_are_counted(curve):
    before = native.muls()
    native.mul(curve, point(curve, 3), 7)
    native.add(curve, point(curve, 3), point(curve, 4))
    native.msub(curve, point(curve, 3), point(curve, 4), 0)
    assert native.muls() - before == 2


# -- the card's limbs and the unblinding -----------------------------------

@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("case", ["random", "infinity", "unreduced"])
def test_card_limbs_match_jacobian_to_host(curve, case):
    """native.unblind with m = 0 is tcurve's conversion, a point at
    infinity (Z = 0) and coordinates at or above q (every value below
    2^256 is read) included; with m it is that point less m * R."""
    rng = random.Random(case)
    _, mul, add, neg, zero = CURVES[curve]
    P = zero if case == "infinity" else point(curve, rng.randrange(R_MOD))
    jac = card_jacobian(curve, P, z_value(curve, rng))
    if case == "unreduced":     # X's every Fq part moved by q
        X = tf.limbs_to_ints(jac[0].view(np.uint32))
        X = [x + Q_MOD if x + Q_MOD < 2 ** 256 else x for x in X]
        jac = (tf.ints_to_limbs(X).view(np.int32).reshape(jac[0].shape),
               ) + jac[1:]
    conv = tc.g1_jacobian_to_host if curve == "g1" else \
        tc.g2_jacobian_to_host
    want = conv(tuple(v[None] for v in jac))[0]
    assert want == P
    R = point(curve, rng.randrange(1, R_MOD))
    assert native.unblind(curve, jac, R, 0) == want
    m = rng.randrange(R_MOD)
    assert native.unblind(curve, jac, R, m) == add(want, neg(mul(R, m)))


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("rows", [0, 1, 3])
def test_unblind_msm_and_result(curve, rows):
    """unblind_msm and unblind_result against host_curve: window counts
    all zero (m = 0), (W,), and (k, W) stacked as a sharded MSM's."""
    _, mul, add, neg, _ = CURVES[curve]
    rng = np.random.default_rng(rows)
    wts = (np.zeros(W, np.int64) if rows == 0 else
           rng.integers(0, 1 << 20, (rows, W), dtype=np.int64))
    wts = wts[0] if rows == 1 else wts
    P, R = point(curve, 11), point(curve, 13)
    m = hc_surplus(wts, C)
    assert (m == 0) == (rows == 0)
    assert pp.surplus(wts, C) == m
    want = add(P, neg(mul(R, m)))
    assert pp.unblind_msm(curve, P, wts, R, C) == want
    jac = card_jacobian(curve, P, z_value(curve, random.Random(rows)))
    assert pp.unblind_result(curve, jac + (wts,), R, C) == want


# -- A, B and C -------------------------------------------------------------

def hc_combine(consts, c, msms, R1, R2, r, s):
    """The proof's host half in host_curve's group law: each MSM through
    tcurve's conversion less its surplus, then A, B and C."""
    alpha_g1, beta_g1, beta_g2, delta_g1, delta_g2 = consts

    def unblind(curve, res, R):
        conv = tc.g1_jacobian_to_host if curve == "g1" else \
            tc.g2_jacobian_to_host
        _, mul, add, neg, _ = CURVES[curve]
        pt = conv(tuple(v[None] for v in res[:3]))[0]
        return add(pt, neg(mul(R, hc_surplus(res[3], c))))

    At, Bt2, Bt1, Ht, Lt = msms
    At_h, Bt1_h, Ht_h, Lt_h = (unblind("g1", m, R1)
                               for m in (At, Bt1, Ht, Lt))
    Bt2_h = unblind("g2", Bt2, R2)
    g1_A = HC.g1_add(HC.g1_add(alpha_g1, At_h), HC.g1_mul(delta_g1, r))
    g1_B = HC.g1_add(HC.g1_add(beta_g1, Bt1_h), HC.g1_mul(delta_g1, s))
    g2_B = HC.g2_add(HC.g2_add(beta_g2, Bt2_h), HC.g2_mul(delta_g2, s))
    g1_C = HC.g1_add(
        HC.g1_add(HC.g1_add(Ht_h, Lt_h), HC.g1_mul(g1_A, s)),
        HC.g1_add(HC.g1_mul(g1_B, r),
                  HC.g1_neg(HC.g1_mul(delta_g1, r * s % R_MOD))))
    return g1_A, g2_B, g1_C


@pytest.mark.parametrize("case", ["random", "zero_rs", "infinity_terms",
                                  "stacked"])
def test_combine_matches_host_curve(case):
    """_combine's A, B and C equal host_curve's formula at fixed (r, s):
    random terms, r = s = 0, MSM results at infinity with no surplus, and
    a mesh's (k, W) stacked counts."""
    rng = random.Random(case)
    nrng = np.random.default_rng(len(case))
    consts = (point("g1", 3), point("g1", 5), point("g2", 5),
              point("g1", 7), point("g2", 7))
    R1, R2 = point("g1", rng.randrange(1, R_MOD)), \
        point("g2", rng.randrange(1, R_MOD))
    r, s = (0, 0) if case == "zero_rs" else \
        (rng.randrange(R_MOD), rng.randrange(R_MOD))
    msms = []
    for curve in ("g1", "g2", "g1", "g1", "g1"):
        if case == "infinity_terms":
            P = CURVES[curve][4]
            wts = np.zeros(W, np.int64)
        else:
            P = point(curve, rng.randrange(R_MOD))
            shape = (3, W) if case == "stacked" else (W,)
            wts = nrng.integers(0, 1 << 16, shape, dtype=np.int64)
        msms.append(card_jacobian(curve, P, z_value(curve, rng)) + (wts,))
    msms = tuple(msms)
    want = hc_combine(consts, C, msms, R1, R2, r, s)
    before = native.muls()
    proof = gp._combine(consts, C, msms, R1, R2, r, s)
    assert native.muls() - before == 11
    assert (proof.a, proof.b, proof.c) == want


# -- a whole proof -----------------------------------------------------------

def test_prove_uses_only_the_native_group_law(monkeypatch):
    """Prover.prove on the CPU with host_curve's scalar products raising:
    the proof verifies, equals host_curve's formula on the same MSM
    results and blinds at its fixed (r, s), and its spans count 2, 5 and
    6 native products; prove_batch's spans count the same (its combine
    on the combine thread) and its proof is the same."""
    w = 7654321
    pb = toy_circuit(w * w % R_MOD, w)
    inst = (pb.primary_input(), pb.auxiliary_input())
    toxic = iter([3, 5, 7, 11, 13])
    pk, vk = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    prover = gp.Prover(keys.build_device_pk(pk), "cpu", lanes=8, window=4)
    combine, calls = gp._combine, []

    def recorded(*args):
        calls.append(args)
        return combine(*args)

    def forbidden(*args):
        raise AssertionError("host_curve scalar product on the proof's path")

    def muls(recorded_spans, names):
        return {sp.name: sp.info for sp in recorded_spans
                if sp.name in names}

    r, s = 1234567, 7654321
    spans.disable()
    spans.drain()
    spans.enable()
    try:
        with monkeypatch.context() as mp:
            mp.setattr(HC, "g1_mul", forbidden)
            mp.setattr(HC, "g2_mul", forbidden)
            mp.setattr(gp, "_combine", recorded)
            proof = prover.prove(*inst, r=r, s=s)
            proved = spans.drain()
            batch = prover.prove_batch([inst], rs=[r], ss=[s])
            batched = spans.drain()
    finally:
        spans.disable()
        spans.drain()
        prover.close()
    assert muls(proved, ("prover.blinds", "prover.unblind",
                         "prover.group")) == {
        "prover.blinds": {"muls": 2}, "prover.unblind": {"muls": 5},
        "prover.group": {"muls": 6}}
    assert muls(batched, ("prover.blinds", "prover.unblind",
                          "prover.group")) == {
        "prover.blinds": {"muls": 2}, "prover.unblind": {"muls": 5},
        "prover.group": {"muls": 6}}
    assert batch == [proof]
    assert verifier.verify(vk, pb.primary_input(), proof)
    assert len(calls) == 2
    for args in calls:
        assert args[-2:] == (r, s)
        assert (proof.a, proof.b, proof.c) == hc_combine(*args)

"""blockmaze_tpu_torch point ops (the plain versions behind the add,
double, mixed_add and mixed_add_noexc kernels) against the jcurve functions
the JAX package's Pallas kernels wrap: the Jacobian triples must be equal
bit for bit, including infinity, P = Q and P = -Q lanes. Also the host
conversions against jcurve's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.curves import host_curve as HC
from blockmaze_tpu.curves import jcurve as jc
from blockmaze_tpu_torch.curves import pcurve as pc
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

N = 16


def _rand_coords(curve, rng, n):
    """Canonical random Fq limbs (n, 16) or (n, 2, 16)."""
    p = tf.FQ.modulus
    k = n if curve == "g1" else 2 * n
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(k)]
    a = tf.ints_to_limbs(vals)
    return a if curve == "g1" else a.reshape(n, 2, 16)


def _neg(curve, y):
    neg = tf.neg(tf.FQ, torch.from_numpy(y.astype(np.int64))).numpy()
    return neg.astype(np.uint32)


def _case(curve, seed):
    """P, Q Jacobian and an affine Q with edge lanes: 0-1 P infinite, 2-3 Q
    infinite, 4-5 both, 6-7 Q = P, 8-9 Q = -P."""
    rng = np.random.default_rng(seed)
    P = [_rand_coords(curve, rng, N) for _ in range(3)]
    Q = [_rand_coords(curve, rng, N) for _ in range(3)]
    P[2][0:2] = 0
    Q[2][2:4] = 0
    P[2][4:6] = 0
    Q[2][4:6] = 0
    for k in range(3):
        Q[k][6:10] = P[k][6:10]
    Q[1][8:10] = _neg(curve, P[1][8:10])
    # mixed add: P with Z = 1 on lanes 6-9 so that (Qx, Qy) = (X, +-Y)
    one = tf.FQ.one_mont if curve == "g1" else np.stack(
        [tf.FQ.one_mont, np.zeros(16, np.uint32)])
    Pm = [x.copy() for x in P]
    Pm[2][6:10] = one
    qinf = np.zeros(N, bool)
    qinf[[0, 2, 11]] = True
    return P, Q, Pm, Q[0].copy(), Q[1].copy(), qinf


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(bool if a.dtype == bool else np.int32))


def _j(a):
    return jnp.asarray(a)


def _eq(got, want):
    return all(np.array_equal(np.asarray(g).astype(np.int64),
                              np.asarray(w).astype(np.int64))
               for g, w in zip(got, want))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_ops_match_jcurve(curve):
    F = jc.FqOps if curve == "g1" else jc.Fq2Ops
    P, Q, Pm, Qx, Qy, qinf = _case(curve, 1 if curve == "g1" else 2)
    tP, tQ, tPm = (tuple(_t(x) for x in v) for v in (P, Q, Pm))
    jP, jQ, jPm = (tuple(_j(x) for x in v) for v in (P, Q, Pm))
    assert _eq(pc.add(curve, tP, tQ), jc.point_add(F, jP, jQ))
    assert _eq(pc.double(curve, tP), jc.point_double(F, jP))
    assert _eq(pc.mixed_add(curve, tPm, _t(Qx), _t(Qy), _t(qinf)),
               jc.point_mixed_add(F, jPm, _j(Qx), _j(Qy), _j(qinf)))
    assert _eq(pc.mixed_add_noexc(curve, tPm, _t(Qx), _t(Qy), _t(qinf)),
               jc.point_mixed_add_noexc(F, jPm, _j(Qx), _j(Qy), _j(qinf)))


def test_group_law_on_real_points():
    """add/double/mixed_add agree with the host affine oracle on points of
    the curve, including Q = P (doubling) and Q = -P (infinity)."""
    rng = np.random.default_rng(3)
    g = HC.g1_generator()
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(6)]
    A = [HC.g1_mul(g, k) for k in ks]
    B = [HC.g1_mul(g, k + 5) for k in ks]
    B[1] = A[1]
    B[2] = HC.g1_neg(A[2])
    B[3] = HC.G1_ZERO
    ax, ay, _ = tc.g1_affine_to_device(A)
    bx, by, binf = tc.g1_affine_to_device(B)
    one = np.broadcast_to(tf.FQ.one_mont, ax.shape)
    PA = (_t(ax), _t(ay), _t(one))
    PB = (_t(bx), _t(by), _t(np.where(binf[:, None], 0, one)))
    want = [HC.g1_add(a, b) for a, b in zip(A, B)]
    assert tc.g1_jacobian_to_host(pc.add("g1", PA, PB)) == want
    assert tc.g1_jacobian_to_host(
        pc.mixed_add("g1", PA, _t(bx), _t(by), _t(binf))) == want
    assert tc.g1_jacobian_to_host(pc.double("g1", PA)) == \
        [HC.g1_add(a, a) for a in A]


def test_host_conversions_match_jcurve():
    rng = np.random.default_rng(4)
    g1, g2 = HC.g1_generator(), HC.g2_generator()
    p1 = [HC.g1_mul(g1, int(rng.integers(1, 1 << 62)) * 977) for _ in range(5)]
    p1.append(HC.G1_ZERO)
    p2 = [HC.g2_mul(g2, int(rng.integers(1, 1 << 62)) * 983) for _ in range(3)]
    p2.append(HC.G2_ZERO)
    for got, want in ((tc.g1_affine_to_device(p1), jc.g1_affine_to_device(p1)),
                      (tc.g2_affine_to_device(p2), jc.g2_affine_to_device(p2))):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    # Jacobian -> host with random Z (and one Z = 0 lane)
    P = [_rand_coords("g1", rng, 6) for _ in range(3)]
    P[2][3] = 0
    assert tc.g1_jacobian_to_host(tuple(_t(x) for x in P)) == \
        jc.g1_jacobian_to_host(tuple(P))
    P2 = [_rand_coords("g2", rng, 4) for _ in range(3)]
    P2[2][1] = 0
    assert tc.g2_jacobian_to_host(tuple(_t(x) for x in P2)) == \
        jc.g2_jacobian_to_host(tuple(P2))


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain path only for CPU tensors: a tensor on any
    other device (here the meta device) raises instead of falling back."""
    z = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pc.double("g1", (z, z, z))

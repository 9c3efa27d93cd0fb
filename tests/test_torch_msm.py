"""blockmaze_tpu_torch Pippenger MSM (plain versions of the msm_round,
add, double and msm_fold kernels) against the host oracle, against the JAX
package's MSM, and its accumulation step against the JAX round loop
(_item_step). Window c = 8, lanes <= 64. The cases are those of
tests/test_msm.py: G1 and G2, blinded and not, duplicate points in one
bucket, every scalar equal, zero scalars and infinity points."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.curves import host_curve as HC
from blockmaze_tpu.curves import jcurve as jc
from blockmaze_tpu.fields.constants import R_MOD
from blockmaze_tpu.msm import pippenger as jpp
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.msm import pippenger as pp

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

C = 8


def host_msm(curve, pts, scalars):
    add, mul = ((HC.g1_add, HC.g1_mul) if curve == "g1"
                else (HC.g2_add, HC.g2_mul))
    acc = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    for p, k in zip(pts, scalars):
        acc = add(acc, mul(p, k))
    return acc


def make_points(curve, rng, n):
    g = HC.g1_generator() if curve == "g1" else HC.g2_generator()
    mul = HC.g1_mul if curve == "g1" else HC.g2_mul
    return [mul(g, rng.randrange(1, R_MOD)) for _ in range(n)]


def to_tensors(curve, pts, scalars):
    conv = tc.g1_affine_to_device if curve == "g1" else tc.g2_affine_to_device
    x, y, inf = conv(pts)
    return ((tf.to_tensor(x, "cpu"), tf.to_tensor(y, "cpu"),
             torch.from_numpy(inf)),
            tf.to_tensor(tf.ints_to_limbs(scalars), "cpu"))


def run_msm(curve, pts, scalars, lanes, blind):
    P, S = to_tensors(curve, pts, scalars)
    to_host = tc.g1_jacobian_to_host if curve == "g1" \
        else tc.g2_jacobian_to_host
    if not blind:
        res = pp.msm(curve, P, S, C, lanes)
        return to_host(tuple(r[None] for r in res))[0]
    R, blind = pp.make_blind(curve, "cpu")
    res = pp.msm(curve, P, S, C, lanes, blind=blind)
    assert len(res) == 4
    got = to_host(tuple(r[None] for r in res[:3]))[0]
    return pp.unblind_msm(curve, got, res[3].numpy(), R, C)


def g1_case(rng):
    n = 33
    pts = make_points("g1", rng, n)
    pts[4] = pts[7] = pts[9]          # duplicates sharing buckets
    pts[2] = HC.G1_ZERO               # infinity base point
    scalars = [rng.randrange(R_MOD) for _ in range(n)]
    scalars[0] = 0
    scalars[1] = 1
    scalars[3] = R_MOD - 1
    scalars[4] = scalars[7] = scalars[9]
    return pts, scalars


@pytest.mark.parametrize("blind,lanes", [(False, 4), (True, 64)],
                         ids=["plain-lanes4", "blinded-lanes64"])
def test_msm_g1(blind, lanes):
    pts, scalars = g1_case(random.Random(0xB10C))
    assert run_msm("g1", pts, scalars, lanes, blind) == \
        host_msm("g1", pts, scalars)


@pytest.mark.parametrize("blind", [False, True], ids=["plain", "blinded"])
def test_msm_g1_all_same_bucket(blind):
    """Every scalar equal: one run of equal keys spans many lanes."""
    rng = random.Random(5)
    pts = make_points("g1", rng, 33)
    scalars = [5] * 33
    assert run_msm("g1", pts, scalars, 4, blind) == \
        host_msm("g1", pts, scalars)


@pytest.mark.parametrize("blind", [False, True], ids=["plain", "blinded"])
def test_msm_g2(blind):
    rng = random.Random(7)
    pts = make_points("g2", rng, 16)
    pts[5] = HC.G2_ZERO
    scalars = [rng.randrange(R_MOD) for _ in range(16)]
    scalars[1] = 0
    assert run_msm("g2", pts, scalars, 4, blind) == \
        host_msm("g2", pts, scalars)


def test_msm_matches_jax_msm_auto():
    """Against the JAX package's MSM on the CPU (msm_auto: the compact
    double-and-add there), compared after normalisation."""
    pts, scalars = g1_case(random.Random(11))
    P, S = to_tensors("g1", pts, scalars)
    jP = (jnp.asarray(P[0].numpy().astype(np.uint32)),
          jnp.asarray(P[1].numpy().astype(np.uint32)), jnp.asarray(P[2].numpy()))
    jres = jpp.msm_auto("g1", jP,
                        jnp.asarray(S.numpy().astype(np.uint32)), c=C)
    want = jc.g1_jacobian_to_host(tuple(np.asarray(r)[None] for r in jres))[0]
    got = tc.g1_jacobian_to_host(
        tuple(r[None] for r in pp.msm("g1", P, S, C, 16)))[0]
    assert got == want


@pytest.mark.parametrize("curve,blind", [("g1", True), ("g2", False)])
def test_stream_and_accumulation_match_jax_rounds(curve, blind):
    """stream_keys equals the JAX package's (same stable per-window sort),
    and the accumulation's acc/meta/head/buckets equal what one JAX round
    (_xla_round over _item_step) leaves, scattered into the buckets."""
    rng = random.Random(13)
    n, T = 12, 8
    pts = make_points(curve, rng, n)
    pts[3] = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    scalars = [rng.randrange(R_MOD) for _ in range(n)]
    scalars[2] = scalars[5]
    P, S = to_tensors(curve, pts, scalars)
    keys, pids, drop = pp.stream_keys(P, S, C)
    jP = tuple(jnp.asarray(t.numpy()) for t in P)
    _, jkeys, jpids, jdrop = jpp.stream_keys(
        curve, (jP[0].astype(jnp.uint32), jP[1].astype(jnp.uint32), jP[2]),
        jnp.asarray(S.numpy().astype(np.uint32)), C)
    assert int(jdrop) == drop
    assert np.array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    assert np.array_equal(pids.numpy(), np.asarray(jpids))

    total = keys.shape[0]
    L = -(-total // T)
    pad = T * L - total
    keys = torch.cat([keys, torch.full((pad,), drop, dtype=torch.int32)])
    pids = torch.cat([pids, torch.zeros(pad, dtype=torch.int32)])
    tail = tc.coord_tail(curve)
    if blind:
        _, bl = pp.make_blind(curve, "cpu")
        bx, by = (t.numpy().astype(np.uint32) for t in bl)
    else:
        bx = by = np.zeros(tail, np.uint32)
        bl = None
    acc, meta, head, bkt, cnt = pp.accumulate_plain(
        curve, keys, pids, P, bl, T, L, drop)

    # the same stream through one JAX round of K = L items per lane
    def major(a):  # (T, ...) -> limb-major (16, T) / (2, 16, T)
        return jnp.asarray(np.moveaxis(np.asarray(a), 0, -1))

    cw = 16 if curve == "g1" else 32
    packed = np.concatenate([P[0].numpy().reshape(n, cw),
                             P[1].numpy().reshape(n, cw),
                             P[2].numpy().astype(np.int32)[:, None]], 1)
    keys_r = keys.numpy().reshape(T, L).T.astype(np.uint32)
    rows = packed[pids.numpy().reshape(T, L).T]             # (L, T, CW)
    rows = jnp.asarray(np.swapaxes(rows, 1, 2).astype(np.uint32))
    zero = np.zeros((T,) + tail, np.uint32)
    one = np.broadcast_to(np.asarray(
        tc.ops(curve).one_like(torch.zeros(tail, dtype=torch.int64))),
        zero.shape).astype(np.uint32)
    if blind:
        acc0 = (np.broadcast_to(bx, zero.shape), np.broadcast_to(by, zero.shape),
                one)
    else:
        acc0 = (zero, one, zero)
    meta0 = np.stack([keys_r[0], np.full(T, drop, np.uint32),
                      np.zeros(T, np.uint32)])
    jacc, jmeta, jhead, fkeys, fpacks = jpp._xla_round(
        curve, blind, drop, L, 3 * cw + 1, jnp.asarray(keys_r), rows,
        tuple(major(a) for a in acc0), jnp.asarray(meta0),
        tuple(major(a) for a in (zero, one, zero)),
        jnp.asarray(np.asarray(bx, np.uint32).reshape(tail[:-1] + (16, 1))),
        jnp.asarray(np.asarray(by, np.uint32).reshape(tail[:-1] + (16, 1))))

    def minor(a):
        return np.moveaxis(np.asarray(a), -1, 0).astype(np.int64)

    for got, want in zip(acc + head, tuple(jacc) + tuple(jhead)):
        assert np.array_equal(got.numpy(), minor(want))
    assert np.array_equal(meta.numpy(), np.asarray(jmeta).astype(np.int64))
    jb = np.zeros((drop, 3 * cw + 1), np.int64)
    fk = np.asarray(fkeys).reshape(-1)
    fp = np.swapaxes(np.asarray(fpacks), 1, 2).reshape(-1, 3 * cw + 1)
    live = fk < drop
    jb[fk[live]] = fp[live]
    for i, b in enumerate(bkt):
        assert np.array_equal(b.numpy().reshape(drop, cw),
                              jb[:, cw * i:cw * (i + 1)])
    assert np.array_equal(cnt.numpy(), jb[:, -1])

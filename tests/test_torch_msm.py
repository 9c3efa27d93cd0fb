"""blockmaze_tpu_torch Pippenger MSM (plain versions of the msm_round,
msm_combine, msm_triangle and msm_fold kernels) against the host oracle,
against the JAX package's MSM, and its accumulation step against the JAX
round loop (_item_step), on the JAX package's full stream and on the live
stream the MSM feeds it. Window c = 8, lanes <= 64. The cases are those of
tests/test_msm.py (G1 and G2, blinded and not, duplicate points in one
bucket, every scalar equal, zero scalars and infinity points) and those of
the live stream: bit scalars with more lanes than live items, no live item
at all, a single one."""

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


def jax_round_matches(curve, P, keys, pids, T, L, drop, blind):
    """accumulate_plain's acc/meta/head/buckets on the stream (keys, pids)
    cut into T lanes of L equal what one JAX round (_xla_round over
    _item_step, K = L items per lane) leaves, scattered into the buckets."""
    n = P[0].shape[0]
    tail = tc.coord_tail(curve)
    if blind:
        _, bl = pp.make_blind(curve, "cpu")
        bx, by = (t.numpy().astype(np.uint32) for t in bl)
    else:
        bx = by = np.zeros(tail, np.uint32)
        bl = None
    acc, meta, head, bkt, cnt = pp.accumulate_plain(
        curve, keys, pids, P, bl, T, L, drop)

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


def stream_case(curve):
    rng = random.Random(13)
    n = 12
    pts = make_points(curve, rng, n)
    pts[3] = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    scalars = [rng.randrange(R_MOD) for _ in range(n)]
    scalars[2] = scalars[5]
    scalars[7] = 0
    scalars[8] = 1
    return to_tensors(curve, pts, scalars)


@pytest.mark.parametrize("curve,blind", [("g1", True), ("g2", False)])
def test_stream_and_accumulation_match_jax_rounds(curve, blind):
    """stream_keys equals the JAX package's (each window's live items in
    digit order, then its dead ones), and the accumulation over that full
    stream equals one JAX round on it."""
    P, S = stream_case(curve)
    keys, pids, drop = pp.stream_keys(P, S, C)
    jP = tuple(jnp.asarray(t.numpy()) for t in P)
    _, jkeys, jpids, jdrop = jpp.stream_keys(
        curve, (jP[0].astype(jnp.uint32), jP[1].astype(jnp.uint32), jP[2]),
        jnp.asarray(S.numpy().astype(np.uint32)), C)
    assert int(jdrop) == drop
    assert np.array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    assert np.array_equal(pids.numpy(), np.asarray(jpids))
    T = 8
    L = -(-keys.shape[0] // T)
    keys, pids = pp.pad_stream(keys, pids, drop, T, L)
    jax_round_matches(curve, P, keys, pids, T, L, drop, blind)


@pytest.mark.parametrize("lanes,min_items", [(3, 1), (512, 1), (64, 4)],
                         ids=["lanes3", "lanes-over-live", "min-items4"])
@pytest.mark.parametrize("curve,blind", [("g1", True), ("g2", False)])
def test_live_stream_accumulation_matches_jax_rounds(curve, blind, lanes,
                                                     min_items):
    """The live stream is the JAX stream's live items in the same order
    (keys < DROP, finite points), and the accumulation over it, cut and
    padded as msm cuts it, equals one JAX round on the same stream."""
    P, S = stream_case(curve)
    keys, pids, drop = pp.live_stream(P, S, C)
    fk, fp, _ = pp.stream_keys(P, S, C)
    keep = (fk < drop) & ~P[2][fp.long()]
    assert torch.equal(keys, fk[keep]) and torch.equal(pids, fp[keep])
    assert int((keys >= drop).sum()) == 0
    T, L = pp.lane_cut(keys.shape[0], lanes, min_items)
    assert T <= lanes and L == -(-keys.shape[0] // T)
    keys, pids = pp.pad_stream(keys, pids, drop, T, L)
    jax_round_matches(curve, P, keys, pids, T, L, drop, blind)


def live_case(curve, case, rng):
    """(points, scalars) whose live stream is mint-like (bit scalars), empty
    (all scalars 0, or all points at infinity) or a single item."""
    n = 10
    zero = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    pts = make_points(curve, rng, n)
    if case == "bits":
        scalars = [rng.randrange(2) for _ in range(n)]
        scalars[0] = scalars[4] = 1
        pts[2] = zero
    elif case == "zero-scalars":
        scalars = [0] * n
    elif case == "infinite-points":
        pts = [zero] * n
        scalars = [rng.randrange(R_MOD) for _ in range(n)]
    else:                       # one live (window, point) pair
        scalars = [0] * n
        scalars[6] = 77
    return pts, scalars


@pytest.mark.parametrize("blind", [False, True], ids=["plain", "blinded"])
@pytest.mark.parametrize("case", ["bits", "zero-scalars", "infinite-points",
                                  "single"])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_live_stream_msm(curve, case, blind):
    """The MSM over the live stream equals the host oracle; with no live
    item it is infinity with every window count 0. The lane cap (64) is
    above the live count, so the cut is the live count's own."""
    pts, scalars = live_case(curve, case, random.Random(hash(case) & 0xff))
    P, S = to_tensors(curve, pts, scalars)
    live = pp.live_stream(P, S, C)[0].shape[0]
    assert (live == 0) == (case in ("zero-scalars", "infinite-points"))
    assert (live == 1) == (case == "single")
    assert run_msm(curve, pts, scalars, 64, blind) == \
        host_msm(curve, pts, scalars)
    if blind and live == 0:
        _, bl = pp.make_blind(curve, "cpu")
        assert int(pp.msm(curve, P, S, C, 64, blind=bl)[3].abs().sum()) == 0


def test_lane_cut():
    """T = min(lanes, ceil(live / min_items)), L = ceil(live / T)."""
    assert pp.lane_cut(1, 64, 8) == (1, 1)
    assert pp.lane_cut(86000, 32768, 8) == (10750, 8)
    assert pp.lane_cut(4270000, 32768, 8) == (32768, 131)
    assert pp.lane_cut(5, 64, 1) == (5, 1)


# ---------------------------------------------------------------------------
# The bucket reduction (plain versions of msm_combine, msm_triangle and
# msm_fold) at block, chunk and thread sizes small enough to reach every
# branch, against the host oracle
# ---------------------------------------------------------------------------

def jac_tensors(curve, pts):
    """Host affine points as Jacobian int32 tensors (Z = 1, infinity as the
    port builds it: (0, 1, 0))."""
    x, y, inf = to_tensors(curve, pts, [0] * len(pts))[0]
    one = tc.ops(curve).one_like(x.to(torch.int64)).to(torch.int32)
    z = torch.where((~inf).reshape((-1,) + (1,) * (x.dim() - 1)), one,
                    torch.zeros_like(one))
    y = torch.where(inf.reshape((-1,) + (1,) * (x.dim() - 1)), one, y)
    return (x, y, z)


def to_host(curve, P):
    conv = tc.g1_jacobian_to_host if curve == "g1" else tc.g2_jacobian_to_host
    return conv(tuple(t.to(torch.int64) for t in P))


def host_sum(curve, pts):
    add = HC.g1_add if curve == "g1" else HC.g2_add
    acc = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    for p in pts:
        acc = add(acc, p)
    return acc


def combine_case(curve, case, rng):
    """(keys, host points, counts) of key-sorted partials, dead key 16."""
    zero = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    if case == "spans-blocks":      # key 2: 9 partials over 3-4 blocks
        keys = [1] * 3 + [2] * 9 + [3] + [4] * 5 + [16] * 2
        pts = make_points(curve, rng, len(keys))
        pts[4] = zero
    elif case == "covers-block":    # keys 1, 2, 3 each one 4-item block
        keys = [1] * 4 + [2] * 4 + [3] * 4 + [4] * 2 + [5] * 6
        pts = make_points(curve, rng, len(keys))
    else:                           # equal sums: every merge of key 3 and
        P, Q, R, S = make_points(curve, rng, 4)     # the last of key 1
        keys = [1] * 4 + [2] * 2 + [3] * 8 + [16]   # doubles
        pts = [P, Q, P, Q, R, R] + [S] * 8 + [zero]
    cnt = [rng.randrange(2) for _ in keys]
    return keys, pts, cnt


@pytest.mark.parametrize("threads", [2, 4, 8])
@pytest.mark.parametrize("case", ["spans-blocks", "covers-block",
                                  "equal-sums"])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_combine_plain_reduces_runs(curve, case, threads):
    """Every run of equal keys < drop lands in its bucket as the sum of its
    partials, with the summed blind count, whatever the block size (4, 8 or
    16 partials: several passes or one, runs over many blocks or one)."""
    rng = random.Random(hash((curve, case)) & 0xffff)
    keys, pts, cnt = combine_case(curve, case, rng)
    drop = 16
    tail = tc.coord_tail(curve)
    bkt = tuple(torch.zeros((drop,) + tail, dtype=torch.int32)
                for _ in range(3))
    bcnt = torch.zeros(drop, dtype=torch.int64)
    pp.combine_plain(curve, torch.tensor(keys, dtype=torch.int32),
                     jac_tensors(curve, pts),
                     torch.tensor(cnt, dtype=torch.int64), bkt, bcnt, drop,
                     threads)
    got = to_host(curve, bkt)
    for k in range(drop):
        idx = [i for i, kk in enumerate(keys) if kk == k]
        if not idx:
            assert all(int(b[k].abs().sum()) == 0 for b in bkt), k
            continue
        assert got[k] == host_sum(curve, [pts[i] for i in idx]), k
        assert int(bcnt[k]) == sum(cnt[i] for i in idx), k


@pytest.mark.parametrize("chunk", [1, 2, 4, 16])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_triangle_plain_is_weighted_bucket_sum(curve, chunk):
    """win_w = sum_d d * S_{w,d} for every chunk size (16: one leaf a
    window; 1: a full tree), with empty buckets under full ones (the
    running sum's add then doubles) and bucket 0 ignored."""
    rng = random.Random(chunk)
    W, nb = 2, 16
    zero = HC.G1_ZERO if curve == "g1" else HC.G2_ZERO
    pts = make_points(curve, rng, W * nb)
    for i in (3, 4, 9, 15, 16, 17, 30):
        pts[i] = zero
    pts[12] = pts[13]
    bkt = jac_tensors(curve, pts)
    got = to_host(curve, pp.triangle_plain(curve, bkt, W, nb, chunk))
    mul = HC.g1_mul if curve == "g1" else HC.g2_mul
    for w in range(W):
        want = host_sum(curve, [mul(pts[w * nb + d], d)
                                for d in range(1, nb)])
        assert got[w] == want, w


def reduce_small(curve, pts, scalars, lanes, blind, threads, chunk):
    """msm's steps with the plain combine and triangle at explicit block and
    chunk sizes; returns (host point, blinded wts or None, counts)."""
    P, S = to_tensors(curve, pts, scalars)
    W, nb = pp.n_windows(C), 1 << C
    keys, pids, drop = pp.live_stream(P, S, C)
    T, L = pp.lane_cut(keys.shape[0], lanes, 2)
    keys, pids = pp.pad_stream(keys, pids, drop, T, L)
    R, bl = pp.make_blind(curve, "cpu") if blind else (None, None)
    acc, meta, head, bkt, cnt = pp.accumulate_plain(curve, keys, pids, P, bl,
                                                    T, L, drop)
    cnt = cnt.to(torch.int64)
    pp.combine_plain(curve, *pp.boundary_partials(curve, acc, meta, head),
                     bkt, cnt, drop, threads)
    res = pp.fold_plain(curve, C, pp.triangle_plain(curve, bkt, W, nb, chunk))
    got = to_host(curve, tuple(r[None] for r in res))[0]
    if not blind:
        return got, None, cnt
    wts = pp.window_counts(cnt, W, nb)
    return pp.unblind_msm(curve, got, wts.numpy(), R, C), wts, cnt


@pytest.mark.parametrize("blind", [False, True], ids=["plain", "blinded"])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_msm_reduction_small_blocks(curve, blind):
    """Bits as scalars (as the mint witness's SHA-256 wires are), on the
    live stream at 2 items a lane: window 0's bucket 1 is one run over
    many lanes and, at 4 partials a block, many
    combine blocks; equal points put equal sums in one bucket. The MSM
    equals the host oracle after unblinding, and wts equals the JAX
    package's integer mirror of the same bucket counts."""
    rng = random.Random(21 if curve == "g1" else 22)
    n = 24 if curve == "g1" else 12
    pts = make_points(curve, rng, n)
    pts[3] = pts[5]
    scalars = [rng.randrange(2) for _ in range(n)]
    scalars[3] = scalars[5] = 1
    scalars[-1] = rng.randrange(R_MOD)
    got, wts, cnt = reduce_small(curve, pts, scalars, 8, blind, 2, 2)
    assert got == host_msm(curve, pts, scalars)
    if blind:
        cw = jnp.asarray(cnt.numpy().reshape(pp.n_windows(C), 1 << C)[:, 1:])
        csuf = jnp.cumsum(cw[:, ::-1], axis=1)[:, ::-1]
        want = np.asarray(jnp.sum(csuf, axis=1).astype(jnp.uint32))
        assert np.array_equal(wts.numpy(), want.astype(np.int64))

"""Pippenger multi-scalar multiplication on torch tensors.

Port of blockmaze_tpu/msm/pippenger.py `msm` (the sort-first formulation):

  1. stream_keys: one c-bit digit per scalar and window; per-window stable
     sort of (window, digit) keys, zero digits and infinity points sent past
     the live buckets (key DROP);
  2. accumulate: the sorted stream cut into T contiguous lane ranges; each
     lane sums its runs of equal keys with mixed adds, flushing every run
     that starts and ends inside the lane straight into its bucket
     (kernel msm_round, csrc/pippenger.cu);
  3. boundary combine: each lane's head and tail partial sums, still in key
     order, merged by a flag-based segmented Hillis-Steele scan of point
     adds (kernel add) and written into their buckets;
  4. per window, the weighted-pair triangle tree sum_d d*S_d (kernels add
     and double), then the Horner fold over windows (kernel msm_fold).

With a blind (Rx, Ry), every run starts from R instead of infinity, the
stream uses the exception-free mixed add, and the surplus multiples of R
are counted exactly (integer bucket counts through steps 3-4) and
subtracted on the host by unblind_msm. Points are (X, Y, inf) affine int32
Montgomery tensors, scalars (n, 16) standard-form limbs.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from blockmaze_tpu.curves import host_curve as HC
from blockmaze_tpu.fields.constants import R_MOD
from ..curves import pcurve as pc
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..utils import kernels as kn

SCALAR_BITS = 254


def default_window(n: int) -> int:
    """pippenger.default_window: bucket-scan cost grows with 2^c,
    accumulation cost with 254/c."""
    if n < (1 << 12):
        return 8
    if n < (1 << 16):
        return 10
    if n < (1 << 19):
        return 12
    return 13


def n_windows(c: int) -> int:
    return -(-SCALAR_BITS // c)


def digits(scalars, c: int):
    """(W, n) int64 c-bit digits of (n, 16) standard-form limb scalars."""
    if not 1 <= c <= 16:
        raise ValueError(f"window {c} outside 1..16")
    s = scalars.to(torch.int64)
    out = []
    for w in range(n_windows(c)):
        li, off = divmod(w * c, 16)
        word = s[:, li]
        if li + 1 < 16:
            word = word | (s[:, li + 1] << 16)
        out.append((word >> off) & ((1 << c) - 1))
    return torch.stack(out)


def stream_keys(points, scalars, c: int):
    """Key-sorted item stream: (keys int32 (W*n,), point ids int32 (W*n,),
    DROP). Window-major then digit order, stable within a digit."""
    inf = points[2]
    d = digits(scalars, c)
    nb = 1 << c
    W = d.shape[0]
    drop = W * nb
    dead = (d == 0) | inf.to(torch.bool)[None, :]
    dsort = torch.where(dead, torch.full_like(d, nb), d)
    sdig, order = torch.sort(dsort, dim=1, stable=True)
    base = (torch.arange(W, device=d.device, dtype=torch.int64) * nb)[:, None]
    keys = torch.where(sdig < nb, sdig + base, torch.full_like(sdig, drop))
    return (keys.reshape(-1).to(torch.int32),
            order.reshape(-1).to(torch.int32), drop)


# ---------------------------------------------------------------------------
# Step 2: bucket accumulation (kernel msm_round)
# ---------------------------------------------------------------------------

def _zeros_pts(curve, batch, device):
    z = torch.zeros((batch,) + tc.coord_tail(curve), dtype=torch.int32,
                    device=device)
    return (z, tc.ops(curve).one_like(z).to(torch.int32), z.clone())


def accumulate_plain(curve, keys, pids, points, blind, T: int, L: int,
                     drop: int):
    """The JAX rounds (_item_step over every item, then the bucket scatter)
    as one loop over a lane's items, vectorised over the T lanes."""
    F = tc.ops(curve)
    X, Y, inf = points
    dev = X.device
    keys2 = keys.reshape(T, L).to(torch.int64)
    pids2 = pids.reshape(T, L).to(torch.int64)
    tail = tc.coord_tail(curve)
    zero = torch.zeros((T,) + tail, dtype=torch.int64, device=dev)
    one = F.one_like(zero)
    if blind is not None:
        init = (blind[0].to(torch.int64).expand(zero.shape),
                blind[1].to(torch.int64).expand(zero.shape), one)
    else:
        init = (zero, one, zero)
    acc = init
    head = (zero, one, zero)
    cur = keys2[:, 0]
    hk = torch.full_like(cur, drop)
    seen = torch.zeros(T, dtype=torch.bool, device=dev)
    bkt = [torch.zeros((drop,) + tail, dtype=torch.int64, device=dev)
           for _ in range(3)]
    cnt = torch.zeros(drop, dtype=torch.int32, device=dev)
    madd = tc.point_mixed_add_noexc if blind is not None \
        else tc.point_mixed_add
    for i in range(L):
        key, pid = keys2[:, i], pids2[:, i]
        is_new = key != cur
        flush = is_new & seen & (cur < drop)
        fk = cur[flush]
        for b, a in zip(bkt, acc):
            b[fk] = a[flush]
        cnt[fk] = 1
        new_head = is_new & ~seen
        hk = torch.where(new_head, cur, hk)
        head = tuple(F.select(new_head, a, h) for a, h in zip(acc, head))
        seen = seen | is_new
        acc = tuple(F.select(is_new, z, a) for z, a in zip(init, acc))
        q_inf = inf[pid].to(torch.bool) | (key >= drop)
        acc = madd(F, acc, X[pid], Y[pid], q_inf)
        cur = key
    meta = torch.stack([cur, hk, seen.to(torch.int64)]).to(torch.int32)
    i32 = lambda P: tuple(t.to(torch.int32) for t in P)
    return i32(acc), meta, i32(head), i32(bkt), cnt


def accumulate(curve, keys, pids, points, blind, T: int, L: int, drop: int):
    """Run the sorted stream (keys/pids (T*L,) int32, lane t owning
    [t*L, (t+1)*L)). Returns (acc, meta (3, T) = (cur_key, head_key, seen),
    head, buckets (drop, ...) x3, counts (drop,)) as int32."""
    X, Y, inf = points
    if kn.on_cpu(keys, pids, X, Y, inf):
        return accumulate_plain(curve, keys, pids, points, blind, T, L, drop)
    if keys.shape != (T * L,) or pids.shape != (T * L,):
        raise ValueError("accumulate: keys/pids must hold T*L items")
    tail = tc.coord_tail(curve)
    dev = X.device
    keys_t = keys.reshape(T, L).t().contiguous()
    pids_t = pids.reshape(T, L).t().contiguous()
    pinf = inf.to(torch.uint8).contiguous()
    if blind is not None:
        bx, by = (b.reshape(tail).to(torch.int32).contiguous() for b in blind)
    else:
        bx = by = torch.zeros(tail, dtype=torch.int32, device=dev)
    kn.check_cuda("msm_round", keys_t, pids_t, X, Y, pinf, bx, by)
    acc = [torch.empty((T,) + tail, dtype=torch.int32, device=dev)
           for _ in range(3)]
    head = [torch.empty_like(acc[0]) for _ in range(3)]
    meta = torch.empty((3, T), dtype=torch.int32, device=dev)
    bkt = [torch.zeros((drop,) + tail, dtype=torch.int32, device=dev)
           for _ in range(3)]
    cnt = torch.zeros(drop, dtype=torch.int32, device=dev)
    kn.K["msm_round"](
        kn.CURVE_ID[curve], int(blind is not None), keys_t, pids_t, X, Y,
        pinf, bx, by, drop, T, L, *acc, meta, *head, *bkt, cnt)
    return tuple(acc), meta, tuple(head), tuple(bkt), cnt


# ---------------------------------------------------------------------------
# Step 4b: Horner fold over windows (kernel msm_fold)
# ---------------------------------------------------------------------------

def fold_plain(curve, c: int, win):
    F = tc.ops(curve)
    W = win[0].shape[0]
    res = tuple(t[W - 1:W] for t in win)
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            res = tc.point_double(F, res)
        res = tc.point_add(F, res, tuple(t[w:w + 1] for t in win))
    return tuple(t[0].to(torch.int32) for t in res)


def fold(curve: str, c: int, win):
    """res = sum_w 2^{c*w} * win_w for (W, ...) Jacobian window sums."""
    if kn.on_cpu(*win):
        return fold_plain(curve, c, win)
    win = tuple(t.contiguous() for t in win)
    kn.check_cuda("msm_fold", *win)
    tail = tc.coord_tail(curve)
    out = [torch.empty(tail, dtype=torch.int32, device=win[0].device)
           for _ in range(3)]
    kn.K["msm_fold"](kn.CURVE_ID[curve], *win, win[0].shape[0], c, *out)
    return tuple(out)


# ---------------------------------------------------------------------------
# The MSM
# ---------------------------------------------------------------------------

def _select(curve, mask, a, b):
    return tuple(tc.ops(curve).select(mask, x, y) for x, y in zip(a, b))


def msm(curve: str, points, scalars, c: int, lanes: int, blind=None):
    """sum_i scalars_i * points_i as a Jacobian point (X, Y, Z) of int32
    coordinate tensors without batch axis; with blind=(Rx, Ry) the result
    is (X, Y, Z, wts) with wts the (W,) int64 per-window counts of R."""
    X, Y, inf = points
    dev = X.device
    n = X.shape[0]
    W = n_windows(c)
    nb = 1 << c
    keys, pids, drop = stream_keys(points, scalars, c)

    # ---- 2. accumulation over T lanes of L items ------------------------
    total = W * n
    T = max(1, min(lanes, total))
    L = -(-total // T)
    pad = T * L - total
    if pad:
        keys = torch.cat([keys, torch.full((pad,), drop, dtype=torch.int32,
                                           device=dev)])
        pids = torch.cat([pids, torch.zeros(pad, dtype=torch.int32,
                                            device=dev)])
    acc, meta, head, bkt, cnt = accumulate(curve, keys, pids, points, blind,
                                           T, L, drop)
    cur_key = meta[0].to(torch.int64)
    seen = meta[2] != 0
    head_key = torch.where(seen, meta[1].to(torch.int64), cur_key)

    # ---- 3. boundary combine (segmented scan of point adds) -------------
    head = _select(curve, seen, head, _zeros_pts(curve, T, dev))
    bkeys = torch.stack([head_key, cur_key], 1).reshape(-1)
    pts = tuple(torch.stack([h, a], 1).reshape((2 * T,) + h.shape[1:])
                for h, a in zip(head, acc))
    fl = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    bkeys[1:] != bkeys[:-1]])
    cn = torch.stack([seen.to(torch.int64),
                      torch.ones(T, dtype=torch.int64, device=dev)],
                     1).reshape(-1)
    pos = torch.arange(2 * T, device=dev)
    for i in range(max(1, (2 * T - 1).bit_length())):
        shift = 1 << i
        prev = tuple(torch.roll(p, shift, 0) for p in pts)
        valid = pos >= shift
        s = pc.add(curve, prev, pts)
        take = valid & ~fl
        pts = _select(curve, take, s, pts)
        cn = torch.where(take, torch.roll(cn, shift, 0) + cn, cn)
        fl = fl | (valid & torch.roll(fl, shift, 0))
    run_end = torch.cat([bkeys[:-1] != bkeys[1:],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    write = run_end & (bkeys < drop)
    widx = bkeys[write]
    for b, p in zip(bkt, pts):
        b[widx] = p[write]
    cnt = cnt.to(torch.int64)
    cnt[widx] = cn[write]

    # ---- 4. weighted-pair triangle tree, then the fold ------------------
    # Each node carries (s, t, w): s = sum of its block, t = blocksize*s,
    # w = sum (local index)*S. Combining two size-m blocks:
    #   w' = w_lo + w_hi + t_hi, t' = 2*(t_lo + t_hi), s' = s_lo + s_hi.
    # The root gives sum_j j*S_j over 0-based j; win = w + s rebases to
    # d = j + 1 (bucket 0 is dropped, the block is infinity-padded to 2^c).
    tail = tc.coord_tail(curve)
    zw = _zeros_pts(curve, W, dev)
    s = tuple(torch.cat([b.reshape((W, nb) + tail)[:, 1:], z[:, None]], 1)
              for b, z in zip(bkt, zw))
    t = s
    w = tuple(z[:, None].expand(p.shape).contiguous() for p, z in zip(s, zw))
    size = nb
    while size > 1:
        half = size // 2

        def sp(P, which):
            return tuple(x.reshape((W, half, 2) + tail)[:, :, which]
                         for x in P)

        t_hi = sp(t, 1)
        w = pc.add(curve, pc.add(curve, sp(w, 0), sp(w, 1)), t_hi)
        s_new = pc.add(curve, sp(s, 0), sp(s, 1))
        if half > 1:  # the root's t is never read
            t = pc.double(curve, pc.add(curve, sp(t, 0), t_hi))
        s = s_new
        size = half
    win = pc.add(curve, tuple(x[:, 0] for x in w), tuple(x[:, 0] for x in s))
    res = fold(curve, c, win)
    if blind is None:
        return res
    # the triangle's integer mirror: window w holds sum_j sum_{d>=j} cnt_d
    # surplus copies of R
    cw = cnt.reshape(W, nb)[:, 1:]
    wts = torch.flip(torch.cumsum(torch.flip(cw, [1]), 1), [1]).sum(1)
    return res + (wts,)


# ---------------------------------------------------------------------------
# Blinding (host)
# ---------------------------------------------------------------------------

def make_blind(curve: str, device):
    """Fresh random blind R = k*G, k from `secrets`. Returns (R host affine,
    (Rx, Ry) Montgomery int32 tensors on `device`)."""
    k = secrets.randbelow(R_MOD - 2) + 1
    if curve == "g1":
        R = HC.g1_mul(HC.g1_generator(), k)
        X, Y, _ = tc.g1_affine_to_device([R])
    else:
        R = HC.g2_mul(HC.g2_generator(), k)
        X, Y, _ = tc.g2_affine_to_device([R])
    return R, (tf.to_tensor(X[0], device), tf.to_tensor(Y[0], device))


def unblind_msm(curve: str, host_pt, wts, R_host, c: int):
    """host_pt - (sum_w 2^{c*w} * wts[w]) * R."""
    w = np.asarray(wts, dtype=np.int64).reshape(-1)
    m = 0
    for i, x in enumerate(w):
        m = (m + (int(x) << (c * i))) % R_MOD
    if m == 0:
        return host_pt
    if curve == "g1":
        return HC.g1_add(host_pt, HC.g1_neg(HC.g1_mul(R_host, m)))
    return HC.g2_add(host_pt, HC.g2_neg(HC.g2_mul(R_host, m)))


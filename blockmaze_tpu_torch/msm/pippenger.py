"""Pippenger multi-scalar multiplication on torch tensors.

Port of blockmaze_tpu/msm/pippenger.py `msm` (the sort-first formulation):

  1. live_stream: one c-bit digit per scalar and window; the live items
     (nonzero digit, finite point) picked out in order by a stable
     partition and stably sorted by key = window * 2^c + digit, so they run
     in (window, digit, point) order; the dead ones, which the JAX stream
     keeps under key DROP, never enter the accumulation;
  2. accumulate: the live stream cut into T = min(lanes, live / MIN_ITEMS)
     contiguous lane ranges; each lane sums its runs of equal keys with
     mixed adds, flushing every run that starts and ends inside the lane
     straight into its bucket (kernel msm_round, csrc/pippenger.cu);
  3. boundary combine: each lane's head and tail partial sums, still in key
     order, reduced by key into their buckets by a segmented tree over
     blocks of partials (kernel msm_combine, csrc/combine.cu);
  4. per window, win = sum_d d*S_d by chunked running sums joined in a
     weighted-pair tree (kernel msm_triangle, csrc/triangle.cu), then the
     Horner fold over windows (kernel msm_fold, csrc/fold.cu).

The JAX package runs steps 3-4 as a Hillis-Steele scan and a triangle tree
of batched add/double launches (a TPU has no atomics and a sequential
grid); the kernels here do the same sums in another order, so the MSM's
Jacobian triples differ from the JAX package's while its affine result is
the same. Each kernel's plain version follows that kernel's order exactly,
so kernel and plain version agree bit for bit.

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

from ..curves import host_curve as HC
from ..curves import native
from ..curves import tcurve as tc
from ..fields import tfield as tf
from ..fields.constants import R_MOD
from ..utils import kernels as kn
from ..utils import spans

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


def window_keys(points, scalars, c: int):
    """(keys (W, n) int64 = window * 2^c + digit, live (W, n) bool: digit
    nonzero and point finite, DROP = W * 2^c)."""
    d = digits(scalars, c)
    W, nb = d.shape[0], 1 << c
    live = (d != 0) & ~points[2].to(torch.bool)[None, :]
    keys = d + (torch.arange(W, device=d.device, dtype=torch.int64)
                * nb)[:, None]
    return keys, live, W * nb


def sort_live(keys, live, count=None):
    """The live items as (keys int32, point ids int32) in (window, digit,
    point) order: a stable partition, then a stable sort of the live keys
    alone. The partition is torch.nonzero, which reads the live count to
    the host (the span device.wait); given that count (an int), it is a
    scatter of each live item to its rank instead, which does not wait for
    the device."""
    n = keys.shape[1]
    flat = live.reshape(-1)
    if count is None:
        with spans.span("device.wait"):
            idx = torch.nonzero(flat).squeeze(1)
    else:
        # dead items all go to the spare slot `count`, which is cut off
        rank = torch.where(flat, torch.cumsum(flat, 0) - 1, count)
        idx = torch.empty(count + 1, dtype=torch.int64, device=flat.device)
        idx.scatter_(0, rank, torch.arange(flat.shape[0], device=flat.device))
        idx = idx[:count]
    skeys, order = torch.sort(keys.reshape(-1)[idx].to(torch.int32),
                              stable=True)
    return skeys, (idx[order] % n).to(torch.int32)


def live_stream(points, scalars, c: int):
    """The accumulation's input: (keys int32 (live,), point ids int32
    (live,), DROP), every key < DROP."""
    keys, live, drop = window_keys(points, scalars, c)
    return sort_live(keys, live) + (drop,)


def stream_keys(points, scalars, c: int):
    """The JAX package's full key-sorted stream: (keys int32 (W*n,), point
    ids int32 (W*n,), DROP). Window-major; each window holds its live items
    in digit order (the live stream's), then its dead items in point order
    under key DROP."""
    keys, live, drop = window_keys(points, scalars, c)
    W, n = keys.shape
    dev = keys.device
    lk, lp = sort_live(keys, live)
    nlive = live.sum(1)
    start = torch.cumsum(nlive, 0) - nlive
    w = lk.to(torch.int64) // (1 << c)
    slot = w * n + torch.arange(lk.shape[0], device=dev) - start[w]
    out_k = torch.full((W * n,), drop, dtype=torch.int32, device=dev)
    out_p = torch.empty(W * n, dtype=torch.int32, device=dev)
    out_k[slot] = lk
    out_p[slot] = lp
    dead = ~live
    rank = torch.cumsum(dead, 1) - 1 + nlive[:, None]
    wi, pi = torch.nonzero(dead, as_tuple=True)
    out_p[wi * n + rank[wi, pi]] = pi.to(torch.int32)
    return out_k, out_p, drop


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
    if X.data_ptr() % 16 or Y.data_ptr() % 16:
        raise ValueError("msm_round: point coordinates must be 16-byte "
                         "aligned (the kernel gathers 16-byte chunks)")
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
# Step 3: boundary combine (kernel msm_combine)
# ---------------------------------------------------------------------------

def boundary_partials(curve, acc, meta, head):
    """The lanes' head and tail partial sums in key order: (keys int32
    (2T,), Jacobian points (2T, ...), blind counts int64 (2T,)). A lane
    that never changed key gives an infinity head with its tail's key and
    count 0, so equal keys stay contiguous."""
    dev = meta.device
    T = meta.shape[1]
    cur_key = meta[0]
    seen = meta[2] != 0
    head_key = torch.where(seen, meta[1], cur_key)
    head = _select(curve, seen, head, _zeros_pts(curve, T, dev))
    keys = torch.stack([head_key, cur_key], 1).reshape(-1)
    pts = tuple(torch.stack([h, a], 1).reshape((2 * T,) + h.shape[1:])
                for h, a in zip(head, acc))
    cnt = torch.stack([seen.to(torch.int64),
                       torch.ones(T, dtype=torch.int64, device=dev)],
                      1).reshape(-1)
    return keys, pts, cnt


def combine_threads(curve: str) -> int:
    """Threads per msm_combine block (2x as many partials per block): 512
    G1 partials (55 KB of shared memory), 256 G2 ones (52 KB)."""
    return 256 if curve == "g1" else 128


def _put_buckets(bkt, bcnt, drop, keys, pts, cnt):
    live = keys < drop
    idx = keys[live]
    for b, p in zip(bkt, pts):
        b[idx] = p[live].to(b.dtype)
    bcnt[idx] = cnt[live]


def _combine_pass_plain(curve, final, keys, pts, cnt, drop, items, bkt,
                        bcnt):
    """One launch of msm_combine: blocks of `items` partials, each reduced
    by key with the segmented tree of csrc/combine.cu, in its order."""
    F = tc.ops(curve)
    dev = keys.device
    n = keys.shape[0]
    nblk = -(-n // items)
    pad = nblk * items - n
    tail = tc.coord_tail(curve)
    k = torch.cat([keys.to(torch.int64),
                   torch.full((pad,), drop, dtype=torch.int64, device=dev)]
                  ).reshape(nblk, items)
    P = [torch.cat([p.to(torch.int64), z.to(torch.int64)]).reshape(
        (nblk, items) + tail) for p, z in zip(pts, _zeros_pts(curve, pad,
                                                               dev))]
    c = torch.cat([cnt, torch.zeros(pad, dtype=torch.int64, device=dev)]
                  ).reshape(nblk, items)
    rows = torch.arange(nblk, device=dev)[:, None]
    half = 1
    while half < items:
        a = torch.arange(0, items, 2 * half, device=dev)
        m = a + half
        e = m + half - 1
        kl, kr = k[:, m - 1], k[:, m]
        sl, sr = k[:, a] == kl, kr == k[:, e]
        last_l = torch.where(sl, a, m - 1)
        L = tuple(p[rows, last_l] for p in P)
        R = tuple(p[:, m] for p in P)
        M = tc.point_add(F, L, R)
        cm = c[rows, last_l] + c[:, m]
        eq = kl == kr
        closed = eq & ~sl & ~sr
        _put_buckets(bkt, bcnt, drop, kl[closed], tuple(x[closed] for x in M),
                     cm[closed])
        left = ~eq & ~sl
        _put_buckets(bkt, bcnt, drop, kl[left],
                     tuple(p[:, m - 1][left] for p in P), c[:, m - 1][left])
        right = ~eq & ~sr
        _put_buckets(bkt, bcnt, drop, kr[right],
                     tuple(x[right] for x in R), c[:, m][right])
        to_a = eq & sl
        to_e = eq & ~sl & sr
        move = ~eq & sr
        new_a = _select(curve, to_a, M, tuple(p[:, a] for p in P))
        new_e = _select(curve, to_e, M,
                        _select(curve, move, R, tuple(p[:, e] for p in P)))
        ca = torch.where(to_a, cm, c[:, a])
        ce = torch.where(to_e, cm, torch.where(move, c[:, m], c[:, e]))
        for p, va, ve in zip(P, new_a, new_e):
            p[:, a] = va
            p[:, e] = ve
        c[:, a] = ca
        c[:, e] = ce
        half *= 2
    single = k[:, 0] == k[:, -1]
    if final:
        _put_buckets(bkt, bcnt, drop, k[:, 0], tuple(p[:, 0] for p in P),
                     c[:, 0])
        _put_buckets(bkt, bcnt, drop, k[:, -1][~single],
                     tuple(p[:, -1][~single] for p in P), c[:, -1][~single])
        return None
    z = _zeros_pts(curve, nblk, dev)
    last = _select(curve, single, z, tuple(p[:, -1] for p in P))
    okeys = torch.stack([k[:, 0], k[:, -1]], 1).reshape(-1).to(torch.int32)
    opts = tuple(torch.stack([p[:, 0], q], 1).reshape((2 * nblk,) + tail)
                 .to(torch.int32) for p, q in zip(P, last))
    ocnt = torch.stack([c[:, 0], torch.where(single, 0, c[:, -1])],
                       1).reshape(-1)
    return okeys, opts, ocnt


def combine_plain(curve, keys, pts, cnt, bkt, bcnt, drop: int,
                  threads: int):
    """msm_combine's passes in its association order: blocks of 2*threads
    partials while more than one block is left, then one final block.
    Writes every run of equal keys < drop into bkt/bcnt in place. A block
    hands two partials on, so threads >= 2 for the passes to shrink."""
    if threads < 2:
        raise ValueError(f"combine: threads {threads} < 2")
    items = 2 * threads
    while keys.shape[0] > items:
        keys, pts, cnt = _combine_pass_plain(curve, False, keys, pts, cnt,
                                             drop, items, bkt, bcnt)
    _combine_pass_plain(curve, True, keys, pts, cnt, drop, items, bkt, bcnt)


def combine(curve, keys, pts, cnt, bkt, bcnt, drop: int):
    """Reduce the key-sorted partials (keys int32 (n,), Jacobian int32
    points, int64 blind counts) by key into the bucket arrays bkt (3 x
    (drop, ...) int32) and bcnt ((drop,) int64), in place: each run of equal
    keys < drop stores its sum and summed count into its bucket row."""
    threads = combine_threads(curve)
    if kn.on_cpu(keys, *pts, cnt, *bkt, bcnt):
        return combine_plain(curve, keys, pts, cnt, bkt, bcnt, drop, threads)
    items = 2 * threads
    dev = keys.device
    tail = tc.coord_tail(curve)
    keys = keys.to(torch.int32).contiguous()
    pts = tuple(p.contiguous() for p in pts)
    kn.check_cuda("msm_combine", keys, *pts, *bkt, counts=(cnt, bcnt))
    while True:
        n = keys.shape[0]
        final = n <= items
        nout = 2 * -(-n // items)
        if final:   # outputs unused: any valid pointers
            okeys, opts, ocnt = keys, pts, cnt
        else:
            okeys = torch.empty(nout, dtype=torch.int32, device=dev)
            opts = tuple(torch.empty((nout,) + tail, dtype=torch.int32,
                                     device=dev) for _ in range(3))
            ocnt = torch.empty(nout, dtype=torch.int64, device=dev)
        kn.K["msm_combine"](kn.CURVE_ID[curve], int(final), n, keys, *pts,
                            cnt, drop, threads, okeys, *opts, ocnt, *bkt,
                            bcnt)
        if final:
            return None
        keys, pts, cnt = okeys, opts, ocnt


# ---------------------------------------------------------------------------
# Step 4a: weighted bucket sums (kernel msm_triangle)
# ---------------------------------------------------------------------------

def triangle_sizes(nb: int):
    """(chunk, threads, blocks per window) of msm_triangle for 2^c = nb
    bucket slots: 8 buckets a thread, up to 64 threads a block, the rest in
    blocks (c = 12: 8 blocks per window, 176 blocks over 22 windows)."""
    chunk = min(8, nb)
    threads = min(64, nb // chunk)
    return chunk, threads, nb // (chunk * threads)


def triangle_plain(curve, bkt, W: int, nb: int, chunk: int):
    """msm_triangle in its association order. Slot j = d - 1 of a window
    holds bucket d (the last slot is infinity); a leaf walks `chunk` slots
    from the top (run += S, acc += run) and becomes (t = chunk*run, w =
    acc); the leaves join pairwise, neighbours first, by w' = (w_lo + w_hi)
    + t_hi, t' = 2 (t_lo + t_hi). The split of that tree between threads and
    blocks in the kernel does not change it. Returns win (W, ...) int32."""
    F = tc.ops(curve)
    dev = bkt[0].device
    tail = tc.coord_tail(curve)
    zw = _zeros_pts(curve, W, dev)
    leaves = nb // chunk
    S = tuple(torch.cat([b.reshape((W, nb) + tail)[:, 1:], z[:, None]], 1)
              .reshape((W * leaves, chunk) + tail) for b, z in zip(bkt, zw))
    run = acc = _zeros_pts(curve, W * leaves, dev)
    for i in range(chunk - 1, -1, -1):
        run = tc.point_add(F, run, tuple(s[:, i] for s in S))
        acc = tc.point_add(F, acc, run)
    t = run
    for _ in range(chunk.bit_length() - 1):
        t = tc.point_double(F, t)
    t = tuple(x.reshape((W, leaves) + tail) for x in t)
    w = tuple(x.reshape((W, leaves) + tail) for x in acc)
    n = leaves
    while n > 1:
        def sp(P, which):
            return tuple(x.reshape((W, n // 2, 2) + tail)[:, :, which]
                         for x in P)
        w = tc.point_add(F, tc.point_add(F, sp(w, 0), sp(w, 1)), sp(t, 1))
        t = tc.point_double(F, tc.point_add(F, sp(t, 0), sp(t, 1)))
        n //= 2
    return tuple(x[:, 0].to(torch.int32) for x in w)


def triangle(curve: str, bkt, W: int, nb: int):
    """win_w = sum_{d=1}^{nb-1} d * S_{w,d} over the (W*nb, ...) bucket
    arrays, as (W, ...) Jacobian int32 points."""
    chunk, threads, blocks = triangle_sizes(nb)
    if kn.on_cpu(*bkt):
        return triangle_plain(curve, bkt, W, nb, chunk)
    dev = bkt[0].device
    tail = tc.coord_tail(curve)
    bkt = tuple(b.contiguous() for b in bkt)
    kn.check_cuda("msm_triangle", *bkt)
    scratch = [torch.empty((W * blocks,) + tail, dtype=torch.int32,
                           device=dev) for _ in range(6)]
    counters = torch.zeros(W, dtype=torch.int32, device=dev)
    out = [torch.empty((W,) + tail, dtype=torch.int32, device=dev)
           for _ in range(3)]
    kn.K["msm_triangle"](kn.CURVE_ID[curve], W, nb, *bkt, chunk, threads,
                         blocks, *scratch, counters, *out)
    return tuple(out)


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


def window_counts(cnt, W: int, nb: int):
    """The triangle's integer mirror: window w holds sum_d d * cnt_{w,d}
    surplus copies of the blind R, as (W,) int64."""
    cw = cnt.reshape(W, nb)[:, 1:]
    return torch.flip(torch.cumsum(torch.flip(cw, [1]), 1), [1]).sum(1)


# ---------------------------------------------------------------------------
# The MSM
# ---------------------------------------------------------------------------

def _select(curve, mask, a, b):
    return tuple(tc.ops(curve).select(mask, x, y) for x, y in zip(a, b))


# Fewest live items per lane before the stream is cut into more lanes, and
# the most lanes (Prover.lanes on the card). The prove path's blinded G1
# msm_round holds 4 blocks of 128 threads per SM (126 registers, a 32 KB
# ring each), 67,584 threads on 132 SMs, so the dense H stream fills the
# card at ~2^16 lanes; PERF.md has the sweep of both values.
MIN_ITEMS = 4
MAX_LANES = 65536


def lane_cut(live: int, lanes: int, min_items: int = MIN_ITEMS):
    """(T, L) for `live` items: T = min(lanes, ceil(live / min_items))
    lanes of L = ceil(live / T) items."""
    T = max(1, min(lanes, -(-live // min_items)))
    return T, -(-live // T)


def pad_stream(keys, pids, drop: int, T: int, L: int):
    """The stream padded with dead items (key DROP, point 0) to T*L."""
    pad = T * L - keys.shape[0]
    if pad:
        dev = keys.device
        keys = torch.cat([keys, torch.full((pad,), drop, dtype=torch.int32,
                                           device=dev)])
        pids = torch.cat([pids, torch.zeros(pad, dtype=torch.int32,
                                            device=dev)])
    return keys, pids


def msm(curve: str, points, scalars, c: int, lanes: int, blind=None):
    """sum_i scalars_i * points_i as a Jacobian point (X, Y, Z) of int32
    coordinate tensors without batch axis; with blind=(Rx, Ry) the result
    is (X, Y, Z, wts) with wts the (W,) int64 per-window counts of R.
    lanes is the most accumulation lanes (lane_cut). Recorded as the span
    msm.query, the live stream inside it as msm.stream (utils/spans.py)."""
    with spans.span("msm.query") as query:
        with spans.span("msm.stream"):
            stream = live_stream(points, scalars, c)
        live = stream[0].shape[0]
        T, L = lane_cut(live, lanes) if live else (0, 0)
        query.info = {"curve": curve, "points": points[0].shape[0], "c": c,
                      "windows": n_windows(c), "live": live, "lanes": T,
                      "per_lane": L}
        return msm_stream(curve, points, stream, c, lanes, blind)


def msm_stream(curve: str, points, stream, c: int, lanes: int, blind=None,
               step=None):
    """msm from its live stream (keys, point ids, DROP) on: the
    accumulation, reduction and fold, none of which waits for the
    device. step, if given, is called with each step's name (accumulate,
    combine, triangle, fold) once its work is queued: msmbench's split."""
    W = n_windows(c)
    nb = 1 << c
    step = step or (lambda name: None)
    keys, pids, drop = stream
    if keys.shape[0] == 0:      # every scalar 0 or every point infinite
        res = tuple(t[0] for t in _zeros_pts(curve, 1, keys.device))
        return res if blind is None else res + (
            torch.zeros(W, dtype=torch.int64, device=keys.device),)
    T, L = lane_cut(keys.shape[0], lanes)
    keys, pids = pad_stream(keys, pids, drop, T, L)
    acc, meta, head, bkt, cnt = accumulate(curve, keys, pids, points, blind,
                                           T, L, drop)
    step("accumulate")
    cnt = cnt.to(torch.int64)
    combine(curve, *boundary_partials(curve, acc, meta, head), bkt, cnt,
            drop)
    wts = None if blind is None else window_counts(cnt, W, nb)
    step("combine")
    win = triangle(curve, bkt, W, nb)
    step("triangle")
    res = fold(curve, c, win)
    step("fold")
    return res if blind is None else res + (wts,)


# ---------------------------------------------------------------------------
# Blinding (host)
# ---------------------------------------------------------------------------

def blind_scalar() -> int:
    """A fresh blind's scalar k, 1 <= k < r - 1, from `secrets`."""
    return secrets.randbelow(R_MOD - 2) + 1


def make_blind(curve: str, device, k: int | None = None):
    """Blind R = k*G, k = blind_scalar() unless given (one native scalar
    product, curves/native.py). Returns (R host affine, (Rx, Ry)
    Montgomery int32 tensors on `device`)."""
    k = blind_scalar() if k is None else k
    if curve == "g1":
        R = native.mul("g1", HC.g1_generator(), k)
        X, Y, _ = tc.g1_affine_to_device([R])
    else:
        R = native.mul("g2", HC.g2_generator(), k)
        X, Y, _ = tc.g2_affine_to_device([R])
    return R, (tf.to_tensor(X[0], device), tf.to_tensor(Y[0], device))


def surplus(wts, c: int) -> int:
    """The blind's multiple m = sum_w 2^{c*w} * wts[w] mod r. wts is (W,),
    or (k, W) stacked from the k partials of a sharded MSM, whose columns
    are summed per window."""
    w = np.asarray(wts, dtype=np.int64)
    w = w.reshape(-1, w.shape[-1])
    m = 0
    for i in range(w.shape[1]):
        m = (m + (sum(int(x) for x in w[:, i]) << (c * i))) % R_MOD
    return m


def unblind_msm(curve: str, host_pt, wts, R_host, c: int):
    """host_pt - surplus(wts, c) * R, host affine (one native scalar
    product)."""
    return native.msub(curve, host_pt, R_host, surplus(wts, c))


def unblind_result(curve: str, res, R_host, c: int):
    """An MSM's result (X, Y, Z, wts) as the card returns it (numpy: X, Y,
    Z Jacobian Montgomery limbs, wts the window counts) to host affine,
    less surplus(wts, c) * R, in one native call (one scalar product)."""
    return native.unblind(curve, res[:3], R_host, surplus(res[3], c))

"""The card's peaks and the least time a kernel's work could take on it.

One NVIDIA H100 SXM (data sheet): HBM at 3.35 TB/s. Integer multiply-add:
132 SMs x 64 IMAD per clock x 1.98 GHz = 16.7 T IMAD/s, half the float32
FMA rate behind the data sheet's 67 TFLOP/s (derived, not published). One
Montgomery product of 256-bit operands (8 x 32-bit CIOS) is 264 IMAD: 128
32x32->64 products at 2 IMAD each and 8 for the reduction factors. These
assume the card's full power limit of 700 W; the run prints the card's
limit beside every share.

A bound is the larger of the operations' time and the bytes' time, each
input byte read once and each output byte written once.
"""

from __future__ import annotations

MEM_RATE = 3.35e12
IMAD_RATE = 132 * 64 * 1.98e9
IMAD_PER_PRODUCT = 264
# Fq products of one mixed (Jacobian + affine) addition: G1 7M + 4S; G2 the
# same in Fq2, 3 Fq products a multiplication, 2 a squaring, plus the adds'
# share of reductions (chip_smoke.py's PRODUCTS)
MIXED_ADD_PRODUCTS = {"g1": 11, "g2": 29}
# bytes of one coordinate of an affine point as the prover stores it: 16
# 32-bit limbs in G1, twice that in G2
COORD_BYTES = {"g1": 64, "g2": 128}


def bound_s(products: int, nbytes: int):
    """(least seconds, "ops" or "bytes": which of the two sets it)."""
    ops = products * IMAD_PER_PRODUCT / IMAD_RATE
    mem = nbytes / MEM_RATE
    return (ops, "ops") if ops >= mem else (mem, "bytes")


def msm_round_counts(curve: str, points_inf, scalars, c: int, lanes: int,
                     min_items: int):
    """The work one blinded msm_round launch does on these inputs: (live
    items, bytes). A live item is a window whose c-bit digit of the scalar
    is nonzero, at a finite point; each is one mixed add. Bytes: the live
    stream cut into T = min(lanes, ceil(live / min_items)) lanes of L
    items (a key and a point id each), every point that has a live item
    read once (x, y and its flag), the lanes' head and tail partials and
    their metadata written, and the bucket array (a point and a count per
    bucket, W * 2^c buckets)."""
    import torch
    s = scalars.to(torch.int64)
    finite = ~points_inf.to(torch.bool)
    W = -(-254 // c)
    live = 0
    for w in range(W):
        li, off = divmod(w * c, 16)
        word = s[:, li]
        if li + 1 < s.shape[1]:
            word = word | (s[:, li + 1] << 16)
        live += int((((word >> off) & ((1 << c) - 1)) != 0)
                    .logical_and(finite).sum())
    used = int(((s != 0).any(1) & finite).sum())
    if live == 0:
        return 0, 0
    T = max(1, min(lanes, -(-live // min_items)))
    L = -(-live // T)
    cb = COORD_BYTES[curve]
    nbytes = (T * L * 8 + used * (2 * cb + 1) + 2 * T * 3 * cb + 3 * T * 4
              + W * (1 << c) * (3 * cb + 4))
    return live, nbytes


def msm_round_work(prover) -> dict:
    """The least seconds msm_round could take over the last proof's five
    MSMs (prover.msm_inputs), summed, with how many of them each bound
    sets: {"bound_s", "ops", "bytes", "items"}."""
    from blockmaze_tpu_torch.msm import pippenger as pp
    out = {"bound_s": 0.0, "ops": 0, "bytes": 0, "items": 0}
    for name, (pts, scalars) in prover.msm_inputs.items():
        curve = "g2" if name == "B g2" else "g1"
        live, nbytes = msm_round_counts(curve, pts[2], scalars,
                                        prover.window, prover.lanes,
                                        pp.MIN_ITEMS)
        if live == 0:
            continue
        b, by = bound_s(live * MIXED_ADD_PRODUCTS[curve], nbytes)
        out["bound_s"] += b
        out[by] += 1
        out["items"] += live
    return out

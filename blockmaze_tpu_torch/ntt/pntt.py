"""Fr kernels of the NTT pipeline (csrc/pntt.cu), each beside its plain
torch version: the in-order radix-2 FFT with its stages fused in shared
memory, one radix-2 DIT stage, and the pointwise Montgomery product.

A wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors; anything else raises. Inputs are (n, 16) limb tensors in
Montgomery form; outputs are int32.
"""

from __future__ import annotations

import torch

from ..fields import tfield as tf
from ..utils import kernels as kn

FR = tf.FR

# Stages per fft pass at most: a tile of 2^10 elements per block
# (csrc/pntt.cu FFT_TILE_LOG).
FFT_TILE_LOG = 10


def butterfly_plain(a, tw, span: int):
    """One DIT stage over a (m, 16) array: for each block of 2*span rows,
    (lo, hi) -> (lo + tw*hi, lo - tw*hi) with tw the stage's (span, 16)
    twiddle table."""
    m = a.shape[0]
    v = a.reshape(m // (2 * span), 2, span, tf.N)
    lo, hi = v[:, 0], v[:, 1]
    t = tf.mont_mul(FR, tw.expand(hi.shape), hi)
    out = torch.stack([tf.add(FR, lo, t), tf.sub(FR, lo, t)], dim=1)
    return out.reshape(m, tf.N).to(torch.int32)


def butterfly(a, tw, span: int):
    """Port of blockmaze_tpu/ntt/pntt.py `butterfly`, over a whole stage."""
    if kn.on_cpu(a, tw):
        return butterfly_plain(a, tw, span)
    m = a.shape[0]
    if a.shape != (m, tf.N) or tw.shape != (span, tf.N) or m % (2 * span):
        raise ValueError(f"butterfly: bad shapes {tuple(a.shape)}, "
                         f"{tuple(tw.shape)}, span {span}")
    kn.check_cuda("butterfly", a, tw)
    out = torch.empty_like(a)
    kn.K["butterfly"](out, a, tw, m, span)
    return out


def fft_passes(k: int, tile_log: int = FFT_TILE_LOG):
    """Stage ranges [s0, s1) of the fft kernel's launches for 2^k elements:
    ceil(k / tile_log) passes (one for k = 0) of nearly equal depth."""
    n = max(1, -(-k // tile_log))
    out, s0 = [], 0
    for i in range(n):
        d = -(-(k - s0) // (n - i))
        out.append((s0, s0 + d))
        s0 += d
    return out


def fft_plain(a, perm, tw):
    """The in-order DIT FFT as a loop: gather through perm, then stage s
    over the twiddles tw[2^s - 1 : 2^(s+1) - 1] (tw is the (m - 1, 16)
    concatenation of the per-stage tables)."""
    a = a.index_select(0, perm).to(torch.int32)
    span = 1
    while span < a.shape[0]:
        a = butterfly_plain(a, tw[span - 1:2 * span - 1], span)
        span *= 2
    return a


def fft(a, perm, tw):
    """In-order radix-2 DIT FFT of m = 2^k rows: out = stages(a[perm]).
    perm (m,) int32, tw (m - 1, 16) concatenated twiddles, stage s at row
    2^s - 1. On the card: one launch per pass of fft_passes(k), in tiles
    of 2^d elements for the deepest pass's d stages."""
    if kn.on_cpu(a, perm, tw):
        return fft_plain(a, perm, tw)
    m = a.shape[0]
    k = m.bit_length() - 1
    if m != 1 << k or a.shape != (m, tf.N) or perm.shape != (m,) \
            or tw.shape != (m - 1, tf.N):
        raise ValueError(f"fft: bad shapes {tuple(a.shape)}, "
                         f"{tuple(perm.shape)}, {tuple(tw.shape)}")
    kn.check_cuda("fft", a, perm, tw)
    if a.data_ptr() % 16 or tw.data_ptr() % 16:
        raise ValueError("fft: input and twiddles must be 16-byte aligned "
                         "(the kernel reads 16-byte chunks)")
    passes = fft_passes(k)
    tile_log = passes[0][1]     # the deepest pass: tiles of 2^tile_log
    out = torch.empty_like(a)
    scratch = out if len(passes) == 1 else torch.empty(
        (m, 8), dtype=torch.int32, device=a.device)
    for i, (s0, s1) in enumerate(passes):
        first, last = i == 0, i == len(passes) - 1
        kn.K["fft"](out if last else scratch, a if first else scratch, perm,
                    tw, k, tile_log, s0, s1, int(first), int(last))
    return out


def mul_elementwise_plain(a, b):
    return tf.mont_mul(FR, a, b).to(torch.int32)


def mul_elementwise(a, b):
    """Port of blockmaze_tpu/ntt/pntt.py `mul_elementwise`: a*b*R^-1 mod r
    per row. b is (n, 16) or a single (1, 16) / (16,) row broadcast to
    every row of a."""
    if kn.on_cpu(a, b):
        return mul_elementwise_plain(a, b)
    n = a.shape[0]
    b2 = b.reshape(-1, tf.N)
    if a.shape != (n, tf.N) or b2.shape[0] not in (1, n):
        raise ValueError(f"mul_elementwise: bad shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bcast = int(b2.shape[0] == 1 and n != 1)
    kn.check_cuda("mul_elementwise", a, b2)
    out = torch.empty_like(a)
    kn.K["mul_elementwise"](out, a, b2, n, bcast)
    return out

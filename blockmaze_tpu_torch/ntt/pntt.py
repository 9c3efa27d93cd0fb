"""Fr kernels of the NTT pipeline: one radix-2 DIT stage and the pointwise
Montgomery product (csrc/pntt.cu), each beside its plain torch version.

A wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors; anything else raises. Inputs are (n, 16) limb tensors in
Montgomery form; outputs are int32.
"""

from __future__ import annotations

import torch

from ..fields import tfield as tf
from ..utils import kernels as kn

FR = tf.FR


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

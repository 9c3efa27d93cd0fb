"""Fr kernels of the NTT pipeline, each beside its plain torch version:
csrc/pntt.cu's in-order radix-2 FFT with its stages fused in shared memory
(and optional pointwise factors before and after), one radix-2 DIT stage
and the pointwise Montgomery product; csrc/qap.cu's step-domain input and
output stages and the QAP's (A*B - C)/Z.

A wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors; anything else raises. Inputs are (n, 16) limb tensors in
Montgomery form; outputs are int32. Every op is exact and canonical, so a
kernel equals its plain version bit for bit whatever its association
order.
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


def fft_plain(a, perm, tw, pre=None, scale=None, post=None):
    """The in-order DIT FFT as a loop, of each block of m = len(perm) rows
    of a (a batch of FFTs stored one after the other): a times pre, each
    block gathered through perm, then stage s over the twiddles
    tw[2^s - 1 : 2^(s+1) - 1] (tw is the (m - 1, 16) concatenation of the
    per-stage tables), then times scale and times post (each factor
    optional)."""
    if pre is not None:
        a = mul_elementwise_plain(a, pre)
    m = perm.shape[0]
    a = a.reshape(-1, m, tf.N).index_select(1, perm).reshape(-1, tf.N) \
        .to(torch.int32)
    span = 1
    while span < m:
        a = butterfly_plain(a, tw[span - 1:2 * span - 1], span)
        span *= 2
    for f in (scale, post):
        if f is not None:
            a = mul_elementwise_plain(a, f)
    return a


def fft(a, perm, tw, pre=None, scale=None, post=None, out=None):
    """In-order radix-2 DIT FFT of m = 2^j rows, of each block of m rows of
    a (n = 2^k rows, k >= j: a batch of 2^(k-j) FFTs stored one after the
    other): out = stages((a * pre)[perm]) * scale * post. perm (m,) int32,
    tw (m - 1, 16) concatenated twiddles, stage s at row 2^s - 1; the
    factors are optional, pre and post (n, 16) (pre at the source index: a
    coset FFT's powers), scale one (1, 16) row (an inverse FFT's 1/m). The
    result goes to `out` if given (an (n, 16) tensor, e.g. a row slice of a
    larger one). On the card: one launch per pass of fft_passes(j), in
    tiles of 2^d elements for the deepest pass's d stages; pre rides in
    the first pass, scale and post in the last."""
    given = [t for t in (pre, scale, post, out) if t is not None]
    if kn.on_cpu(a, perm, tw, *given):
        res = fft_plain(a, perm, tw, pre, scale, post)
        return res if out is None else out.copy_(res)
    m, n = perm.shape[0], a.shape[0]
    j, k = m.bit_length() - 1, n.bit_length() - 1
    if m != 1 << j or n != 1 << k or k < j or a.shape != (n, tf.N) \
            or perm.shape != (m,) or tw.shape != (m - 1, tf.N) \
            or any(f is not None and f.shape != (n, tf.N)
                   for f in (pre, post, out)) \
            or (scale is not None and scale.numel() != tf.N):
        raise ValueError(f"fft: bad shapes {tuple(a.shape)}, "
                         f"{tuple(perm.shape)}, {tuple(tw.shape)}, factors "
                         f"{[tuple(f.shape) for f in given]}")
    kn.check_cuda("fft", a, perm, tw, *given)
    kn.check_aligned("fft", a, tw, *given)
    passes = fft_passes(j)
    tile_log = passes[0][1]     # the deepest pass: tiles of 2^tile_log
    out = torch.empty_like(a) if out is None else out
    scratch = out if len(passes) == 1 else torch.empty(
        (n, 8), dtype=torch.int32, device=a.device)
    for i, (s0, s1) in enumerate(passes):
        first, last = i == 0, i == len(passes) - 1
        kn.K["fft"](out if last else scratch, a if first else scratch, perm,
                    tw, k, j, tile_log, s0, s1, int(first), int(last), pre,
                    scale, post)
    return out


def mul_elementwise_plain(a, b):
    return tf.mont_mul(FR, a, b).to(torch.int32)


def mul_elementwise(a, b):
    """Port of blockmaze_tpu/ntt/pntt.py `mul_elementwise`: a*b*R^-1 mod r
    per row. b is (n, 16) or a single (1, 16) / (16,) row broadcast to
    every row of a."""
    if kn.on_cpu(a, b):
        if b.dim() == 2 and b.shape[0] == a.shape[0]:
            return kn.plain_by_rows(mul_elementwise_plain, a, b)
        return kn.plain_by_rows(lambda rows: mul_elementwise_plain(rows, b),
                                a)
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


# ---------------------------------------------------------------------------
# Step domain stages and the QAP's pointwise combine (csrc/qap.cu)
# ---------------------------------------------------------------------------

def step_pre_plain(a, omega, small_m: int, coset=None):
    """jntt._step_fft_t before its two FFTs, on x = a * coset (or a): the
    big part c = x_lo + pad(x_hi) in rows [0, big_m) and the small part
    acc = sum over j of (omega * (x_lo - pad(x_hi)))[j*small_m + i] in rows
    [big_m, m)."""
    x = a if coset is None else mul_elementwise_plain(a, coset)
    big_m = a.shape[0] - small_m
    lo, hi = x[:big_m], x[big_m:]
    pad = torch.cat([hi, hi.new_zeros((big_m - small_m, tf.N))])
    e = mul_elementwise_plain(omega, tf.sub(FR, lo, pad))
    e = e.reshape(big_m // small_m, small_m, tf.N)
    acc = e[0]
    for j in range(1, e.shape[0]):
        acc = tf.add(FR, acc, e[j])
    return torch.cat([tf.add(FR, lo, pad), acc]).to(torch.int32)


def step_pre(a, omega, small_m: int, coset=None):
    """The step domain's forward FFT input, one (m, 16) array whose rows
    [0, big_m) and [big_m, m) the big and the small FFT take (see
    step_pre_plain). coset (m, 16) is optional; omega is the (big_m, 16)
    table of omega^i."""
    given = [t for t in (coset,) if t is not None]
    if kn.on_cpu(a, omega, *given):
        return step_pre_plain(a, omega, small_m, coset)
    m = a.shape[0]
    big_m = m - small_m
    if a.shape != (m, tf.N) or small_m <= 0 or big_m % small_m \
            or omega.shape != (big_m, tf.N) \
            or (coset is not None and coset.shape != (m, tf.N)):
        raise ValueError(f"step_pre: bad shapes {tuple(a.shape)}, "
                         f"{tuple(omega.shape)}, small_m {small_m}")
    kn.check_cuda("step_pre", a, omega, *given)
    kn.check_aligned("step_pre", a, omega, *given)
    out = torch.empty_like(a)
    kn.K["step_pre"](out, a, coset, omega, big_m, small_m)
    return out


def step_post_plain(u0, u1, omega, omega_inv, big_minv, small_minv, half,
                    post=None):
    """jntt._step_ifft_t after its two inverse FFTs (u0 of big_m rows, u1
    of small_m), then times post (optional, at the output index)."""
    big_m, small_m = u0.shape[0], u1.shape[0]
    U0 = mul_elementwise_plain(u0, big_minv)
    U1 = mul_elementwise_plain(u1, small_minv)
    tmp = mul_elementwise_plain(U0, omega).reshape(big_m // small_m,
                                                  small_m, tf.N)
    s = tmp[1]
    for j in range(2, tmp.shape[0]):
        s = tf.add(FR, s, tmp[j])
    U1 = mul_elementwise_plain(tf.sub(FR, U1, s), omega_inv)
    lo = mul_elementwise_plain(tf.add(FR, U0[:small_m], U1), half)
    hi = mul_elementwise_plain(tf.sub(FR, U0[:small_m], U1), half)
    out = torch.cat([lo, U0[small_m:], hi])
    return out if post is None else mul_elementwise_plain(out, post)


def step_post(u0, u1, omega, omega_inv, big_minv, small_minv, half,
              post=None):
    """The step domain's inverse FFT output (m, 16) from the raw inverse
    FFTs u0 (big_m, 16) and u1 (small_m, 16): the 1/big_m and 1/small_m
    rows, the (big_m, 16) omega^i and (small_m, 16) omega^-i tables, the
    1/2 row, and an optional (m, 16) post factor (coset^-1 of an inverse
    coset FFT). See step_post_plain."""
    given = [t for t in (post,) if t is not None]
    tensors = (u0, u1, omega, omega_inv, big_minv, small_minv, half)
    if kn.on_cpu(*tensors, *given):
        return step_post_plain(*tensors, post)
    big_m, small_m = u0.shape[0], u1.shape[0]
    m = big_m + small_m
    if u0.shape != (big_m, tf.N) or u1.shape != (small_m, tf.N) \
            or small_m <= 0 or big_m % small_m \
            or omega.shape != (big_m, tf.N) \
            or omega_inv.shape != (small_m, tf.N) \
            or any(r.numel() != tf.N for r in (big_minv, small_minv, half)) \
            or (post is not None and post.shape != (m, tf.N)):
        raise ValueError(f"step_post: bad shapes {tuple(u0.shape)}, "
                         f"{tuple(u1.shape)}")
    kn.check_cuda("step_post", *tensors, *given)
    kn.check_aligned("step_post", *tensors, *given)
    out = torch.empty((m, tf.N), dtype=torch.int32, device=u0.device)
    kn.K["step_post"](out, u0, u1, omega, omega_inv, big_minv, small_minv,
                      half, post, big_m, small_m)
    return out


def qap_combine_plain(a, b, c, zinv):
    return mul_elementwise_plain(tf.sub(FR, mul_elementwise_plain(a, b), c),
                                 zinv)


def qap_combine(a, b, c, zinv):
    """H = (a*b - c) * zinv per row, all (m, 16): the QAP's pointwise
    product, difference and division by Z on the coset in one pass."""
    if kn.on_cpu(a, b, c, zinv):
        return qap_combine_plain(a, b, c, zinv)
    m = a.shape[0]
    if any(t.shape != (m, tf.N) for t in (a, b, c, zinv)):
        raise ValueError(f"qap_combine: bad shapes "
                         f"{[tuple(t.shape) for t in (a, b, c, zinv)]}")
    kn.check_cuda("qap_combine", a, b, c, zinv)
    kn.check_aligned("qap_combine", a, b, c, zinv)
    out = torch.empty_like(a)
    kn.K["qap_combine"](out, a, b, c, zinv, m)
    return out

"""blockmaze_tpu_torch NTT against the JAX package: the plain versions of
the butterfly and pointwise-product kernels against the Pallas kernels
(interpret mode on the CPU), the fft kernel's plain version and its
concatenated twiddle tables against jntt.fft_with and jntt's per-stage
tables, the fft kernel's pass decomposition emulated on the CPU, and the
table-driven FFT pipeline against jntt on basic (m = 16, 128) and step
(m = 24, 48: big_m = 2 * small_m, the mint shape) domains, each package on
its own domain object. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.ntt import domain as D
from blockmaze_tpu.ntt import jntt
from blockmaze_tpu.ntt import pntt as jpntt
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.ntt import domain as TD
from blockmaze_tpu_torch.ntt import pntt, tntt

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)


def _rand_fr(rng, n):
    p = tf.FR.modulus
    return tf.to_mont_host(tf.FR, [int.from_bytes(rng.bytes(32), "little") % p
                                   for _ in range(n)])


def _np(t):
    return np.asarray(t).astype(np.int64)


def test_mul_elementwise_plain_matches_pallas():
    rng = np.random.default_rng(1)
    a, b = _rand_fr(rng, 300), _rand_fr(rng, 300)
    got = pntt.mul_elementwise(tf.to_tensor(a, "cpu"), tf.to_tensor(b, "cpu"))
    want = jpntt.mul_elementwise(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), _np(want))
    # a single row of b broadcasts, as the scaling steps use it
    got1 = pntt.mul_elementwise(tf.to_tensor(a, "cpu"),
                                tf.to_tensor(b[:1], "cpu"))
    want1 = jpntt.mul_elementwise(jnp.asarray(a),
                                  jnp.asarray(np.broadcast_to(b[:1], a.shape)))
    assert np.array_equal(_np(got1), _np(want1))


@pytest.mark.parametrize("m,span", [(256, 128), (256, 4)])
def test_butterfly_plain_matches_pallas(m, span):
    rng = np.random.default_rng(m + span)
    a, tw = _rand_fr(rng, m), _rand_fr(rng, span)
    got = _np(pntt.butterfly(tf.to_tensor(a, "cpu"), tf.to_tensor(tw, "cpu"),
                             span)).reshape(m // (2 * span), 2, span, 16)
    v = a.reshape(m // (2 * span), 2, span, 16)
    lo, hi = v[:, 0].reshape(-1, 16), v[:, 1].reshape(-1, 16)
    twb = np.broadcast_to(tw, (m // (2 * span), span, 16)).reshape(-1, 16)
    nl, nh = jpntt.butterfly(jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(twb))
    assert np.array_equal(got[:, 0].reshape(-1, 16), _np(nl))
    assert np.array_equal(got[:, 1].reshape(-1, 16), _np(nh))


@pytest.mark.parametrize("min_size", [16, 128, 24, 48],
                         ids=["basic16", "basic128", "step24", "step48"])
def test_pipeline_matches_jntt(min_size):
    d = D.get_evaluation_domain(min_size)
    td = TD.get_evaluation_domain(min_size)
    assert isinstance(d, D.StepDomain) == (min_size in (24, 48))
    assert isinstance(td, TD.StepDomain) == (min_size in (24, 48))
    assert td.m == d.m
    rng = np.random.default_rng(min_size)
    a = _rand_fr(rng, d.m)
    JT = jntt.qap_tables(d)
    TT = tntt.tables_to(tntt.qap_tables(td), "cpu")
    ta = tf.to_tensor(a, "cpu")
    ja = jnp.asarray(a)
    for name in ("fft_t", "ifft_t", "coset_fft_t", "icoset_fft_t"):
        got = getattr(tntt, name)(td, ta, TT)
        want = getattr(jntt, name)(d, ja, JT)
        assert np.array_equal(_np(got), _np(want)), name
    assert np.array_equal(_np(tntt.divide_by_z_t(ta, TT)),
                          _np(jntt.divide_by_z_t(ja, JT)))


def test_tables_match_jntt():
    for min_size in (128, 48):
        JT = jntt.qap_tables(D.get_evaluation_domain(min_size))
        TT = tntt.qap_tables(TD.get_evaluation_domain(min_size))
        assert set(JT) == set(TT)
        for k, v in JT.items():
            if isinstance(v, tuple):
                assert all(np.array_equal(x, y) for x, y in zip(v, TT[k]))
            else:
                assert np.array_equal(np.asarray(v).reshape(-1),
                                      np.asarray(TT[k]).reshape(-1)), k


def test_fft_is_evaluation_on_step_domain():
    """Independent of the JAX package: the step-domain FFT evaluates the
    polynomial at the domain points."""
    d = TD.get_evaluation_domain(24)
    rng = np.random.default_rng(9)
    p = tf.FR.modulus
    coeffs = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(d.m)]
    T = tntt.tables_to(tntt.qap_tables(d), "cpu")
    out = tf.from_mont_host(tf.FR, _np(tntt.fft_t(
        d, tf.to_tensor(tf.to_mont_host(tf.FR, coeffs), "cpu"), T)))

    def ev(x):
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p
        return acc

    assert out == [ev(d.get_domain_element(i)) for i in range(d.m)]


def _fft_cases(min_size):
    """(name, jntt perm, jntt per-stage tables, port perm, port
    concatenated twiddles) of every FFT the domain's QAP runs."""
    d = D.get_evaluation_domain(min_size)
    td = TD.get_evaluation_domain(min_size)
    JT = jntt.qap_tables(d)
    TT = tntt.tables_to(tntt.qap_tables(td), "cpu")
    pre = [""] if isinstance(d, D.BasicDomain) else ["big_", "small_"]
    return [(p + di, JT[p + "perm"], JT[p + di], TT[p + "perm"], TT[p + di])
            for p in pre for di in ("fwd", "inv")]


@pytest.mark.parametrize("min_size", [128, 48, 24],
                         ids=["basic128", "step48", "step24"])
def test_fft_plain_and_tables_match_jntt(min_size):
    """The card path's fft (plain version: gather, then stage s over rows
    2^s - 1 .. 2^(s+1) - 2 of the concatenated table) equals jntt.fft_with
    on the same input, and the concatenated table is jntt's per-stage
    tables end to end; forward and inverse, big and small FFT of a step
    domain."""
    rng = np.random.default_rng(min_size + 1)
    for name, jperm, jstages, perm, tw in _fft_cases(min_size):
        m = perm.shape[0]
        assert perm.dtype == torch.int32 and tw.shape == (m - 1, 16)
        for s, jtw in enumerate(jstages):
            assert np.array_equal(_np(tw[(1 << s) - 1:(2 << s) - 1]),
                                  _np(jtw)), (name, s)
        a = _rand_fr(rng, m)
        got = tntt.fft_with(tf.to_tensor(a, "cpu"), perm, tw)
        want = jntt.fft_with(jnp.asarray(a), m, jnp.asarray(jperm),
                             tuple(jnp.asarray(t) for t in jstages))
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), _np(want)), name


def test_fft_passes():
    """Passes of at most FFT_TILE_LOG stages cover every stage once: two up
    to 2^20 (mint's 2^17 and 2^16, send's 2^18, deposit's 2^19)."""
    assert pntt.fft_passes(17) == [(0, 9), (9, 17)]
    assert pntt.fft_passes(16) == [(0, 8), (8, 16)]
    assert pntt.fft_passes(19) == [(0, 10), (10, 19)]
    assert pntt.fft_passes(0) == [(0, 0)]
    assert pntt.fft_passes(7) == [(0, 7)]
    for k in range(0, 31):
        ps = pntt.fft_passes(k)
        assert ps[0][0] == 0 and ps[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(ps, ps[1:]))
        assert all(0 <= s1 - s0 <= pntt.FFT_TILE_LOG for s0, s1 in ps)
        assert len(ps) == max(1, -(-k // pntt.FFT_TILE_LOG))


def _tiled_fft(a, perm, tw, tile_log):
    """csrc/pntt.cu's fft passes on the CPU: a pass over stages [s0, s1)
    takes column col (low = col mod 2^s0, high = col >> s0) at positions
    low + (r << s0) + (high << s1), r < 2^(s1 - s0), and its stage s0 + l
    butterfly at row r_lo uses twiddle row 2^(s0+l) - 1 + low + ((r_lo mod
    2^l) << s0); the first pass gathers through perm."""
    m = a.shape[0]
    k = m.bit_length() - 1
    cur = a.to(torch.int64)
    for s0, s1 in pntt.fft_passes(k, tile_log):
        R = 1 << (s1 - s0)
        cols = torch.arange(m // R)
        low, high = cols & ((1 << s0) - 1), cols >> s0
        pos = low[None] + (torch.arange(R)[:, None] << s0) + (high[None] << s1)
        v = cur[perm.long()[pos]] if s0 == 0 else cur[pos]
        for l in range(s1 - s0):
            half = 1 << l
            pr = torch.arange(R // 2)
            rlo = ((pr >> l) << (l + 1)) | (pr & (half - 1))
            j = low[None] + ((rlo & (half - 1))[:, None] << s0)
            w = tw.to(torch.int64)[(1 << (s0 + l)) - 1 + j]
            x, y = v[rlo], v[rlo + half]
            t = tf.mont_mul(tf.FR, w, y)
            v[rlo], v[rlo + half] = tf.add(tf.FR, x, t), tf.sub(tf.FR, x, t)
        cur = torch.empty_like(cur)
        cur[pos] = v
    return cur.to(torch.int32)


@pytest.mark.parametrize("tile_log", [2, 3, 10])
def test_fft_pass_decomposition_matches_plain(tile_log):
    """The kernel's position and twiddle arithmetic, emulated at tile
    depths that give four, three and one passes over basic128's forward
    FFT (2^7) and three, two and one over step48's big inverse one (2^5),
    equals the plain loop."""
    rng = np.random.default_rng(tile_log)
    for min_size, which in ((128, 0), (48, 1)):
        _, _, _, perm, tw = _fft_cases(min_size)[which]
        a = tf.to_tensor(_rand_fr(rng, perm.shape[0]), "cpu")
        assert torch.equal(_tiled_fft(a, perm, tw, tile_log),
                           pntt.fft_plain(a, perm, tw))

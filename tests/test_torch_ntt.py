"""blockmaze_tpu_torch NTT against the JAX package: the plain versions of
the butterfly and pointwise-product kernels against the Pallas kernels
(interpret mode on the CPU), and the table-driven FFT pipeline against
jntt on basic (m = 16, 128) and step (m = 24, 48: big_m = 2 * small_m, the
mint shape) domains, each package on its own domain object. Exact
equality."""

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

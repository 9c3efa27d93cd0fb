"""blockmaze_tpu_torch field arithmetic (plain versions) against the JAX
package: Montgomery product, add, sub, neg, canon_wide on Fr and Fq, Fq2
mul/sqr, and the limb conversions. Integer results: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.curves import jcurve as jc
from blockmaze_tpu.fields import jfield as jf
from blockmaze_tpu.fields.constants import R_MONT
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

SPECS = {"Fr": (tf.FR, jf.FR), "Fq": (tf.FQ, jf.FQ)}


def _values(spec, n, seed):
    """Edge values 0, 1, p-1, R mod p, then random canonical values."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    edge = [0, 1, p - 1, R_MONT % p]
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    return edge + rand


def _pair(spec, seed, n=60):
    xs = _values(spec, n, seed)
    ys = list(reversed(_values(spec, n, seed + 1)))
    return tf.ints_to_limbs(xs), tf.ints_to_limbs(ys)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(t):
    return np.asarray(t).astype(np.int64)


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_spec_constants_match(field):
    ts, js = SPECS[field]
    assert (ts.modulus, ts.inv, ts.r_mod, ts.r2_mod) == \
        (js.modulus, js.inv, js.r_mod, js.r2_mod)
    assert np.array_equal(ts.p_limbs, js.p_limbs)
    assert np.array_equal(ts.one_mont, js.one_mont)


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_binary_ops_match_jfield(field, op):
    ts, js = SPECS[field]
    a, b = _pair(ts, seed=len(op) + len(field))
    got = getattr(tf, op)(ts, _t(a), _t(b)).numpy()
    want = _np(getattr(jf, op)(js, jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_neg_and_from_mont_match_jfield(field):
    ts, js = SPECS[field]
    a, _ = _pair(ts, seed=7)
    assert np.array_equal(tf.neg(ts, _t(a)).numpy(),
                          _np(jf.neg(js, jnp.asarray(a))))
    assert np.array_equal(tf.from_mont(ts, _t(a)).numpy(),
                          _np(jf.from_mont(js, jnp.asarray(a))))


@pytest.mark.parametrize("field", ["Fr", "Fq"])
def test_canon_wide_matches_jfield(field):
    """Row sums of up to 2^16 canonical limbs (the JAX bound, < 2^32), and
    sums past it that only the port's int64 path can hold."""
    ts, js = SPECS[field]
    rng = np.random.default_rng(11)
    wide = rng.integers(0, 1 << 32, size=(40, 16), dtype=np.int64)
    wide[0] = 0
    wide[1] = (1 << 32) - 1
    got = tf.canon_wide(ts, torch.from_numpy(wide)).numpy()
    want = _np(jf.canon_wide(js, jnp.asarray(wide.astype(np.uint32))))
    assert np.array_equal(got, want)
    big = rng.integers(0, 1 << 47, size=(20, 16), dtype=np.int64)
    vals = tf.limbs_to_ints(tf.from_mont(ts, tf.canon_wide(
        ts, torch.from_numpy(big))).numpy())
    p, rinv = ts.modulus, pow(R_MONT, -1, ts.modulus)
    exact = [sum(int(v) << (16 * j) for j, v in enumerate(row)) % p
             for row in big.tolist()]
    assert vals == [x * rinv % p for x in exact]


def test_fq2_mul_sqr_match_jcurve():
    a, b = _pair(tf.FQ, seed=3, n=40)
    a2 = a.reshape(-1, 2, 16)
    b2 = b.reshape(-1, 2, 16)
    got = tc.Fq2Ops.mul(_t(a2), _t(b2)).numpy()
    want = _np(jc.Fq2Ops.mul(jnp.asarray(a2), jnp.asarray(b2)))
    assert np.array_equal(got, want)
    assert np.array_equal(tc.Fq2Ops.sqr(_t(a2)).numpy(),
                          _np(jc.Fq2Ops.sqr(jnp.asarray(a2))))


def test_limb_round_trips():
    p = tf.FQ.modulus
    xs = _values(tf.FQ, 50, 5) + [(1 << 256) - 1]
    limbs = tf.ints_to_limbs(xs)
    assert np.array_equal(limbs, jf.ints_to_limbs(xs))
    assert tf.limbs_to_ints(limbs) == xs
    assert tf.limbs_to_ints(limbs.astype(np.int32)) == xs
    assert tf.limbs_to_ints(_t(limbs).numpy()) == xs
    ys = xs[:-1]
    mont = tf.to_mont_host(tf.FQ, ys)
    assert np.array_equal(mont, jf.to_mont_host(jf.FQ, ys))
    assert tf.from_mont_host(tf.FQ, mont) == [y % p for y in ys]
    t = tf.to_tensor(mont, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), mont)

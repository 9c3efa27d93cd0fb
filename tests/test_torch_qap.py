"""blockmaze_tpu_torch QAP kernels against the JAX package (plain versions,
on the CPU; exact equality): the CSR matvec against groth16/qap.py
sparse_matvec plus the input-consistency rows; the fused fft factors,
step_pre, step_post and qap_combine against jntt's compositions on basic
and step domains (compr = big_m / small_m of 2, 4 and 8); qap_h_arrays in
Montgomery and standard form against the JAX qap_h_arrays; and the
witness's Montgomery form on the device (a product by R^2) against the
host conversion."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.fields import jfield as jf
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.groth16 import qap as jqap
from blockmaze_tpu.ntt import domain as D
from blockmaze_tpu.ntt import jntt
from blockmaze_tpu.r1cs.examples import chain_circuit
from blockmaze_tpu.serialization import libsnark_io as jio
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.groth16 import keys, qap
from blockmaze_tpu_torch.ntt import domain as TD
from blockmaze_tpu_torch.ntt import pntt, tntt

from test_keygen import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

P = tf.FR.modulus


def _np(t):
    return np.asarray(t).astype(np.int64)


def _rand_fr(rng, n):
    return tf.to_mont_host(tf.FR, [int.from_bytes(rng.bytes(32), "little") % P
                                   for _ in range(n)])


def _cs(pb):
    return jio.ConstraintSystem(
        pb.primary_input_size, pb.auxiliary_input_size,
        [tuple(list(lc.as_dict().items()) for lc in cons)
         for cons in pb.constraints])


def _random_cs(rng):
    """40 constraints over 50 variables: A and C rows of 0-3 terms, B rows
    of 0-3 terms but for one of 100 (longer than keys.LONG_ROW) and one of
    exactly LONG_ROW; random coefficients, many rows empty."""
    def lc(n):
        return [(int(v), int.from_bytes(rng.bytes(32), "little") % P)
                for v in rng.integers(0, 51, n)]
    cons = []
    for i in range(40):
        nb = 100 if i == 7 else keys.LONG_ROW if i == 11 else rng.integers(4)
        cons.append((lc(rng.integers(4)), lc(nb), lc(rng.integers(4))))
    return jio.ConstraintSystem(2, 48, cons)


def _key_view(cs, coos):
    """What keys.build_csr reads of a DevicePK, for a bare constraint
    system."""
    n_inp, ncons = cs.primary_input_size, len(cs.constraints)
    fields = {f"{k}_{p}": coo[j] for k, coo in zip("abc", coos)
              for j, p in enumerate(("row", "var", "coeff"))}
    return types.SimpleNamespace(
        num_constraints=ncons, primary_input_size=n_inp,
        domain_size=D.get_evaluation_domain(ncons + n_inp + 1).m, **fields)


def _csr_tensors(csr):
    return keys.MatrixCSR(*(tf.to_tensor(getattr(csr, f), "cpu")
                            for f in ("ptr", "var", "coeff", "long_rows")))


def _witness(cs, rng, pb=None):
    n = cs.primary_input_size + cs.auxiliary_input_size
    vals = [1] + (pb.primary_input() + pb.auxiliary_input() if pb else
                  [int.from_bytes(rng.bytes(32), "little") % P
                   for _ in range(n)])
    return tf.to_mont_host(tf.FR, vals)


@pytest.mark.parametrize("case", ["toy", "chain120", "random"])
def test_qap_matvec_plain_matches_jax_sparse_matvec(case):
    """The stacked CSR's plain matvec equals the JAX sparse_matvec of each
    matrix, with A's input-consistency rows set as the JAX qap_h_arrays
    sets them; empty rows (C's and every row past the constraints) are
    zero, and the CSR lists exactly the rows of more than LONG_ROW terms."""
    rng = np.random.default_rng(7)
    pb = None
    if case == "toy":
        pb = toy_circuit(1234567 ** 2 % P, 1234567)
    elif case == "chain120":
        pb = chain_circuit(120)
    cs = _cs(pb) if pb else _random_cs(rng)
    coos = jkeys._cs_to_coo(cs)
    view = _key_view(cs, coos)
    m, ncons, n_inp = view.domain_size, len(cs.constraints), \
        cs.primary_input_size
    w = _witness(cs, rng, pb)
    csr = keys.build_csr(view)
    counts = np.diff(csr.ptr.astype(np.int64))
    assert csr.ptr.shape == (3 * m + 1,) and csr.coeff.shape[1] == 16
    assert np.array_equal(csr.long_rows,
                          np.flatnonzero(counts > keys.LONG_ROW))
    assert (case == "random") == (csr.long_rows.size > 0)
    assert (counts == 0).any() and counts[ncons:m].sum() == n_inp + 1
    got = _np(qap.qap_matvec(_csr_tensors(csr), tf.to_tensor(w, "cpu")))
    got = got.reshape(3, m, 16)
    jw = jnp.asarray(w)
    want = [np.asarray(jqap.sparse_matvec(jnp.asarray(r), jnp.asarray(v),
                                          jnp.asarray(c), jw, m))
            for r, v, c in coos]
    want[0] = want[0].copy()
    want[0][ncons:ncons + n_inp + 1] = w[:n_inp + 1]
    for k in range(3):
        assert np.array_equal(got[k], _np(want[k])), "abc"[k]
    assert np.array_equal(got[0][ncons:ncons + n_inp + 1],
                          _np(w[:n_inp + 1]))
    assert not got[:, ncons + n_inp + 1:].any()


def _tables(min_size):
    d = D.get_evaluation_domain(min_size)
    td = TD.get_evaluation_domain(min_size)
    T = tntt.tables_to({**tntt.qap_tables(td), **tntt.std_tables(td)}, "cpu")
    return d, td, jntt.qap_tables(d), T


def _std(a):
    """Standard-form limbs of Montgomery limbs (JAX side)."""
    return _np(jf.from_mont(jf.FR, jnp.asarray(np.asarray(a, np.uint32))))


@pytest.mark.parametrize("min_size", [16, 128, 24, 48, 20, 36],
                         ids=["basic16", "basic128", "step24", "step48",
                              "step20_compr4", "step36_compr8"])
def test_fused_kernels_match_jntt(min_size):
    """fft with pre/scale/post (basic), step_pre / step_post around the
    two FFTs (step), and qap_combine: each plain version against the jntt
    composition it replaces; then tntt's public functions (which call the
    wrappers) against jntt's, the inverse coset FFT also in standard
    form."""
    d, td, JT, T = _tables(min_size)
    step = isinstance(td, TD.StepDomain)
    assert step == isinstance(d, D.StepDomain) == (min_size in (24, 48, 20,
                                                                36))
    if step:
        assert td.big_m // td.small_m == {24: 2, 48: 2, 20: 4, 36: 8}[
            min_size]
    rng = np.random.default_rng(min_size + 3)
    a, b, c = (_rand_fr(rng, d.m) for _ in range(3))
    ta = tf.to_tensor(a, "cpu")
    ja = jnp.asarray(a)
    want = {name: _np(getattr(jntt, name)(d, ja, JT))
            for name in ("fft_t", "ifft_t", "coset_fft_t", "icoset_fft_t")}
    if step:
        big = td.big_m
        for name, coset in (("fft_t", None), ("coset_fft_t", T["coset"])):
            x = pntt.step_pre_plain(ta, T["omega_pows"], td.small_m, coset)
            got = torch.cat([
                pntt.fft_plain(x[:big], T["big_perm"], T["big_fwd"]),
                pntt.fft_plain(x[big:], T["small_perm"], T["small_fwd"])])
            assert np.array_equal(_np(got), want[name]), name
        u0 = pntt.fft_plain(ta[:big], T["big_perm"], T["big_inv"])
        u1 = pntt.fft_plain(ta[big:], T["small_perm"], T["small_inv"])
        for name, post in (("ifft_t", None), ("icoset_fft_t",
                                              T["coset_inv"])):
            got = pntt.step_post_plain(
                u0, u1, T["omega_pows"], T["omega_inv_pows"], T["big_minv"],
                T["small_minv"], T["half"], post)
            assert np.array_equal(_np(got), want[name]), name
    else:
        cases = (("coset_fft_t", T["fwd"], {"pre": T["coset"]}),
                 ("ifft_t", T["inv"], {"scale": T["minv"]}),
                 ("icoset_fft_t", T["inv"], {"scale": T["minv"],
                                             "post": T["coset_inv"]}))
        for name, tw, factors in cases:
            got = pntt.fft_plain(ta, T["perm"], tw, **factors)
            assert np.array_equal(_np(got), want[name]), name
    for name, w in want.items():
        assert np.array_equal(_np(getattr(tntt, name)(td, ta, T)), w), name
    assert np.array_equal(_np(tntt.icoset_fft_t(td, ta, T, std=True)),
                          _std(want["icoset_fft_t"]))
    jb, jc = jnp.asarray(b), jnp.asarray(c)
    want_h = jntt.divide_by_z_t(jf.sub(jf.FR, jf.mont_mul(jf.FR, ja, jb),
                                       jc), JT)
    got_h = pntt.qap_combine(ta, tf.to_tensor(b, "cpu"),
                             tf.to_tensor(c, "cpu"), T["zinv"])
    assert got_h.dtype == torch.int32
    assert np.array_equal(_np(got_h), _np(want_h))


@pytest.mark.parametrize("ncons,kind", [(120, "basic"), (94, "step"),
                                        (78, "step")],
                         ids=["chain120_basic128", "chain94_step96",
                              "chain78_step80_compr4"])
def test_qap_h_arrays_matches_jax(ncons, kind):
    """The port's qap_h_arrays (plain versions) equals the JAX package's on
    the same witness and matrices, in Montgomery form and, with std=True,
    in standard form (what the prover's H MSM takes)."""
    pb = chain_circuit(ncons)
    cs = _cs(pb)
    coos = jkeys._cs_to_coo(cs)
    view = _key_view(cs, coos)
    d, td, JT, T = _tables(ncons + 2)
    assert td.kind == d.kind == kind and td.m == view.domain_size
    w = _witness(cs, None, pb)
    csr = _csr_tensors(keys.build_csr(view))
    want = jqap.qap_h_arrays(
        d, (len(cs.constraints), cs.primary_input_size),
        tuple(tuple(jnp.asarray(x) for x in coo) for coo in coos),
        jnp.asarray(w), tables=JT)
    tw = tf.to_tensor(w, "cpu")
    got = qap.qap_h_arrays(td, csr, tw, T)
    assert got.shape == (d.m, 16) and got.dtype == torch.int32
    assert np.array_equal(_np(got), _np(want))
    got_std = qap.qap_h_arrays(td, csr, tw, T, std=True)
    assert np.array_equal(_np(got_std), _std(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_witness_montgomery_form_by_r2(seed):
    """mul_elementwise(x, R^2 mod r) = x*R mod r for every x < 2^256: the
    prover's on-device witness conversion equals the host's to_mont_host
    at 0, 1, r - 1, r, 2^256 - 1 and random values (some >= r)."""
    rng = np.random.default_rng(seed)
    xs = [0, 1, P - 1, P, P + 1, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    std = tf.to_tensor(tf.ints_to_limbs(xs), "cpu")
    got = pntt.mul_elementwise(std, tf.to_tensor(tf.FR.r2_limbs[None],
                                                 "cpu"))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), _np(tf.to_mont_host(tf.FR, xs)))
    assert np.array_equal(_np(got), _np(jf.to_mont_host(jf.FR, xs)))

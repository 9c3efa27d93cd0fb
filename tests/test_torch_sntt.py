"""blockmaze_tpu_torch's sharded 4-step NTT (parallel/sntt.py) on a mesh of
CPU shards against the single-device port (ntt/tntt.py), the JAX
package's single-chip jntt and its sharded sntt on the conftest's 8
virtual devices; and the batched fft (a batch of FFTs stored one after
the other) against one FFT per block. Inputs come from a seeded
random.Random, through numpy, to both packages; every comparison is
exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.ntt import domain as JD
from blockmaze_tpu.ntt import jntt
from blockmaze_tpu.parallel import mesh as jmesh
from blockmaze_tpu.parallel import sntt as jsntt
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.ntt import domain as D
from blockmaze_tpu_torch.ntt import pntt, tntt
from blockmaze_tpu_torch.ntt.domain import MULT_GEN
from blockmaze_tpu_torch.parallel import mesh as pm
from blockmaze_tpu_torch.parallel import sntt

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

FR = tf.FR


@pytest.fixture(scope="module")
def mesh8():
    return pm.Mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh8():
    return jmesh.make_mesh(8)


def _poly(seed, m):
    """(numpy Montgomery limbs, torch tensor) of m random field values."""
    r = random.Random(seed)
    a = tf.to_mont_host(FR, [r.randrange(R_MOD) for _ in range(m)])
    return a, tf.to_tensor(a, "cpu")


def _tables(dom):
    return tntt.tables_to({**tntt.qap_tables(dom), **tntt.std_tables(dom)},
                          "cpu")


def _jdom(dom):
    """The JAX package's domain of the same size (its functions dispatch
    on its own domain classes)."""
    return JD.get_evaluation_domain(dom.m)


def _same(t, jax_out):
    return np.array_equal(t.numpy().astype(np.uint32), np.asarray(jax_out))


@pytest.mark.parametrize("logm", [6, 8])
def test_sharded_fft_matches_single_device_and_jax(mesh8, jax_mesh8, logm):
    dom = D.get_evaluation_domain(1 << logm)
    host, a = _poly(logm, dom.m)
    got = sntt.sharded_fft(mesh8, dom, a)
    assert torch.equal(got, tntt.fft_t(dom, a, _tables(dom)))
    assert _same(got, jntt.fft(_jdom(dom), jnp.asarray(host)))
    assert _same(got, jsntt.sharded_fft(jax_mesh8, _jdom(dom),
                                        jnp.asarray(host)))


@pytest.mark.parametrize("logm", [6, 8])
def test_sharded_ifft_roundtrip(mesh8, jax_mesh8, logm):
    dom = D.get_evaluation_domain(1 << logm)
    host, a = _poly(100 + logm, dom.m)
    fwd = sntt.sharded_fft(mesh8, dom, a)
    back = sntt.sharded_fft(mesh8, dom, fwd, inverse=True)
    assert torch.equal(back, a)
    inv = sntt.sharded_fft(mesh8, dom, a, inverse=True)
    assert torch.equal(inv, tntt.ifft_t(dom, a, _tables(dom)))
    assert _same(inv, jsntt.sharded_fft(jax_mesh8, _jdom(dom),
                                        jnp.asarray(host), inverse=True))


@pytest.mark.parametrize("logm", [6, 8])
def test_sharded_coset_pipeline(mesh8, jax_mesh8, logm):
    """coset FFT and inverse coset FFT over the mesh against the single
    device's and the JAX package's single-chip and sharded ones."""
    dom = D.get_evaluation_domain(1 << logm)
    host, a = _poly(200 + logm, dom.m)
    T = _tables(dom)
    got = sntt.sharded_coset_fft(mesh8, dom, a, MULT_GEN)
    assert torch.equal(got, tntt.coset_fft_t(dom, a, T))
    assert _same(got, jntt.coset_fft(_jdom(dom), jnp.asarray(host)))
    assert _same(got, jsntt.sharded_coset_fft(jax_mesh8, _jdom(dom),
                                              jnp.asarray(host), MULT_GEN))
    back = sntt.sharded_icoset_fft(mesh8, dom, got, MULT_GEN)
    assert torch.equal(back, a)
    assert torch.equal(sntt.sharded_icoset_fft(mesh8, dom, a, MULT_GEN),
                       tntt.icoset_fft_t(dom, a, T))


@pytest.mark.parametrize("shards", [2, 4])
def test_step_domain_matches_jntt(shards):
    """The step domain's FFT and inverse FFT (m = 192 = 128 + 64) over the
    mesh against jntt (the JAX test's input, 5^i), and its coset pair
    against the single-device port."""
    mesh = pm.Mesh(["cpu"] * shards)
    dom = D.get_evaluation_domain(172)
    assert dom.kind == "step" and dom.m == 192
    host = tf.to_mont_host(FR, [pow(5, i, R_MOD) for i in range(dom.m)])
    a = tf.to_tensor(host, "cpu")
    jdom, ja = _jdom(dom), jnp.asarray(host)
    assert _same(sntt.s_fft(mesh, dom, a), jntt.fft(jdom, ja))
    assert _same(sntt.s_ifft(mesh, dom, a), jntt.ifft(jdom, ja))
    T = _tables(dom)
    got = sntt.sharded_coset_fft(mesh, dom, a, MULT_GEN)
    assert torch.equal(got, tntt.coset_fft_t(dom, a, T))
    assert torch.equal(sntt.sharded_icoset_fft(mesh, dom, got, MULT_GEN), a)


def test_can_shard():
    assert sntt.can_shard(1 << 8, 8) and sntt.can_shard(1 << 20, 4)
    assert not sntt.can_shard(1 << 5, 8)       # m1 = 4 < 8 shards
    assert not sntt.can_shard(192, 2)          # not a power of two
    with pytest.raises(ValueError):
        sntt.fft_tabs(1 << 5, D.get_evaluation_domain(32).omega, 8)


@pytest.mark.parametrize("logm,batch", [(5, 3), (4, 8)])
def test_batched_fft_matches_per_block(logm, batch):
    """fft over `batch` blocks of m rows (the pntt.fft wrapper on CPU
    tensors: fft_plain), forward with the coset as pre and inverse with
    1/m and coset^-1, against one FFT per block and against jntt."""
    dom = D.get_evaluation_domain(1 << logm)
    m = dom.m
    T = _tables(dom)
    host, a = _poly(300 + logm, batch * m)
    pre = torch.cat([T["coset"]] * batch)
    post = torch.cat([T["coset_inv"]] * batch)
    for kw, table, jfn in (
            ({}, "fwd", jntt.fft),
            ({"pre": pre}, "fwd", jntt.coset_fft),
            ({"scale": T["minv"], "post": post}, "inv", jntt.icoset_fft)):
        got = pntt.fft(a, T["perm"], T[table], **kw)
        for b in range(batch):
            rows = slice(b * m, (b + 1) * m)
            one = {k: (v if k == "scale" else v[rows])
                   for k, v in kw.items()}
            assert torch.equal(got[rows],
                               pntt.fft(a[rows], T["perm"], T[table], **one))
            assert _same(got[rows],
                         jfn(_jdom(dom), jnp.asarray(host[rows])))

"""blockmaze_tpu_torch keygen (plain versions on the CPU) against the JAX
package: the Fermat inversions behind the kernel's affine normalisation,
the plain fixed_base_exp (window ladder plus normalisation) against the JAX
package's fixed_base_exp and its host affine conversion, and the DevicePK
and vk that generate_cached builds straight from the kernel's limbs and
keygen's COO lists against jkeys.build_device_pk of the JAX package's keys
from the same toxic waste. Inputs are made from numpy seeds; group elements
compare after affine normalisation."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockmaze_tpu.curves import host_curve as jHC
from blockmaze_tpu.curves import jcurve as jc
from blockmaze_tpu.fields import host as jhf
from blockmaze_tpu.fields import jfield as jf
from blockmaze_tpu.fields.constants import Q_MOD, R_MOD
from blockmaze_tpu.groth16 import generator as jgen
from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.r1cs.protoboard import LC, Protoboard
from blockmaze_tpu.serialization import libsnark_io as jio
from blockmaze_tpu_torch.curves import tcurve as tc
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.groth16 import generator, keys
from blockmaze_tpu_torch.msm import pippenger as pp

from test_keygen import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

SEED = 8


def _rand_ints(rng, n, mod):
    return [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]


def _mont(spec, xs):
    return torch.from_numpy(tf.to_mont_host(spec, xs).astype(np.int64))


# ---------------------------------------------------------------------------
# Inversions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [tf.FQ, tf.FR], ids=["Fq", "Fr"])
def test_inv_matches_pow(spec):
    p = spec.modulus
    xs = [1, 2, p - 1, p - 2, 1 << 200] + _rand_ints(
        np.random.default_rng(SEED), 11, p)
    got = tf.from_mont_host(spec, tf.inv(spec, _mont(spec, xs)).numpy())
    assert got == [pow(x, -1, p) for x in xs]
    assert tf.is_zero(tf.inv(spec, torch.zeros((2, tf.N),
                                               dtype=torch.int64))).all()


def test_fq2_inv_matches_host():
    rng = np.random.default_rng(SEED + 1)
    vals = [(1, 0), (Q_MOD - 1, 0), (0, 1), (0, Q_MOD - 1), (1, 1),
            (0, 0)] + list(zip(_rand_ints(rng, 10, Q_MOD),
                               _rand_ints(rng, 10, Q_MOD)))
    a = torch.stack([_mont(tf.FQ, [v[0] for v in vals]),
                     _mont(tf.FQ, [v[1] for v in vals])], 1)
    got = tc.Fq2Ops.inv(a).numpy()
    g0 = tf.from_mont_host(tf.FQ, got[:, 0])
    g1 = tf.from_mont_host(tf.FQ, got[:, 1])
    want = [jhf.FQ2_ZERO if v == jhf.FQ2_ZERO else jhf.fq2_inv(v)
            for v in vals]
    assert list(zip(g0, g1)) == want


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_jacobian_to_affine_matches_jax(curve):
    """Random multiples k*G rescaled to Jacobian (x l^2, y l^3, l), and
    infinity, against jcurve's host conversion and back to limbs."""
    rng = np.random.default_rng(SEED + 2)
    n = 12
    ks = [0, 1] + _rand_ints(rng, n - 2, R_MOD)
    if curve == "g1":
        pts = [jHC.g1_mul(jHC.g1_generator(), k) for k in ks]
        lam = _rand_ints(rng, n, Q_MOD - 1)
        X = [p[0] * (l + 1) ** 2 % Q_MOD for p, l in zip(pts, lam)]
        Y = [p[1] * (l + 1) ** 3 % Q_MOD for p, l in zip(pts, lam)]
        Z = [0 if p[2] else l + 1 for p, l in zip(pts, lam)]
        P = tuple(_mont(tf.FQ, v) for v in (X, Y, Z))
        conv, to_host = jc.g1_affine_to_device, jc.g1_jacobian_to_host
    else:
        pts = [jHC.g2_mul(jHC.g2_generator(), k) for k in ks]
        lam = list(zip(_rand_ints(rng, n, Q_MOD), _rand_ints(rng, n, Q_MOD)))
        cols = {"X": [], "Y": [], "Z": []}
        for p, l in zip(pts, lam):
            l2 = jhf.fq2_sqr(l)
            cols["X"].append(jhf.fq2_mul(p[0], l2))
            cols["Y"].append(jhf.fq2_mul(p[1], jhf.fq2_mul(l2, l)))
            cols["Z"].append(jhf.FQ2_ZERO if p[2] else l)
        P = tuple(torch.stack([_mont(tf.FQ, [v[0] for v in cols[c]]),
                               _mont(tf.FQ, [v[1] for v in cols[c]])], 1)
                  for c in "XYZ")
        conv, to_host = jc.g2_affine_to_device, jc.g2_jacobian_to_host
    x, y, inf = tc.jacobian_to_affine(curve, P)
    wx, wy, winf = conv(to_host(tuple(t.numpy().astype(np.uint32)
                                      for t in P)))
    assert np.array_equal(x.numpy().view(np.uint32), wx)
    assert np.array_equal(y.numpy().view(np.uint32), wy)
    assert np.array_equal(inf.numpy(), winf)
    assert inf.numpy().tolist() == [bool(p[2]) for p in pts]


# ---------------------------------------------------------------------------
# fixed_base_exp
# ---------------------------------------------------------------------------

def _edge_scalars(rng, n):
    """0, 1, r-1, powers of two, scalars whose bytes are 0 or 255 in some
    windows, then random ones."""
    s = [0, 1, R_MOD - 1, R_MOD - 2, 2, 1 << 8, 1 << 100, 1 << 252, 255,
         0xff << 240, (1 << 248) - 1, int("ff00" * 16, 16) % R_MOD,
         int("00ff" * 16, 16) % R_MOD, 255 << 8]
    return s + _rand_ints(rng, n - len(s), R_MOD)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_fixed_base_exp_matches_jax(curve):
    """The plain fixed_base_exp (blinded ladder + Fermat normalisation) on
    64 scalars against the JAX package's fixed_base_exp (complete mixed adds
    in XLA) and jcurve's host conversion: the same affine points, as host
    ints and as the key's Montgomery limbs."""
    sc = _edge_scalars(np.random.default_rng(SEED + 3), 64)
    if curve == "g1":
        base, host_table = jHC.g1_generator(), jgen._host_window_table_g1
        to_host, conv = jc.g1_jacobian_to_host, jc.g1_affine_to_device
    else:
        base, host_table = jHC.g2_generator(), jgen._host_window_table_g2
        to_host, conv = jc.g2_jacobian_to_host, jc.g2_affine_to_device
    jt = jgen._table_to_device(host_table(base), g2=curve == "g2")
    want = to_host(jgen.fixed_base_exp(
        curve, jt, jnp.asarray(jf.ints_to_limbs(sc))))
    table = generator.window_table(curve, base, "cpu")
    limbs = torch.from_numpy(tf.ints_to_limbs(sc).view(np.int32))
    x, y, inf = generator.fixed_base_exp(curve, table, limbs,
                                         pp.make_blind(curve, "cpu")[1])
    arrays = (x.numpy().view(np.uint32), y.numpy().view(np.uint32),
              inf.numpy())
    assert generator._host_points(curve, arrays) == want
    for got, w in zip(arrays, conv(want)):
        assert got.dtype == w.dtype and np.array_equal(got, w)
    assert arrays[2].tolist() == [s == 0 for s in sc]


def test_pack_table_layout():
    """Entry w * 2^c + d of the kernel's table holds T[w][d]'s x then y as
    32-bit words (G1: 8 + 8, G2: c0 and c1 of x, then of y)."""
    def unpack(words):
        w = words.to(torch.int64) & 0xffffffff
        return torch.stack([w & 0xffff, w >> 16], -1).reshape(
            w.shape[0], -1)

    for curve, base in (("g1", jHC.g1_generator()),
                        ("g2", jHC.g2_generator())):
        table = generator.window_table(curve, base, "cpu")
        tx, ty, packed = table.x, table.y, table.packed
        assert torch.equal(table.flags, table.inf.to(torch.uint8))
        half = packed.shape[1] // 2
        n = tx.shape[0] * tx.shape[1]
        assert packed.dtype == torch.int32 and packed.shape[0] == n
        assert torch.equal(unpack(packed[:, :half]), tx.reshape(n, -1).long())
        assert torch.equal(unpack(packed[:, half:]), ty.reshape(n, -1).long())


# ---------------------------------------------------------------------------
# generate_cached's DevicePK against the JAX package's
# ---------------------------------------------------------------------------

def random_r1cs(seed: int, ncons: int = 200, nvars: int = 240,
                ninputs: int = 3, unused: int = 30):
    """A seeded random R1CS (JAX Protoboard; keygen only reads its
    constraints and sizes): `unused` variables appear in no constraint
    (zero scalars: infinity in A, B and L), B rows of one or two terms, and
    coefficients 1, r - 1 or random, plus some constants."""
    rng = np.random.default_rng(seed)
    pb = Protoboard()
    for _ in range(nvars):
        pb.allocate()
    pb.set_input_sizes(ninputs)
    used = rng.permutation(np.arange(1, nvars + 1))[:nvars - unused]

    def lc(most):
        out = LC()
        for v in rng.choice(used, size=int(rng.integers(1, most + 1)),
                            replace=False):
            c = [1, R_MOD - 1, int(rng.integers(2, 1 << 62))][
                int(rng.integers(3))]
            out = out + LC.var(int(v), c)
        if rng.random() < 0.3:
            out = out + int(rng.integers(1, 100))
        return out

    for _ in range(ncons):
        pb.add_constraint(lc(4), lc(2), lc(3))
    return pb


def _toy():
    w = 1234567
    return toy_circuit(w * w % R_MOD, w)


CIRCUITS = {"toy": _toy, "random": lambda: random_r1cs(SEED)}
KEY_SEED = 5


def _toxic():
    r = random.Random(KEY_SEED)
    return lambda: r.randrange(1, R_MOD)


@pytest.fixture(scope="module", params=sorted(CIRCUITS))
def keygens(request, tmp_path_factory):
    """One circuit's keys: the JAX package's (pk, vk, DevicePK) and the
    port's generate_cached (DevicePK, vk, vk path) with the toxic waste of
    random.Random(KEY_SEED)."""
    pb = CIRCUITS[request.param]()
    jpk, jvk = jgen.generate(pb, rng=_toxic())
    cache = str(tmp_path_factory.mktemp(f"keys_{request.param}"))
    timings = {}
    dpk, vk, generated = generator.generate_cached(
        pb, request.param, KEY_SEED, cache, "cpu", timings=timings)
    assert generated
    assert set(timings) == {"qap", "tables", "exp", "build", "write"}
    return dict(pb=pb, jpk=jpk, jvk=jvk, jdpk=jkeys.build_device_pk(jpk),
                dpk=dpk, vk=vk, cache=cache, name=request.param)


def test_generate_cached_matches_jax(keygens, tmp_path):
    """Every DevicePK field and array equal (values, dtypes, shapes) to
    jkeys.build_device_pk of the JAX package's key, and the vk file equal
    to the JAX package's vk text."""
    dpk, jdpk = keygens["dpk"], keygens["jdpk"]
    for f in dataclasses.fields(dpk):
        got, want = getattr(dpk, f.name), getattr(jdpk, f.name)
        if f.name in keys._POINT_FIELDS:
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                f.name
        else:
            assert got == want, f.name
    if keygens["name"] == "random":     # zero scalars: infinity points
        assert dpk.A[2].any() and dpk.L[2].any()
    jpath = str(tmp_path / "jvk.txt")
    jio.write_verification_key(jpath, keygens["jvk"])
    base = f"{keygens['cache']}/{keygens['name']}_s{KEY_SEED}"
    with open(f"{base}_vk.txt") as a, open(jpath) as b:
        assert a.read() == b.read()
    # a second call takes the cache
    again, vk2, generated = generator.generate_cached(
        keygens["pb"], keygens["name"], KEY_SEED, keygens["cache"], "cpu")
    assert not generated and vk2 == keygens["vk"]
    assert np.array_equal(again.H[0], dpk.H[0])


def test_coo_arrays_match_cs_to_coo(keygens):
    """The COO arrays built from keygen's lists (coefficients in Montgomery
    form by mul_elementwise by R^2) equal keys._cs_to_coo of the
    ConstraintSystem that generate returns for the same toxic waste; and
    generate's keys equal the JAX package's."""
    pk, vk = generator.generate(keygens["pb"], "cpu", rng=_toxic())
    assert dataclasses.asdict(pk) == dataclasses.asdict(keygens["jpk"])
    assert dataclasses.asdict(vk) == dataclasses.asdict(keygens["jvk"])
    dpk = keygens["dpk"]
    for k, (rows, vars_, coeffs) in zip("abc", keys._cs_to_coo(pk.cs)):
        assert np.array_equal(getattr(dpk, f"{k}_row"), rows)
        assert np.array_equal(getattr(dpk, f"{k}_var"), vars_)
        got = getattr(dpk, f"{k}_coeff")
        assert got.dtype == coeffs.dtype and np.array_equal(got, coeffs)

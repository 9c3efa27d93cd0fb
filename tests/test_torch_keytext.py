"""blockmaze_tpu_torch's text-key path (serialization/native_io.py over the
host tokenizer csrc/keyparse.cpp, curves/decompress.py, keys.load_text_pk)
against the JAX package's Python reader, on the CPU: the tokenizer built
with g++ as the card's host builds it, the decompression kernels' plain
versions. Keys come from the port's seeded keygen (equal to the JAX
package's, tests/test_torch_prover.py) of the toy circuit and
r1cs/examples.py chain circuits, written with the port's
write_proving_key; every DevicePK field must equal the JAX package's
build_device_pk(io.load_proving_key(path)) exactly."""

import ctypes
import dataclasses
import os
import random
import re

import numpy as np
import pytest
import torch

from blockmaze_tpu.groth16 import keys as jkeys
from blockmaze_tpu.serialization import libsnark_io as jio
from blockmaze_tpu_torch.curves import decompress as dc
from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.fields import host as hf
from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.fields.constants import Q_MOD, R_MOD
from blockmaze_tpu_torch.groth16 import generator, keys
from blockmaze_tpu_torch.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.serialization import libsnark_io as io
from blockmaze_tpu_torch.serialization import native_io
from blockmaze_tpu_torch.utils import kernels as kn

from test_keygen import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

CIRCUITS = {"toy": lambda: toy_circuit(1234567 ** 2 % R_MOD, 1234567),
            "chain30": lambda: chain_circuit(30),
            "chain120": lambda: chain_circuit(120)}


@pytest.fixture(scope="module")
def proving_keys():
    """name -> the port's io.ProvingKey of the circuit, seeded keygen."""
    out = {}
    for seed, (name, make) in enumerate(CIRCUITS.items()):
        rnd = random.Random(seed)
        out[name] = generator.generate(
            make(), "cpu", rng=lambda: rnd.randrange(1, R_MOD))[0]
    return out


def _written(tmp_path, pk, name="pk.txt") -> str:
    path = str(tmp_path / name)
    io.write_proving_key(path, pk)
    return path


def assert_dpk_equal(got, want):
    """Field by field: ints and host points equal, arrays equal in shape
    and values (and dtype, unless the JAX array is an empty float array,
    which np.array of an empty list gives)."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        pairs = zip(a, b) if isinstance(b, tuple) and isinstance(
            b[0], np.ndarray) else [(a, b)]
        for x, y in pairs:
            if isinstance(y, np.ndarray):
                assert x.shape == y.shape and np.array_equal(x, y), f.name
                assert x.dtype == y.dtype or y.size == 0, f.name
            else:
                assert x == y, f.name


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_load_text_pk_matches_jax(proving_keys, tmp_path, name):
    path = _written(tmp_path, proving_keys[name])
    want = jkeys.build_device_pk(jio.load_proving_key(path))
    timings = {}
    got = keys.load_text_pk(path, device="cpu", timings=timings)
    assert_dpk_equal(got, want)
    assert set(timings) == {"tokenize", "upload", "decompress", "coeffs",
                            "build"}


def test_zero_points(proving_keys, tmp_path):
    """Infinity points in every query, G1 and G2 (the zero flag set), and
    a key whose B query is empty."""
    pk = proving_keys["chain30"]
    z1, z2 = (0, 0, 1), (hf.FQ2_ZERO, hf.FQ2_ZERO, 1)
    with_zeros = dataclasses.replace(
        pk, A_query=[z1] + pk.A_query[1:],
        B_g2=pk.B_g2[:1] + [z2] + pk.B_g2[2:],
        B_g1=pk.B_g1[:2] + [z1] + pk.B_g1[3:],
        H_query=pk.H_query[:-1] + [z1], L_query=[z1, z1] + pk.L_query[2:])
    no_b = dataclasses.replace(pk, B_indices=[], B_g2=[], B_g1=[])
    for i, key in enumerate((with_zeros, no_b)):
        path = _written(tmp_path, key, f"pk{i}.txt")
        want = jkeys.build_device_pk(jio.load_proving_key(path))
        got = keys.load_text_pk(path, device="cpu")
        assert_dpk_equal(got, want)
        assert_dpk_equal(got, keys.build_device_pk(io.load_proving_key(path)))
    assert got.B2[0].shape == (0, 2, tf.N) and got.B1[0].shape == (0, tf.N)


def _off_curve_g1() -> int:
    return next(x for x in range(1, 100)
                if hf.fq_sqrt((x ** 3 + 3) % Q_MOD) is None)


def _off_curve_g2():
    b = HC.g2_b_coeff()
    return next((x, 1) for x in range(1, 100)
                if hf.fq2_sqrt(hf.fq2_add(hf.fq2_mul(hf.fq2_sqr((x, 1)),
                                                     (x, 1)), b)) is None)


def test_off_curve_point_raises(proving_keys, tmp_path):
    """An x off its curve raises ValueError naming the query and index, as
    the Python reader raises."""
    pk = proving_keys["chain30"]
    bad1 = dataclasses.replace(
        pk, H_query=pk.H_query[:3] + [(_off_curve_g1(), 0, 0)]
        + pk.H_query[4:])
    bad2 = dataclasses.replace(
        pk, B_g2=pk.B_g2[:1] + [(_off_curve_g2(), (0, 0), 0)] + pk.B_g2[2:])
    for i, (key, where) in enumerate(((bad1, r"H\[3\]"), (bad2, r"B\[1\]"))):
        path = _written(tmp_path, key, f"bad{i}.txt")
        with pytest.raises(ValueError, match="not on"):
            jio.load_proving_key(path)
        with pytest.raises(ValueError, match=where):
            keys.load_text_pk(path, device="cpu")


def test_malformed_file_raises(proving_keys, tmp_path):
    """A truncated file, a token of more than 256 bits, a token that is no
    number and an index past INT32_MAX each raise ValueError with the byte
    offset."""
    path = _written(tmp_path, proving_keys["toy"])
    with open(path, "rb") as f:
        text = f.read()
    cut = tmp_path / "cut.txt"
    cut.write_bytes(text[:len(text) * 2 // 3])
    with pytest.raises(ValueError, match="truncated.*byte offset"):
        native_io.parse_pk_text(str(cut))
    first = text.split(b"\n", 1)[0].split(b" ")      # alpha_g1: 0 x lsb
    for token, what in ((str(1 << 256).encode(),
                         "G1 x of more than 256 bits"),
                        (b"12x4", "not a decimal G1 x")):
        bad = tmp_path / "bad.txt"
        bad.write_bytes(b" ".join([first[0], token, first[2]])
                        + text[len(b" ".join(first)):])
        with pytest.raises(ValueError, match=f"{what} at byte offset 2"):
            native_io.parse_pk_text(str(bad))
    with pytest.raises(ValueError, match="cannot open"):
        native_io.parse_pk_text(str(tmp_path / "absent.txt"))
    # indices the arrays hold as int32: one past INT32_MAX raises
    pk = proving_keys["toy"]
    big = 1 << 31
    a, b, c = pk.cs.constraints[0]
    cs = dataclasses.replace(pk.cs, constraints=[
        ([(big, a[0][1])] + a[1:], b, c)] + pk.cs.constraints[1:])
    for bad_pk, what in (
            (dataclasses.replace(pk, cs=cs), "variable index"),
            (dataclasses.replace(pk, B_indices=[big] + pk.B_indices[1:]),
             "B_query index")):
        path = _written(tmp_path, bad_pk, "big.txt")
        with pytest.raises(ValueError, match=f"{what} {big} larger than an "
                           f"int32 holds at byte offset [0-9]+"):
            native_io.parse_pk_text(path)


def test_tokenizer_arrays(proving_keys, tmp_path):
    """The tokenizer's own arrays: x in standard form with parity and zero
    flag, B's indices, the COO in keys._cs_to_coo's order with standard
    coefficients reduced mod r (a coefficient written as r + k reads as
    k)."""
    pk = proving_keys["toy"]
    k = 123456789
    a, b, c = pk.cs.constraints[0]
    cs = dataclasses.replace(pk.cs, constraints=[
        ([(a[0][0], k)] + a[1:], b, c)] + pk.cs.constraints[1:])
    path = _written(tmp_path, dataclasses.replace(pk, cs=cs))
    with open(path) as f:
        text = f.read()
    assert text.count(f"\n{k}\n") == 1
    with open(path, "w") as f:
        f.write(text.replace(f"\n{k}\n", f"\n{R_MOD + k}\n"))
    tk = native_io.parse_pk_text(path)
    pts = pk.A_query + pk.B_g1 + pk.H_query + pk.L_query
    assert tf.limbs_to_ints(tk.g1.x) == [p[0] for p in pts]
    assert list(tk.g1.lsb) == [1 if p[2] else p[1] & 1 for p in pts]
    assert list(tk.g1.zero) == [p[2] for p in pts]
    assert tf.limbs_to_ints(tk.g2.x[:, 0]) == [p[0][0] for p in pk.B_g2]
    assert tf.limbs_to_ints(tk.g2.x[:, 1]) == [p[0][1] for p in pk.B_g2]
    assert list(tk.B_idx) == pk.B_indices
    off = 0
    for sel, (rows, vars_, _) in zip("abc", keys._cs_to_coo(cs)):
        n = tk.nnz[sel]
        assert list(tk.rows[off:off + n]) == list(rows)
        assert list(tk.vars[off:off + n]) == list(vars_)
        off += n
    coeffs = [cf % R_MOD for sel in range(3) for cons in cs.constraints
              for _, cf in cons[sel]]
    assert tf.limbs_to_ints(tk.coeffs) == coeffs and coeffs[0] == k
    assert (tk.primary_input_size, tk.aux_input_size, tk.num_constraints) \
        == (cs.primary_input_size, cs.auxiliary_input_size,
            cs.num_constraints)


def test_fq2_sqrt_plain_picks_hosts_root():
    """On a = (-c^2, 0), whose roots (0, +-c) have c0 = 0 so that the parity
    cannot choose, and on random squares and non-squares, the plain Fq2
    root is host.fq2_sqrt's."""
    rng = random.Random(11)
    cs = [1, 2, 3, Q_MOD - 1] + [rng.randrange(1, Q_MOD) for _ in range(6)]
    vals = [((-c * c) % Q_MOD, 0) for c in cs]
    vals += [hf.fq2_sqr((rng.randrange(Q_MOD), rng.randrange(Q_MOD)))
             for _ in range(6)]
    vals += [(rng.randrange(Q_MOD), rng.randrange(Q_MOD)) for _ in range(6)]
    vals += [hf.FQ2_ZERO, hf.FQ2_ONE]
    a = torch.from_numpy(np.stack(
        [tf.to_mont_host(tf.FQ, [v[0] for v in vals]),
         tf.to_mont_host(tf.FQ, [v[1] for v in vals])], 1).astype(np.int64))
    root, square = dc.fq2_sqrt_plain(a)
    r0 = tf.from_mont_host(tf.FQ, root[:, 0].numpy())
    r1 = tf.from_mont_host(tf.FQ, root[:, 1].numpy())
    for i, v in enumerate(vals):
        want = hf.fq2_sqrt(v)
        assert bool(square[i]) == (want is not None), i
        if want is not None:
            assert (r0[i], r1[i]) == want, i


def test_decompress_g1_plain_matches_host():
    """decompress_g1_plain on random points of both parities and a zero
    point: the host's decompression, in Montgomery form; the same in
    chunks of rows (the CPU path of a whole key)."""
    rng = random.Random(12)
    pts = [HC.g1_mul(HC.g1_generator(), rng.randrange(1, R_MOD))
           for _ in range(8)] + [(0, 0, 1)]
    assert {p[1] & 1 for p in pts[:-1]} == {0, 1}
    xs = torch.from_numpy(tf.ints_to_limbs([p[0] for p in pts])
                          .astype(np.int32))
    lsb = torch.tensor([p[1] & 1 for p in pts], dtype=torch.uint8)
    zero = torch.tensor([p[2] for p in pts], dtype=torch.uint8)
    x, y, inf, bad = dc.decompress_raw("g1", xs, lsb, zero)
    assert not bad.any() and inf.tolist() == [False] * 8 + [True]
    want = [io.g1_from_compressed(p[2], p[0], p[1] & 1) for p in pts]
    assert tf.from_mont_host(tf.FQ, x.numpy()) == [p[0] for p in want]
    assert tf.from_mont_host(tf.FQ, y.numpy()) == [p[1] for p in want]
    chunked = kn.plain_by_rows(dc.decompress_g1_plain, xs, lsb, zero, rows=4)
    assert all(torch.equal(g, w) for g, w in zip(chunked, (x, y, inf, bad)))


def test_mul_elementwise_by_rows_on_cpu(monkeypatch):
    """The CPU path of mul_elementwise runs its plain version a few rows at
    a time (a whole key's coefficients at once would take gigabytes): the
    same rows as one plain call, for a broadcast row and for a full b."""
    from blockmaze_tpu_torch.ntt import pntt
    rng = np.random.default_rng(13)
    a, b = (torch.from_numpy(tf.ints_to_limbs(
        [int(v) % R_MOD for v in rng.integers(0, 2**62, 10)])
        .astype(np.int32)) for _ in range(2))
    r2 = torch.from_numpy(tf.FR.r2_limbs[None].astype(np.int32))
    whole = [pntt.mul_elementwise_plain(a, r2),
             pntt.mul_elementwise_plain(a, b)]
    monkeypatch.setattr(kn, "PLAIN_ROWS", 4)
    assert torch.equal(pntt.mul_elementwise(a, r2), whole[0])
    assert torch.equal(pntt.mul_elementwise(a, b), whole[1])


def test_load_or_build_on_cpu_writes_jax_npz(proving_keys, tmp_path):
    """A miss on the CPU writes the npz the JAX package's load_or_build
    writes for the same text key, array for array."""
    path = _written(tmp_path, proving_keys["chain30"])
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    keys.load_or_build(path, str(tmp_path / "port"), device="cpu")
    jkeys.load_or_build(path, str(tmp_path / "jax"))
    name = "pk.v1.npz"
    with np.load(tmp_path / "port" / name) as got, \
            np.load(tmp_path / "jax" / name) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_host_build_failure_raises(tmp_path, monkeypatch):
    """Without g++ the tokenizer's build raises; nothing falls back."""
    monkeypatch.setattr(kn, "BUILD", str(tmp_path))
    monkeypatch.setattr(kn.shutil, "which", lambda name: None)
    with pytest.raises(kn.BuildError, match="g\\+\\+ not found"):
        kn.host_library("keyparse.cpp")


@pytest.mark.parametrize("source", sorted(kn.HOST_LIBS))
def test_host_library_table_entry_builds_and_binds(source):
    """Each entry of kernels.HOST_LIBS builds on the CPU with its flags,
    loads holding the interpreter lock through its calls or not as the
    entry says, and binds every entry point its source defines with the
    declared argtypes and restype; host_lib hands out one library a
    process."""
    spec = kn.HOST_LIBS[source]
    lib = kn.host_lib(source)
    assert lib is kn.host_lib(source)
    assert lib._name == kn.host_library(source, spec.flags)
    assert bool(lib._func_flags_ & ctypes._FUNCFLAG_PYTHONAPI) \
        == spec.holds_lock
    with open(os.path.join(kn.CSRC, source)) as f:
        defined = re.findall(r"^[A-Za-z][^(;]*\b(bm_\w+)\(", f.read(),
                             re.M)
    assert sorted(defined) == sorted(spec.entries)
    for name, (argtypes, restype) in spec.entries.items():
        fn = getattr(lib, name)
        assert tuple(fn.argtypes) == tuple(argtypes), name
        assert fn.restype is restype, name

"""blockmaze_tpu_torch's zktx service against the JAX package's: the cases
of tests/test_zktx.py on the port's modules, every hash helper and AUX
function equal on seeded inputs, and for each of the four circuits the
same (primary, aux) handed to the prover and the same primary input built
for the verifier. A recording stub stands in for each circuit's prover and
for the verifier, so no proof is computed here."""

import os
import random
import types

import numpy as np
import pytest
import torch

import test_zktx
from blockmaze_tpu.zktx import api as japi
from blockmaze_tpu.zktx import aux as jaux
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.curves import host_curve as HC
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import generator, keys
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.merkle import incremental as MK
from blockmaze_tpu_torch.serialization import libsnark_io as io
from blockmaze_tpu_torch.zktx import api, aux

from test_torch_host_copies import toy_circuit

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

# tests/test_zktx.py's cases, each run with the port's modules in place of
# the JAX package's
_PORT = dict(vars(test_zktx), __name__=__name__, api=api, aux=aux, NT=NT,
             MK=MK)
for _name, _fn in vars(test_zktx).items():
    if _name.startswith("test_"):
        globals()[_name] = types.FunctionType(_fn.__code__, _PORT, _name)


class SeededSecrets:
    """The part of `secrets` the service modules use, from a seeded
    random.Random: two instances with one seed give the same values."""

    def __init__(self, seed):
        self.rng = random.Random(seed)

    def token_bytes(self, n):
        return self.rng.randbytes(n)

    def randbelow(self, n):
        return self.rng.randrange(n)


def rand32(rng):
    return rng.randbytes(32)


@pytest.mark.parametrize("helper", ["gen_cmt", "gen_cmt_s", "compute_prf",
                                    "compute_crh", "gen_rt"])
def test_hash_helper_equal(helper):
    rng = random.Random(helper)
    for _ in range(3):
        sk, r = rand32(rng), rand32(rng)
        pk = rng.randbytes(20)
        value = rng.randrange(1 << 64)
        args = {"gen_cmt": (value, sk, r), "gen_cmt_s": (value, pk, r, sk),
                "compute_prf": (sk, r), "compute_crh": (pk, r),
                "gen_rt": ([rand32(rng) for _ in range(rng.randrange(1, 9))],)
                }[helper]
        assert getattr(api, helper)(*args) == getattr(japi, helper)(*args)
        if helper == "gen_rt":
            assert api.gen_rt(*args, 20) == japi.gen_rt(*args, 20)


def test_aux_functions_equal(monkeypatch):
    """Key pairs, one-time keys, the AUX memo and deposit signatures, with
    `secrets` seeded alike in both packages' aux modules."""
    monkeypatch.setattr(aux, "secrets", SeededSecrets(11))
    monkeypatch.setattr(jaux, "secrets", SeededSecrets(11))
    for _ in range(2):
        kB, sA = aux.keygen(), aux.keygen()
        assert (kB, sA) == (jaux.keygen(), jaux.keygen())
        (kB_priv, kB_pub), (sA_priv, R) = kB, sA
        otp = aux.new_random_pub_key(sA_priv, kB_pub)
        assert otp == jaux.new_random_pub_key(sA_priv, kB_pub)
        derived = aux.generate_key_for_random_b(R, kB_priv, kB_pub)
        assert derived == jaux.generate_key_for_random_b(R, kB_priv, kB_pub)
        assert derived[1] == otp
        rs, sna = NT.uint256_from_hex("123"), NT.uint256_from_hex("456")
        ct = aux.compute_aux(otp, 77, rs, sna)
        assert ct == jaux.compute_aux(otp, 77, rs, sna)
        assert aux.dec_aux(otp, ct) == jaux.dec_aux(otp, ct) == (77, rs, sna)
        h = rand32(random.Random(5))
        sig = aux.ecdsa_sign(derived[0] % aux.N, h)
        assert sig == jaux.ecdsa_sign(derived[0] % aux.N, h)
        assert aux.ecdsa_recover(h, *sig) == jaux.ecdsa_recover(h, *sig) \
            == otp


class Recorder:
    """Stands in for a circuit's prover (prove) and for the verifier module
    (verify): keeps what it was given, returns a fixed proof / True."""

    PROOF = io.Proof(a=HC.g1_generator(), b=HC.g2_generator(),
                     c=HC.g1_generator())

    def __init__(self):
        self.calls = []

    def prove(self, primary, aux_input):
        self.calls.append((list(primary), list(aux_input)))
        return self.PROOF

    def verify(self, vk, primary, proof):
        self.calls.append((vk, list(primary)))
        return True


def circuit_args(name):
    """(gen args, verify args after the proof) of circuit `name`, values as
    the reference's test binaries take them, depth-8 deposit tree."""
    rng = random.Random(name)
    sk, r_old, r, r_s, sn_A_old = (rand32(rng) for _ in range(5))
    pk_sender, pk_recv = rng.randbytes(20), rng.randbytes(20)
    sn_old = NT.compute_prf(sk, r_old)

    def cm(value, rand):
        return NT.Note(value, NT.compute_prf(sk, rand), rand).cm()

    if name == "mint":
        return (6, 13, 7, sk, r_old, r), (cm(6, r_old), sn_old, cm(13, r), 7)
    if name == "redeem":
        return (13, 6, 7, sk, r_old, r), (cm(13, r_old), sn_old, cm(6, r), 7)
    if name == "send":
        cmtS = NT.NoteS(6, pk_recv, NT.compute_crh(pk_sender, r),
                        sn_old).cm()
        return ((10, 4, 6, sk, r_old, r, pk_sender, pk_recv),
                (cm(10, r_old), sn_old, cmtS, cm(4, r)))
    cmtS = NT.NoteS(9, pk_recv, r_s, sn_A_old).cm()
    cmts = [rand32(rng) for _ in range(9)] + [cmtS] + \
        [rand32(rng) for _ in range(6)]
    return ((255, 264, 9, sk, r_old, r, r_s, sn_A_old, pk_recv, cmts),
            (api.gen_rt(cmts, 8), pk_recv, cm(255, r_old), sn_old,
             cm(264, r), NT.compute_prf(sk, r_s)))


@pytest.mark.parametrize("name", ["mint", "send", "deposit", "redeem"])
def test_service_hands_prover_and_verifier_the_same_inputs(
        name, tmp_path, monkeypatch):
    gen_args, ver_args = circuit_args(name)
    out = []
    for mod, svc in ((api, api.ZkTx(str(tmp_path), 8, device="cpu")),
                     (japi, japi.ZkTx(str(tmp_path), 8))):
        prover, verifier = Recorder(), Recorder()
        ctx = svc.circuits[name]
        ctx._prover, ctx._vk = prover, "vk"
        monkeypatch.setattr(mod, "gver", verifier)
        proof_hex, primary = getattr(svc, f"gen_{name}_proof")(*gen_args)
        assert getattr(svc, f"verify_{name}_proof")(proof_hex, *ver_args)
        assert prover.calls[0][0] == primary
        assert verifier.calls == [("vk", primary)]
        out.append((proof_hex, prover.calls))
    assert out[0] == out[1]
    assert len(out[0][1]) == 1


def test_warm_builds_cpu_prover_from_npz_cache(tmp_path):
    """A key directory holding only <name>pk.v1.npz and <name>vk.txt serves
    the service: warm() loads the key and builds the Prover on the device
    the service was given."""
    w = 7654321
    pb = toy_circuit(w * w % R_MOD, w)
    toxic = iter([3, 5, 7, 11, 13])
    pk, vk = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    keys.save_device_pk(keys.build_device_pk(pk),
                        str(tmp_path / "mintpk.v1.npz"))
    io.write_verification_key(str(tmp_path / "mintvk.txt"), vk)
    svc = api.ZkTx(str(tmp_path), device="cpu")
    svc.warm(["mint"])
    prover = svc.circuits["mint"]._prover
    assert isinstance(prover, Prover) and prover.device.type == "cpu"
    assert prover.dpk.num_constraints == len(pb.constraints)
    assert svc.circuits["mint"].vk == vk
    assert svc.circuits["send"]._prover is None


def test_warm_loads_text_key_on_its_device(tmp_path):
    """A key directory holding the text key <name>pk.txt: warm() reads it
    on the service's device (here the CPU: the tokenizer and the
    decompression kernels' plain versions, not the card a default would
    ask for), writes <name>pk.v1.npz beside it, and the key equals the
    Python reader's."""
    w = 7654321
    pb = toy_circuit(w * w % R_MOD, w)
    toxic = iter([3, 5, 7, 11, 13])
    pk, vk = generator.generate(pb, "cpu", rng=lambda: next(toxic))
    io.write_proving_key(str(tmp_path / "mintpk.txt"), pk)
    io.write_verification_key(str(tmp_path / "mintvk.txt"), vk)
    svc = api.ZkTx(str(tmp_path), device="cpu")
    svc.warm(["mint"])
    prover = svc.circuits["mint"]._prover
    assert prover.device.type == "cpu"
    assert os.path.exists(tmp_path / "mintpk.v1.npz")
    want = keys.build_device_pk(io.load_proving_key(
        str(tmp_path / "mintpk.txt")))
    for f in ("A", "B2", "B1", "H", "L"):
        assert all(np.array_equal(a, b) for a, b in
                   zip(getattr(prover.dpk, f), getattr(want, f))), f

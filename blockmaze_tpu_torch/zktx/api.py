"""zktx API surface: the framework's equivalent of go-ethereum/zktx/zktx.go
(L7 in SURVEY.md §1) — commitment/PRF/CRH helpers, Merkle root generation,
and proof generation/verification for the four circuits.

Port of blockmaze_tpu/zktx/api.py: the same service, line for line, with
this package's Prover on a torch device (the card unless the caller passes
device="cpu") and a warm() that loads the keys and builds the provers and
the kernel library without running a proof.

Hash-level functions are bit-exact with the reference cgo shims (mintcgo.cpp
genCMT/computePRF etc.); hex conventions follow uint256 GetHex (big-endian hex
of the little-endian memory bytes).
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
from typing import List, Optional

import torch

from .. import config
from ..circuits.deposit import DepositGadget
from ..circuits.mint import MintGadget
from ..circuits.redeem import RedeemGadget
from ..circuits.send import SendGadget
from ..crypto import notes as NT
from ..groth16 import keys as gkeys
from ..groth16 import verifier as gver
from ..groth16.prover import Prover
from ..merkle import incremental as MK
from ..r1cs.protoboard import Protoboard
from ..serialization import libsnark_io as io
from ..utils import kernels as kn
from ..utils import spans


# ---------------------------------------------------------------------------
# Hash helpers (zktx.go GenCMT / GenCMTS / ComputePRF / ComputeCRH / GenRT)
# ---------------------------------------------------------------------------

def gen_cmt(value: int, sn: bytes, r: bytes) -> bytes:
    """genCMT (mintcgo.cpp:239-251)."""
    return NT.Note(value, sn, r).cm()


def gen_cmt_s(value_s: int, pk: bytes, r_s: bytes, sn_old: bytes) -> bytes:
    """genCMTS (sendcgo.cpp)."""
    return NT.NoteS(value_s, pk, r_s, sn_old).cm()


def compute_prf(sk: bytes, r: bytes) -> bytes:
    return NT.compute_prf(sk, r)


def compute_crh(pk: bytes, r: bytes) -> bytes:
    return NT.compute_crh(pk, r)


def gen_rt(cmts: List[bytes], depth: int = MK.DEPTH) -> bytes:
    """genRoot (depositcgo.cpp:302-325): append all cmts, return tree root."""
    tree = MK.IncrementalMerkleTree(depth)
    for cmt in cmts:
        tree.append(cmt)
    return tree.root()


# ---------------------------------------------------------------------------
# The collector's hold around synthesis
# ---------------------------------------------------------------------------

_gc_lock = threading.Lock()
_gc_holds = 0           # holds open, in every thread
_gc_switched = False    # the first open hold switched the collector off


@contextlib.contextmanager
def hold_gc():
    """The interpreter's cyclic garbage collector off for the block, process
    wide. A circuit's synthesis makes no reference cycle (everything it
    allocates is freed by reference counting when the call ends), so each
    collection a synthesis triggers walks the whole heap and frees nothing.

    Holds nest and overlap across threads: the first to open switches the
    collector off if it is on, the last to close switches it on again if
    the first switched it off. Nothing is collected at the close. Yields 1
    when the holds switched the collector off, 0 when it was off before
    them (the zktx.witness span's info gc_held).

    The block drops what it made before it closes: objects made under the
    hold and still alive count toward the youngest generation, and the
    first collection after the hold would walk every one of them."""
    global _gc_holds, _gc_switched
    with _gc_lock:
        if _gc_holds == 0:
            _gc_switched = gc.isenabled()
            gc.disable()
        _gc_holds += 1
        held = int(_gc_switched)
    try:
        yield held
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_switched:
                gc.enable()


# ---------------------------------------------------------------------------
# Circuit registry: lazy provers per circuit
# ---------------------------------------------------------------------------

class CircuitContext:
    """Holds the device pk (lazily loaded) and vk for one circuit. The key
    directory holds <name>pk.txt (libsnark format) or its cache
    <name>pk.v1.npz, and <name>vk.txt; the prover runs on `device`."""

    def __init__(self, name: str, key_dir: str, device="cuda"):
        self.name = name
        self.key_dir = key_dir
        self.device = device
        self._prover: Optional[Prover] = None
        self._vk = None

    @property
    def prover(self) -> Prover:
        if self._prover is None:
            dpk = gkeys.load_or_build(
                os.path.join(self.key_dir, f"{self.name}pk.txt"),
                device=self.device)
            self._prover = Prover(dpk, self.device)
        return self._prover

    @property
    def vk(self):
        if self._vk is None:
            self._vk = io.load_verification_key(
                os.path.join(self.key_dir, f"{self.name}vk.txt"))
        return self._vk


class ZkTx:
    """Top-level service: Gen*/Verify*Proof for the four circuits.

    `merkle_depth` selects the in-circuit tree depth for deposit (8 is the
    reference default, 20 the production setting — config.Config.merkle_depth);
    the key files in `key_dir` must have been generated for the same depth.
    Every prover runs on `device`.

    Each Gen*Proof call is the span zktx.prove (utils/spans.py), and inside
    it zktx.notes (the PRFs, notes, commitments and, for deposit, the
    Merkle path), zktx.witness (the protoboard, the gadget's witness and
    its primary and auxiliary inputs), the prover's prover.prove and
    zktx.encode (the proof's hex); each Verify*Proof call is zktx.verify.
    zktx.notes and zktx.witness run under hold_gc(), the collector off;
    the proof, its encoding and every verification do not."""

    def __init__(self, key_dir: Optional[str] = None,
                 merkle_depth: Optional[int] = None, device="cuda"):
        cfg = config.get_config()
        self.merkle_depth = (cfg.merkle_depth if merkle_depth is None
                             else merkle_depth)
        key_dir = key_dir or cfg.key_dir
        self.device = device
        self.circuits = {name: CircuitContext(name, key_dir, device)
                         for name in ("mint", "send", "deposit", "redeem")}

    def warm(self, names=None):
        """Load each circuit's pk and build its Prover (key upload, QAP
        tables), and on the card build and load the kernel library. A
        fresh process otherwise pays all of it inside its first
        Gen*Proof call — the reference's 20 s pk deserialize analogue
        (mintcgo.cpp:300-301). Runs no proof."""
        for name in names or self.circuits:
            self.circuits[name].prover
        if torch.device(self.device).type == "cuda":
            kn.kernel_lib()

    def _prove(self, name: str, primary, aux) -> tuple:
        """The circuit's proof of the synthesised witness: (proof hex, the
        public input)."""
        proof = self.circuits[name].prover.prove(primary, aux)
        with spans.span("zktx.encode"):
            return io.proof_to_hex(proof), primary

    # --- mint -----------------------------------------------------------
    @spans.traced("zktx.prove")
    def gen_mint_proof(self, value_old: int, value: int, value_s: int,
                       sk: bytes, r_old: bytes, r: bytes,
                       sn_old: Optional[bytes] = None) -> tuple:
        # the reference ABI passes sn_old explicitly (zktx.go GenMintProof):
        # genesis notes carry InitializeSN's sn, not PRF(this sk, r_old)
        with hold_gc() as held:
            with spans.span("zktx.notes"):
                if sn_old is None:
                    sn_old = compute_prf(sk, r_old)
                note_old = NT.Note(value_old, sn_old, r_old)
                sn = compute_prf(sk, r)
                note = NT.Note(value, sn, r)
                cm_old, cm = note_old.cm(), note.cm()
            with spans.span("zktx.witness") as witness:
                witness.info = {"gc_held": held}
                pb = Protoboard()
                g = MintGadget(pb)
                g.generate_witness(note_old, note, cm_old, cm, value_s, sk)
                primary, aux = pb.primary_input(), pb.auxiliary_input()
                del pb, g
        return self._prove("mint", primary, aux)

    @staticmethod
    def _decode(proof) -> io.Proof:
        """Accept the tx wire encoding (512-hex string, mintcgo.cpp:344-404)
        or an already-decoded Proof."""
        return io.proof_from_hex(proof) if isinstance(proof, str) else proof

    @spans.traced("zktx.verify")
    def verify_mint_proof(self, proof, cmtA_old: bytes,
                          sn_old: bytes, cmtA: bytes, value_s: int) -> bool:
        proof = self._decode(proof)
        primary = MintGadget.witness_map(cmtA_old, sn_old, cmtA, value_s)
        return gver.verify(self.circuits["mint"].vk, primary, proof)

    # --- send -----------------------------------------------------------
    @spans.traced("zktx.prove")
    def gen_send_proof(self, value_old: int, value: int, value_s: int,
                       sk: bytes, r_old: bytes, r: bytes,
                       pk_sender: bytes, pk_recv: bytes,
                       sn_old: Optional[bytes] = None) -> tuple:
        with hold_gc() as held:
            with spans.span("zktx.notes"):
                if sn_old is None:
                    sn_old = compute_prf(sk, r_old)
                note_old = NT.Note(value_old, sn_old, r_old)
                note = NT.Note(value, compute_prf(sk, r), r)
                r_s = compute_crh(pk_sender, r)
                note_s = NT.NoteS(value_s, pk_recv, r_s, sn_old)
                cms = note_old.cm(), note_s.cm(), note.cm()
            with spans.span("zktx.witness") as witness:
                witness.info = {"gc_held": held}
                pb = Protoboard()
                g = SendGadget(pb)
                g.generate_witness(note_old, note_s, note, *cms, sk, pk_sender)
                primary, aux = pb.primary_input(), pb.auxiliary_input()
                del pb, g
        return self._prove("send", primary, aux)

    @spans.traced("zktx.verify")
    def verify_send_proof(self, proof, cmtA_old: bytes,
                          sn_old: bytes, cmtS: bytes, cmtA: bytes) -> bool:
        proof = self._decode(proof)
        primary = SendGadget.witness_map(cmtA_old, sn_old, cmtS, cmtA)
        return gver.verify(self.circuits["send"].vk, primary, proof)

    # --- redeem ---------------------------------------------------------
    @spans.traced("zktx.prove")
    def gen_redeem_proof(self, value_old: int, value: int, value_s: int,
                         sk: bytes, r_old: bytes, r: bytes,
                         sn_old: Optional[bytes] = None) -> tuple:
        with hold_gc() as held:
            with spans.span("zktx.notes"):
                if sn_old is None:
                    sn_old = compute_prf(sk, r_old)
                note_old = NT.Note(value_old, sn_old, r_old)
                note = NT.Note(value, compute_prf(sk, r), r)
                cm_old, cm = note_old.cm(), note.cm()
            with spans.span("zktx.witness") as witness:
                witness.info = {"gc_held": held}
                pb = Protoboard()
                g = RedeemGadget(pb)
                g.generate_witness(note_old, note, cm_old, cm, value_s, sk)
                primary, aux = pb.primary_input(), pb.auxiliary_input()
                del pb, g
        return self._prove("redeem", primary, aux)

    @spans.traced("zktx.verify")
    def verify_redeem_proof(self, proof, cmtA_old: bytes,
                            sn_old: bytes, cmtA: bytes, value_s: int) -> bool:
        proof = self._decode(proof)
        primary = RedeemGadget.witness_map(cmtA_old, sn_old, cmtA, value_s)
        return gver.verify(self.circuits["redeem"].vk, primary, proof)

    # --- deposit --------------------------------------------------------
    @spans.traced("zktx.prove")
    def gen_deposit_proof(self, value_old: int, value: int, value_s: int,
                          sk: bytes, r_old: bytes, r: bytes, r_s: bytes,
                          sn_A_old: bytes, pk_recv: bytes,
                          cmts_for_merkle: List[bytes],
                          sn_old: Optional[bytes] = None) -> tuple:
        """Rebuilds the tree from the cmt list (genDepositproof semantics:
        depositcgo.cpp builds the tree, takes witness(cmtS).path())."""
        with hold_gc() as held:
            with spans.span("zktx.notes"):
                if sn_old is None:
                    sn_old = compute_prf(sk, r_old)
                note_old = NT.Note(value_old, sn_old, r_old)
                note = NT.Note(value, compute_prf(sk, r), r)
                note_s = NT.NoteS(value_s, pk_recv, r_s, sn_A_old)
                sn_s = compute_prf(sk, r_s)
                cmtS = note_s.cm()
                cm_old, cm = note_old.cm(), note.cm()

                tree = MK.IncrementalMerkleTree(self.merkle_depth)
                wit = None
                for cmt in cmts_for_merkle:
                    if wit is not None:
                        wit.append(cmt)
                    else:
                        tree.append(cmt)
                    if cmt == cmtS and wit is None:
                        wit = tree.witness()
                if wit is None:
                    raise ValueError(
                        "cmtS not found in merkle commitment list")
                rt = wit.root()
                path = wit.path()

            with spans.span("zktx.witness") as witness:
                witness.info = {"gc_held": held}
                pb = Protoboard()
                g = DepositGadget(pb, depth=self.merkle_depth)
                g.generate_witness(note_s, note_old, note, cmtS, cm_old, cm,
                                   rt, path, sn_s, sk)
                primary, aux = pb.primary_input(), pb.auxiliary_input()
                del pb, g
        return self._prove("deposit", primary, aux)

    @spans.traced("zktx.verify")
    def verify_deposit_proof(self, proof, rt: bytes,
                             pk_recv: bytes, cmtB_old: bytes, sn_old: bytes,
                             cmtB: bytes, sn_s: bytes) -> bool:
        proof = self._decode(proof)
        primary = DepositGadget.witness_map(rt, pk_recv, cmtB_old, sn_old,
                                            cmtB, sn_s)
        return gver.verify(self.circuits["deposit"].vk, primary, proof)

"""Deposit circuit: exact replica of src/deposit/circuit/ (gadget.tcc,
note.tcc, merkle.tcc) — the heaviest circuit (10 SHA256 compressions + one
two-to-one hash per Merkle level).

Proves, for public (rt, pk_recv, cmtB_old, sn_old, cmtB, sn_s):
    value = value_old + value_s
    sn    = SHA256(sk || r)           sn_s = SHA256(sk || r_s)
    cmtS  = SHA256(value_s || pk_recv || r_s || sn_A_old)
    cmtB_old = SHA256(value_old || sn_old || r_old)
    cmtB  = SHA256(value || sn || r)
    cmtS ∈ MerkleTree(rt)  along the authentication path (depth 8 by default)
"""

from __future__ import annotations

from typing import List

from ..crypto import notes as NT
from ..fields.constants import FR_CAPACITY
from ..merkle.incremental import DEPTH, MerklePath
from ..r1cs.protoboard import (
    LC,
    Protoboard,
    generate_boolean_constraint,
    generate_equals_const_constraint,
)
from ..r1cs.gadgets.basic import DigestVariable, MultipackingGadget
from ..r1cs.gadgets.merkle import (
    MerkleAuthenticationPathVariable,
    MerkleTreeCheckReadGadget,
)
from .common import Sha256CmtaGadget, Sha256CmtsGadget, Sha256PrfGadget
from .mint import pack_bits


class NoteGadgetWithPackingAndAdd:
    """deposit/circuit/note.tcc:5-127."""

    def __init__(self, pb: Protoboard, value_s, pk_recv, r_s, sn_A_old,
                 value_old, sn_old, r_old, value, sn, r, sk):
        self.pb = pb
        self.value_s, self.pk_recv, self.r_s = value_s, pk_recv, r_s
        self.sn_A_old = sn_A_old
        self.value_old, self.sn_old, self.r_old = value_old, sn_old, r_old
        self.value, self.sn, self.r, self.sk = value, sn, r, sk
        self.value_s_packed = pb.allocate()
        self.value_old_packed = pb.allocate()
        self.value_packed = pb.allocate()

    def generate_constraints(self):
        for arr in (self.value_s, self.value_old, self.value):
            for b in arr:
                generate_boolean_constraint(self.pb, b)
        self.pb.add_constraint(
            LC.of(1),
            LC.var(self.value_old_packed) + LC.var(self.value_s_packed),
            LC.var(self.value_packed))
        self.pk_recv.generate_constraints()
        self.r_s.generate_constraints()
        self.sn_A_old.generate_constraints()
        self.sn_old.generate_constraints()
        self.r_old.generate_constraints()
        self.sn.generate_constraints()
        self.r.generate_constraints()
        self.sk.generate_constraints()

    def _fill_u64(self, arr, v):
        for var, bit in zip(arr, NT.uint64_to_bits(v)):
            self.pb.setval(var, bit)

    def generate_witness(self, note_s: NT.NoteS, note_old: NT.Note,
                         note: NT.Note, sk_data: bytes):
        self._fill_u64(self.value_s, note_s.value)
        self.pb.setval(self.value_s_packed, note_s.value)
        self._fill_u64(self.value_old, note_old.value)
        self.pb.setval(self.value_old_packed, note_old.value)
        self._fill_u64(self.value, note.value)
        self.pb.setval(self.value_packed, note.value)
        self.pk_recv.fill_with_bits(NT.bytes_to_bits(note_s.pk))
        self.r_s.fill_with_bits(NT.bytes_to_bits(note_s.r))
        self.sn_A_old.fill_with_bits(NT.bytes_to_bits(note_s.sn))
        self.sn_old.fill_with_bits(NT.bytes_to_bits(note_old.sn))
        self.r_old.fill_with_bits(NT.bytes_to_bits(note_old.r))
        self.sn.fill_with_bits(NT.bytes_to_bits(note.sn))
        self.r.fill_with_bits(NT.bytes_to_bits(note.r))
        self.sk.fill_with_bits(NT.bytes_to_bits(sk_data))


class MerkleTreeGadget:
    """deposit/circuit/merkle.tcc:1-63."""

    def __init__(self, pb: Protoboard, leaf: DigestVariable,
                 root: DigestVariable, enforce, depth: int = DEPTH):
        self.pb = pb
        self.depth = depth
        self.positions = pb.allocate_array(depth)
        self.authvars = MerkleAuthenticationPathVariable(pb, depth)
        self.auth = MerkleTreeCheckReadGadget(
            pb, depth, self.positions, leaf, root, self.authvars, enforce)

    def generate_constraints(self):
        for p in self.positions:
            generate_boolean_constraint(self.pb, p)
        self.authvars.generate_constraints()
        self.auth.generate_constraints()

    def generate_witness(self, path: MerklePath):
        address = path.address
        for j, var in enumerate(self.positions):
            self.pb.setval(var, (address >> j) & 1)
        path_bits = [NT.bytes_to_bits(h) for h in path.authentication_path]
        self.authvars.generate_witness(address, path_bits)
        self.auth.generate_witness()


class DepositGadget:
    """src/deposit/circuit/gadget.tcc:23-369."""

    def __init__(self, pb: Protoboard, depth: int = DEPTH):
        self.pb = pb
        self.depth = depth
        n_bits = 256 + 160 + 256 * 4
        self.PACKED_INPUTS = -(-n_bits // FR_CAPACITY)
        self.zk_packed_inputs = pb.allocate_array(self.PACKED_INPUTS)
        pb.set_input_sizes(self.PACKED_INPUTS)

        self.zk_unpacked_inputs: List[int] = []
        self.zk_merkle_root = self._alloc_digest(256)
        self.pk_recv = self._alloc_digest(160)
        self.cmtB_old = self._alloc_digest(256)
        self.sn_old = self._alloc_digest(256)
        self.cmtB = self._alloc_digest(256)
        self.sn_s = self._alloc_digest(256)
        assert len(self.zk_unpacked_inputs) == n_bits

        self.unpacker = MultipackingGadget(
            pb, self.zk_unpacked_inputs, self.zk_packed_inputs, FR_CAPACITY)

        self.value_enforce = pb.allocate()
        self.ZERO = pb.allocate()
        self.value_s = pb.allocate_array(64)
        self.r_s = DigestVariable(pb, 256)
        self.sn_A_old = DigestVariable(pb, 256)
        self.cmtS = DigestVariable(pb, 256)
        self.value_old = pb.allocate_array(64)
        self.r_old = DigestVariable(pb, 256)
        self.value = pb.allocate_array(64)
        self.sn = DigestVariable(pb, 256)
        self.r = DigestVariable(pb, 256)
        self.sk = DigestVariable(pb, 256)

        self.noteADD = NoteGadgetWithPackingAndAdd(
            pb, self.value_s, self.pk_recv, self.r_s, self.sn_A_old,
            self.value_old, self.sn_old, self.r_old,
            self.value, self.sn, self.r, self.sk)

        self.prf_to_inputs_sn = Sha256PrfGadget(
            pb, self.ZERO, self.sk.bits, self.r.bits, self.sn)
        self.prf_to_inputs_sn_s = Sha256PrfGadget(
            pb, self.ZERO, self.sk.bits, self.r_s.bits, self.sn_s)

        self.commit_to_input_cmt_s = Sha256CmtsGadget(
            pb, self.ZERO, self.value_s, self.pk_recv.bits,
            self.r_s.bits, self.sn_A_old.bits, self.cmtS)

        self.commit_to_inputs_cmt_old = Sha256CmtaGadget(
            pb, self.ZERO, self.value_old, self.sn_old.bits,
            self.r_old.bits, self.cmtB_old)

        self.commit_to_inputs_cmt = Sha256CmtaGadget(
            pb, self.ZERO, self.value, self.sn.bits, self.r.bits, self.cmtB)

        self.witness_input = MerkleTreeGadget(
            pb, self.cmtS, self.zk_merkle_root, self.value_enforce, depth)

    def _alloc_digest(self, n: int) -> DigestVariable:
        d = DigestVariable(self.pb, n)
        self.zk_unpacked_inputs.extend(d.bits)
        return d

    def generate_constraints(self):
        self.unpacker.generate_constraints(True)
        self.noteADD.generate_constraints()
        generate_equals_const_constraint(self.pb, self.ZERO, 0)
        self.sn_s.generate_constraints()
        self.prf_to_inputs_sn_s.generate_constraints()
        self.sn.generate_constraints()
        self.prf_to_inputs_sn.generate_constraints()
        self.sn_old.generate_constraints()
        self.cmtS.generate_constraints()
        self.commit_to_input_cmt_s.generate_constraints()
        self.cmtB_old.generate_constraints()
        self.commit_to_inputs_cmt_old.generate_constraints()
        self.cmtB.generate_constraints()
        self.commit_to_inputs_cmt.generate_constraints()
        self.zk_merkle_root.generate_constraints()
        generate_boolean_constraint(self.pb, self.value_enforce)
        self.witness_input.generate_constraints()

    def generate_witness(self, note_s: NT.NoteS, note_old: NT.Note,
                         note: NT.Note, cmtS: bytes, cmtB_old: bytes,
                         cmtB: bytes, rt: bytes, path: MerklePath,
                         sn_s: bytes, sk_data: bytes):
        self.noteADD.generate_witness(note_s, note_old, note, sk_data)
        self.pb.setval(self.value_enforce, 1 if note_s.value != 0 else 0)
        self.pb.setval(self.ZERO, 0)
        self.prf_to_inputs_sn.generate_witness()
        self.prf_to_inputs_sn_s.generate_witness()
        self.sn_s.fill_with_bits(NT.bytes_to_bits(sn_s))
        self.commit_to_input_cmt_s.generate_witness()
        self.commit_to_inputs_cmt_old.generate_witness()
        self.commit_to_inputs_cmt.generate_witness()
        self.cmtS.fill_with_bits(NT.bytes_to_bits(cmtS))
        self.cmtB_old.fill_with_bits(NT.bytes_to_bits(cmtB_old))
        self.cmtB.fill_with_bits(NT.bytes_to_bits(cmtB))
        self.witness_input.generate_witness(path)
        self.zk_merkle_root.fill_with_bits(NT.bytes_to_bits(rt))
        self.unpacker.witness_from_bits()

    @staticmethod
    def witness_map(rt: bytes, pk_recv: bytes, cmtB_old: bytes,
                    sn_old: bytes, cmtB: bytes, sn_s: bytes) -> List[int]:
        bits = (NT.bytes_to_bits(rt) + NT.bytes_to_bits(pk_recv)
                + NT.bytes_to_bits(cmtB_old) + NT.bytes_to_bits(sn_old)
                + NT.bytes_to_bits(cmtB) + NT.bytes_to_bits(sn_s))
        return pack_bits(bits)

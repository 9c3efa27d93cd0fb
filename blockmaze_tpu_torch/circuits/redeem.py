"""Redeem circuit: exact replica of src/redeem/circuit/ (gadget.tcc,
note.tcc, sub_cmp.tcc).

Mirror of mint with subtraction: proves, for public
(cmtA_old, sn_old, cmtA, value_s):
    cmtA_old = SHA256(value_old || sn_old || r_old)
    sn       = SHA256(sk || r)
    cmtA     = SHA256(value || sn || r)
    value    = value_old - value_s   and   value_s <= value_old
"""

from __future__ import annotations

from typing import List

from ..crypto import notes as NT
from ..fields.constants import FR_CAPACITY
from ..r1cs.protoboard import (
    LC,
    Protoboard,
    generate_boolean_constraint,
    generate_equals_const_constraint,
)
from ..r1cs.gadgets.basic import DigestVariable, MultipackingGadget
from .common import LessComparisonGadget, Sha256CmtaGadget, Sha256PrfGadget
from .mint import pack_bits


class NoteGadgetWithPacking:
    """redeem/circuit/note.tcc:6-98 (carries sn and sn_old too)."""

    def __init__(self, pb: Protoboard, value, value_old, value_s,
                 sk, r, r_old, sn, sn_old):
        self.pb = pb
        self.value, self.value_old, self.value_s = value, value_old, value_s
        self.sk, self.r, self.r_old = sk, r, r_old
        self.sn, self.sn_old = sn, sn_old
        self.value_packed = pb.allocate()
        self.value_old_packed = pb.allocate()
        self.value_s_packed = pb.allocate()

    def generate_constraints(self):
        for arr in (self.value_old, self.value_s, self.value):
            for b in arr:
                generate_boolean_constraint(self.pb, b)
        self.sk.generate_constraints()
        self.r.generate_constraints()
        self.r_old.generate_constraints()
        self.sn.generate_constraints()
        self.sn_old.generate_constraints()

    def _fill_u64(self, arr, v):
        for var, bit in zip(arr, NT.uint64_to_bits(v)):
            self.pb.setval(var, bit)

    def generate_witness(self, note_old: NT.Note, note: NT.Note, v_s: int,
                         sk_data: bytes):
        self._fill_u64(self.value, note.value)
        self.pb.setval(self.value_packed, note.value)
        self._fill_u64(self.value_old, note_old.value)
        self.pb.setval(self.value_old_packed, note_old.value)
        self._fill_u64(self.value_s, v_s)
        self.pb.setval(self.value_s_packed, v_s)
        self.sk.fill_with_bits(NT.bytes_to_bits(sk_data))
        self.r.fill_with_bits(NT.bytes_to_bits(note.r))
        self.r_old.fill_with_bits(NT.bytes_to_bits(note_old.r))
        self.sn.fill_with_bits(NT.bytes_to_bits(note.sn))
        self.sn_old.fill_with_bits(NT.bytes_to_bits(note_old.sn))


class NoteGadgetWithComparisonAndSubtractionForValueOld(NoteGadgetWithPacking):
    """redeem/circuit/sub_cmp.tcc:9-45."""

    def __init__(self, pb, value, value_old, value_s, sk, r, r_old, sn, sn_old):
        super().__init__(pb, value, value_old, value_s, sk, r, r_old, sn, sn_old)
        self.less_cmp = LessComparisonGadget(
            pb, self.value_s_packed, self.value_old_packed)

    def generate_constraints(self):
        super().generate_constraints()
        self.pb.add_constraint(
            LC.of(1),
            LC.var(self.value_old_packed) - LC.var(self.value_s_packed),
            LC.var(self.value_packed))
        self.less_cmp.generate_constraints()

    def generate_witness(self, note_old, note, v_s, sk_data):
        super().generate_witness(note_old, note, v_s, sk_data)
        self.less_cmp.generate_witness()


class RedeemGadget:
    """src/redeem/circuit/gadget.tcc:23+."""

    PACKED_INPUTS = 4

    def __init__(self, pb: Protoboard):
        self.pb = pb
        self.zk_packed_inputs = pb.allocate_array(self.PACKED_INPUTS)
        pb.set_input_sizes(self.PACKED_INPUTS)

        self.zk_unpacked_inputs: List[int] = []
        self.cmtA_old = self._alloc_uint256()
        self.sn_old = self._alloc_uint256()
        self.cmtA = self._alloc_uint256()
        self.value_s = self._alloc_uint64()
        assert len(self.zk_unpacked_inputs) == 832

        self.unpacker = MultipackingGadget(
            pb, self.zk_unpacked_inputs, self.zk_packed_inputs, FR_CAPACITY)

        self.ZERO = pb.allocate()
        self.value = pb.allocate_array(64)
        self.value_old = pb.allocate_array(64)
        self.sk = DigestVariable(pb, 256)
        self.r = DigestVariable(pb, 256)
        self.r_old = DigestVariable(pb, 256)
        self.sn = DigestVariable(pb, 256)

        self.ncsv = NoteGadgetWithComparisonAndSubtractionForValueOld(
            pb, self.value, self.value_old, self.value_s,
            self.sk, self.r, self.r_old, self.sn, self.sn_old)

        self.prf_to_inputs_sn = Sha256PrfGadget(
            pb, self.ZERO, self.sk.bits, self.r.bits, self.sn)

        self.commit_to_inputs_cmt_old = Sha256CmtaGadget(
            pb, self.ZERO, self.value_old, self.sn_old.bits,
            self.r_old.bits, self.cmtA_old)

        self.commit_to_inputs_cmt = Sha256CmtaGadget(
            pb, self.ZERO, self.value, self.sn.bits, self.r.bits, self.cmtA)

    def _alloc_uint256(self) -> DigestVariable:
        d = DigestVariable(self.pb, 256)
        self.zk_unpacked_inputs.extend(d.bits)
        return d

    def _alloc_uint64(self) -> List[int]:
        arr = self.pb.allocate_array(64)
        self.zk_unpacked_inputs.extend(arr)
        return arr

    def generate_constraints(self):
        self.unpacker.generate_constraints(True)
        self.ncsv.generate_constraints()
        generate_equals_const_constraint(self.pb, self.ZERO, 0)
        self.sn.generate_constraints()
        self.prf_to_inputs_sn.generate_constraints()
        self.sn_old.generate_constraints()
        self.cmtA_old.generate_constraints()
        self.commit_to_inputs_cmt_old.generate_constraints()
        self.cmtA.generate_constraints()
        self.commit_to_inputs_cmt.generate_constraints()

    def generate_witness(self, note_old: NT.Note, note: NT.Note,
                         cmtA_old: bytes, cmtA: bytes, v_s: int,
                         sk_data: bytes):
        self.ncsv.generate_witness(note_old, note, v_s, sk_data)
        self.pb.setval(self.ZERO, 0)
        self.prf_to_inputs_sn.generate_witness()
        self.commit_to_inputs_cmt_old.generate_witness()
        self.commit_to_inputs_cmt.generate_witness()
        self.cmtA_old.fill_with_bits(NT.bytes_to_bits(cmtA_old))
        self.cmtA.fill_with_bits(NT.bytes_to_bits(cmtA))
        self.unpacker.witness_from_bits()

    witness_map = staticmethod(
        lambda cmtA_old, sn_old, cmtA, value_s: pack_bits(
            NT.bytes_to_bits(cmtA_old) + NT.bytes_to_bits(sn_old)
            + NT.bytes_to_bits(cmtA) + NT.uint64_to_bits(value_s)))
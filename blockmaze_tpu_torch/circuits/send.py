"""Send circuit: exact replica of src/send/circuit/ (gadget.tcc, note.tcc,
comparison.tcc, less_cmp.tcc, commitment.tcc).

Proves, for public (cmtA_old, sn_old, cmtS, cmtA):
    cmtA_old = SHA256(value_old || sn_old || r_old)
    value_s <= value_old          (less_comparison, bug-compatible)
    value    = value_old - value_s
    r_s      = SHA256(pk_sender || r)          (CRH)
    sn       = SHA256(sk || r)                 (PRF)
    cmtS     = SHA256(value_s || pk_recv || r_s || sn_old)
    cmtA     = SHA256(value || sn || r)
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
from .common import (
    LessComparisonGadget,
    Sha256CmtaGadget,
    Sha256CmtsGadget,
    Sha256CrhGadget,
    Sha256PrfGadget,
)
from .mint import pack_bits


class NoteGadgetWithPacking:
    """send/circuit/note.tcc:6-78 (different field set than mint's)."""

    def __init__(self, pb: Protoboard, value_old, sn_old, r_old,
                 value_s, pk_recv, r_s):
        self.pb = pb
        self.value_old, self.sn_old, self.r_old = value_old, sn_old, r_old
        self.value_s, self.pk_recv, self.r_s = value_s, pk_recv, r_s
        self.value_old_packed = pb.allocate()
        self.value_s_packed = pb.allocate()

    def generate_constraints(self):
        for b in self.value_old:
            generate_boolean_constraint(self.pb, b)
        for b in self.value_s:
            generate_boolean_constraint(self.pb, b)
        self.sn_old.generate_constraints()
        self.r_old.generate_constraints()
        self.pk_recv.generate_constraints()
        self.r_s.generate_constraints()

    def _fill_u64(self, arr, v):
        for var, bit in zip(arr, NT.uint64_to_bits(v)):
            self.pb.setval(var, bit)

    def generate_witness(self, note_old: NT.Note, note_s: NT.NoteS):
        self._fill_u64(self.value_old, note_old.value)
        self.pb.setval(self.value_old_packed, note_old.value)
        self.sn_old.fill_with_bits(NT.bytes_to_bits(note_old.sn))
        self.r_old.fill_with_bits(NT.bytes_to_bits(note_old.r))
        self._fill_u64(self.value_s, note_s.value)
        self.pb.setval(self.value_s_packed, note_s.value)
        self.pk_recv.fill_with_bits(NT.bytes_to_bits(note_s.pk))
        self.r_s.fill_with_bits(NT.bytes_to_bits(note_s.r))


class NoteGadgetWithComparisonForValueOld(NoteGadgetWithPacking):
    """send/circuit/less_cmp.tcc: value_s <= value_old."""

    def __init__(self, pb, value_old, sn_old, r_old, value_s, pk_recv, r_s):
        super().__init__(pb, value_old, sn_old, r_old, value_s, pk_recv, r_s)
        self.less_cmp = LessComparisonGadget(
            pb, self.value_s_packed, self.value_old_packed)

    def generate_constraints(self):
        super().generate_constraints()
        self.less_cmp.generate_constraints()

    def generate_witness(self, note_old, note_s):
        super().generate_witness(note_old, note_s)
        self.less_cmp.generate_witness()


class NoteGadgetWithPackingAndSub(NoteGadgetWithPacking):
    """send/circuit/note.tcc:84-152: adds value = value_old - value_s."""

    def __init__(self, pb, value_s, pk_recv, r_s, value_old, sn_old, r_old,
                 value, sn, r, sk, pk_sender):
        super().__init__(pb, value_old, sn_old, r_old, value_s, pk_recv, r_s)
        self.value, self.sn, self.r = value, sn, r
        self.sk, self.pk_sender = sk, pk_sender
        self.value_packed = pb.allocate()

    def generate_constraints(self):
        super().generate_constraints()
        for b in self.value:
            generate_boolean_constraint(self.pb, b)
        self.sn.generate_constraints()
        self.r.generate_constraints()
        self.sk.generate_constraints()
        self.pk_sender.generate_constraints()
        self.pb.add_constraint(
            LC.of(1),
            LC.var(self.value_old_packed) - LC.var(self.value_s_packed),
            LC.var(self.value_packed))

    def generate_witness(self, note_s: NT.NoteS, note_old: NT.Note,
                         note: NT.Note, sk_data: bytes, pk_data: bytes):
        super().generate_witness(note_old, note_s)
        self._fill_u64(self.value, note.value)
        self.pb.setval(self.value_packed, note.value)
        self.sn.fill_with_bits(NT.bytes_to_bits(note.sn))
        self.r.fill_with_bits(NT.bytes_to_bits(note.r))
        self.sk.fill_with_bits(NT.bytes_to_bits(sk_data))
        self.pk_sender.fill_with_bits(NT.bytes_to_bits(pk_data))


class SendGadget:
    """src/send/circuit/gadget.tcc:25-327."""

    PACKED_INPUTS = 5  # ceil(1024 / 253)

    def __init__(self, pb: Protoboard):
        self.pb = pb
        self.zk_packed_inputs = pb.allocate_array(self.PACKED_INPUTS)
        pb.set_input_sizes(self.PACKED_INPUTS)

        self.zk_unpacked_inputs: List[int] = []
        self.cmtA_old = self._alloc_uint256()
        self.sn_old = self._alloc_uint256()
        self.cmtS = self._alloc_uint256()
        self.cmtA = self._alloc_uint256()
        assert len(self.zk_unpacked_inputs) == 1024

        self.unpacker = MultipackingGadget(
            pb, self.zk_unpacked_inputs, self.zk_packed_inputs, FR_CAPACITY)

        self.ZERO = pb.allocate()
        self.value_old = pb.allocate_array(64)
        self.r_old = DigestVariable(pb, 256)
        self.value_s = pb.allocate_array(64)
        self.pk_recv = DigestVariable(pb, 160)
        self.pk_sender = DigestVariable(pb, 160)
        self.r_s = DigestVariable(pb, 256)
        self.value = pb.allocate_array(64)
        self.sn = DigestVariable(pb, 256)
        self.r = DigestVariable(pb, 256)
        self.sk = DigestVariable(pb, 256)

        self.lessCMP = NoteGadgetWithComparisonForValueOld(
            pb, self.value_old, self.sn_old, self.r_old,
            self.value_s, self.pk_recv, self.r_s)

        self.noteSUB = NoteGadgetWithPackingAndSub(
            pb, self.value_s, self.pk_recv, self.r_s,
            self.value_old, self.sn_old, self.r_old,
            self.value, self.sn, self.r, self.sk, self.pk_sender)

        self.crh_to_inputs_r_s = Sha256CrhGadget(
            pb, self.ZERO, self.pk_sender.bits, self.r.bits, self.r_s)

        self.prf_to_inputs_sn = Sha256PrfGadget(
            pb, self.ZERO, self.sk.bits, self.r.bits, self.sn)

        self.commit_to_inputs_cmt_old = Sha256CmtaGadget(
            pb, self.ZERO, self.value_old, self.sn_old.bits,
            self.r_old.bits, self.cmtA_old)

        self.commit_to_input_cmt_s = Sha256CmtsGadget(
            pb, self.ZERO, self.value_s, self.pk_recv.bits,
            self.r_s.bits, self.sn_old.bits, self.cmtS)

        self.commit_to_inputs_cmt = Sha256CmtaGadget(
            pb, self.ZERO, self.value, self.sn.bits, self.r.bits, self.cmtA)

    def _alloc_uint256(self) -> DigestVariable:
        d = DigestVariable(self.pb, 256)
        self.zk_unpacked_inputs.extend(d.bits)
        return d

    def generate_constraints(self):
        self.unpacker.generate_constraints(True)
        self.lessCMP.generate_constraints()
        self.noteSUB.generate_constraints()
        generate_equals_const_constraint(self.pb, self.ZERO, 0)
        self.r_s.generate_constraints()
        self.crh_to_inputs_r_s.generate_constraints()
        self.sn.generate_constraints()
        self.prf_to_inputs_sn.generate_constraints()
        self.sn_old.generate_constraints()
        self.cmtA_old.generate_constraints()
        self.commit_to_inputs_cmt_old.generate_constraints()
        self.cmtS.generate_constraints()
        self.commit_to_input_cmt_s.generate_constraints()
        self.cmtA.generate_constraints()
        self.commit_to_inputs_cmt.generate_constraints()

    def generate_witness(self, note_old: NT.Note, note_s: NT.NoteS,
                         note: NT.Note, cmtA_old: bytes, cmtS: bytes,
                         cmtA: bytes, sk_data: bytes, pk_data: bytes):
        self.lessCMP.generate_witness(note_old, note_s)
        self.noteSUB.generate_witness(note_s, note_old, note, sk_data, pk_data)
        self.pb.setval(self.ZERO, 0)
        self.crh_to_inputs_r_s.generate_witness()
        self.prf_to_inputs_sn.generate_witness()
        self.commit_to_inputs_cmt_old.generate_witness()
        self.commit_to_input_cmt_s.generate_witness()
        self.commit_to_inputs_cmt.generate_witness()
        self.cmtA_old.fill_with_bits(NT.bytes_to_bits(cmtA_old))
        self.cmtS.fill_with_bits(NT.bytes_to_bits(cmtS))
        self.cmtA.fill_with_bits(NT.bytes_to_bits(cmtA))
        self.unpacker.witness_from_bits()

    @staticmethod
    def witness_map(cmtA_old: bytes, sn_old: bytes, cmtS: bytes,
                    cmtA: bytes) -> List[int]:
        bits = (NT.bytes_to_bits(cmtA_old) + NT.bytes_to_bits(sn_old)
                + NT.bytes_to_bits(cmtS) + NT.bytes_to_bits(cmtA))
        return pack_bits(bits)

"""Gadgets shared across the four circuits: the two-block SHA256 commitment /
PRF hashers, the one-block CRH, the CMTS hasher, and the less-than comparison.

Replicated with exact allocation order from src/{mint,send}/circuit/
commitment.tcc, comparison.tcc and gadgetlib1 basic_gadgets (disjunction).
"""

from __future__ import annotations

from typing import List

from ..crypto import notes as NT
from ..r1cs.protoboard import (
    LC,
    Protoboard,
    generate_boolean_constraint,
)
from ..r1cs.gadgets.basic import BlockVariable, DigestVariable, PackingGadget
from ..r1cs.gadgets.sha256 import Sha256CompressionGadget, sha256_default_IV
from ..fields.constants import R_MOD


def from_bits(bits: List[int], ZERO: int) -> List[int]:
    """Constant bit pattern -> ONE/ZERO variable list (utils.tcc from_bits)."""
    return [0 if b else ZERO for b in bits]


def length_padding(msg_bits: int, pad_to: int, ZERO: int) -> List[int]:
    """SHA-256 final padding: 0x80, zeros, 64-bit big-endian length."""
    zeros = pad_to - 1 - 64
    bits = [1] + [0] * zeros + NT.bytes_to_bits(msg_bits.to_bytes(8, "big"))
    return from_bits(bits, ZERO)


class Sha256CmtaGadget:
    """cmtA = SHA256(v(64)||sn(256)||r(256)), 576-bit message, 2 blocks
    (mint/circuit/commitment.tcc:14-100)."""

    def __init__(self, pb: Protoboard, ZERO: int, v, sn, rho,
                 cmtA: DigestVariable):
        self.intermediate_hash = DigestVariable(pb, 256)
        pad = length_padding(576, 448, ZERO)
        block1 = BlockVariable(pb, [v, sn, rho[:192]])
        block2 = BlockVariable(pb, [rho[192:], pad])
        IV = sha256_default_IV()
        self.hasher1 = Sha256CompressionGadget(
            pb, IV, block1.bits, self.intermediate_hash)
        self.hasher2 = Sha256CompressionGadget(
            pb, self.intermediate_hash.bits, block2.bits, cmtA)

    def generate_constraints(self):
        self.intermediate_hash.generate_constraints()
        self.hasher1.generate_constraints()
        self.hasher2.generate_constraints()

    def generate_witness(self):
        self.hasher1.generate_witness()
        self.hasher2.generate_witness()


class Sha256PrfGadget:
    """sn = SHA256(sk||r), 512-bit message, 2 blocks (commitment.tcc:103+)."""

    def __init__(self, pb: Protoboard, ZERO: int, sk, rho,
                 sn: DigestVariable):
        self.intermediate_hash = DigestVariable(pb, 256)
        pad = length_padding(512, 512, ZERO)
        block1 = BlockVariable(pb, [sk, rho])
        block2 = BlockVariable(pb, [pad])
        IV = sha256_default_IV()
        self.hasher1 = Sha256CompressionGadget(
            pb, IV, block1.bits, self.intermediate_hash)
        self.hasher2 = Sha256CompressionGadget(
            pb, self.intermediate_hash.bits, block2.bits, sn)

    def generate_constraints(self):
        self.intermediate_hash.generate_constraints()
        self.hasher1.generate_constraints()
        self.hasher2.generate_constraints()

    def generate_witness(self):
        self.hasher1.generate_witness()
        self.hasher2.generate_witness()


class Sha256CmtsGadget:
    """cmtS = SHA256(v(64)||pk(160)||r(256)||sn_old(256)), 736-bit message,
    2 blocks (send/circuit/commitment.tcc:93-178)."""

    def __init__(self, pb: Protoboard, ZERO: int, v, pk_recv, r, sn_old,
                 cmtS: DigestVariable):
        pad = length_padding(736, 288, ZERO)
        self.intermediate_hash1 = DigestVariable(pb, 256)
        block1 = BlockVariable(pb, [v, pk_recv, r, sn_old[:32]])
        block2 = BlockVariable(pb, [sn_old[32:], pad])
        IV = sha256_default_IV()
        self.hasher1 = Sha256CompressionGadget(
            pb, IV, block1.bits, self.intermediate_hash1)
        self.hasher2 = Sha256CompressionGadget(
            pb, self.intermediate_hash1.bits, block2.bits, cmtS)

    def generate_constraints(self):
        self.intermediate_hash1.generate_constraints()
        self.hasher1.generate_constraints()
        self.hasher2.generate_constraints()

    def generate_witness(self):
        self.hasher1.generate_witness()
        self.hasher2.generate_witness()


class Sha256CrhGadget:
    """r_s = SHA256(pk_sender(160)||r(256)), 416-bit message, 1 block
    (send/circuit/commitment.tcc:267-316)."""

    def __init__(self, pb: Protoboard, ZERO: int, pk_sender, r,
                 r_s: DigestVariable):
        pad = length_padding(416, 96, ZERO)
        block1 = BlockVariable(pb, [pk_sender, r, pad])
        IV = sha256_default_IV()
        self.hasher1 = Sha256CompressionGadget(pb, IV, block1.bits, r_s)

    def generate_constraints(self):
        self.hasher1.generate_constraints()

    def generate_witness(self):
        self.hasher1.generate_witness()


class DisjunctionGadget:
    """output = OR(inputs) (basic_gadgets.tcc:179-260)."""

    def __init__(self, pb: Protoboard, inputs: List[int], output: int):
        self.pb = pb
        self.inputs = inputs
        self.output = output
        self.inv = pb.allocate()

    def generate_constraints(self):
        s = LC()
        for i in self.inputs:
            s = s + LC.var(i)
        self.pb.add_constraint(LC.var(self.inv), s, LC.var(self.output))
        self.pb.add_constraint(1 - LC.var(self.output), s, LC.of(0))

    def generate_witness(self):
        pb = self.pb
        total = sum(pb.val(i) for i in self.inputs) % R_MOD
        if total == 0:
            pb.setval(self.inv, 0)
            pb.setval(self.output, 0)
        else:
            pb.setval(self.inv, pow(total, -1, R_MOD))
            pb.setval(self.output, 1)


class LessComparisonGadget:
    """A < B via alpha = 2^64 + B - A unpacking (send/circuit/comparison.tcc).

    Bug-compatible with the reference: alpha[64] is the constant ONE (the
    code pushes pb_variable(0)), so the enforced relation is A <= B and the
    final `1*not_all_zeros = not_all_zeros` constraint is a tautology."""

    N = 64

    def __init__(self, pb: Protoboard, A: int, B: int):
        self.pb = pb
        self.A, self.B = A, B
        self.alpha = pb.allocate_array(self.N)
        self.alpha_full = self.alpha + [0]  # alpha[n] = ONE (index 0)
        self.alpha_packed = pb.allocate()
        self.not_all_zeros = pb.allocate()
        self.pack_alpha = PackingGadget(pb, self.alpha_full, self.alpha_packed)
        self.all_zeros_test = DisjunctionGadget(pb, self.alpha,
                                                self.not_all_zeros)

    def generate_constraints(self):
        generate_boolean_constraint(self.pb, self.not_all_zeros)
        self.pack_alpha.generate_constraints(True)
        self.pb.add_constraint(
            LC.of(1),
            (1 << self.N) + LC.var(self.B) - LC.var(self.A),
            LC.var(self.alpha_packed))
        self.all_zeros_test.generate_constraints()
        self.pb.add_constraint(LC.of(1), LC.var(self.not_all_zeros),
                               LC.var(self.not_all_zeros))

    def generate_witness(self):
        pb = self.pb
        v = ((1 << self.N) + pb.val(self.B) - pb.val(self.A)) % R_MOD
        pb.setval(self.alpha_packed, v)
        self.pack_alpha.witness_from_packed()
        self.all_zeros_test.generate_witness()

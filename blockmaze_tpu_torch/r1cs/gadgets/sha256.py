"""In-circuit SHA-256 compression function.

Faithful replication of libsnark's gadget structure — allocation order,
constraint order and formulas — from
gadgetlib1/gadgets/hashes/sha256/{sha256_aux,sha256_components,sha256_gadget}.tcc.
The witness vector must match libsnark index-for-index because the reference
proving keys encode per-variable query points.

Bit conventions: digests/blocks are bit arrays in SHA message order (bytes in
stream order, MSB-first within each byte). Word views used by the rounds are
LSB-first 32-bit slices of the reversed array (sha256_gadget.tcc:34-42).
"""

from __future__ import annotations

from typing import List

from ..protoboard import (
    LC,
    Protoboard,
    generate_boolean_constraint,
    vlc,
)
from .basic import DigestVariable, PackingGadget

SHA256_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]

SHA256_H = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


def sha256_default_IV() -> List[LC]:
    """256 constant LCs with the IV bits (sha256_components.tcc:35-52)."""
    out = []
    for i in range(256):
        iv_val = (SHA256_H[i // 32] >> (31 - (i % 32))) & 1
        out.append(LC.of(iv_val))
    return out


def _word_views_lsb_first(bits: List) -> List[List]:
    """bits (256 or 512, message order) -> list of 32-bit LSB-first words.

    Matches `pb_variable_array(x.rbegin() + (n-1-i)*32, x.rbegin() + (n-i)*32)`:
    word i = reversed(bits)[ (n-1-i)*32 : (n-i)*32 ]."""
    rev = list(reversed(bits))
    n = len(bits) // 32
    return [rev[(n - 1 - i) * 32:(n - i) * 32] for i in range(n)]


class XOR3Gadget:
    """sha256_aux.tcc:59-109."""

    def __init__(self, pb, A, B, C, assume_C_is_zero: bool, out):
        self.pb, self.A, self.B, self.C = pb, vlc(A), vlc(B), vlc(C)
        self.assume_C_is_zero = assume_C_is_zero
        self.out = out
        if not assume_C_is_zero:
            self.tmp = pb.allocate()

    def generate_constraints(self):
        A, B, C, out = self.A, self.B, self.C, vlc(self.out)
        if self.assume_C_is_zero:
            self.pb.add_constraint(2 * A, B, A + B - out)
        else:
            tmp = LC.var(self.tmp)
            self.pb.add_constraint(2 * A, B, A + B - tmp)
            self.pb.add_constraint(2 * tmp, C, tmp + C - out)

    def generate_witness(self):
        pb = self.pb
        a, b, c = pb.lc_val(self.A), pb.lc_val(self.B), pb.lc_val(self.C)
        if self.assume_C_is_zero:
            pb.setval(self.out, a ^ b)
        else:
            pb.setval(self.tmp, a ^ b)
            pb.setval(self.out, (a ^ b) ^ c)


def _rotr(arr, i, k):
    return arr[(i + k) % 32]


class SmallSigmaGadget:
    """σ0/σ1 of the message schedule (sha256_aux.tcc:117-160)."""

    def __init__(self, pb: Protoboard, W: List, result, rot1, rot2, shift):
        self.pb = pb
        self.W = W
        self.result = result
        self.result_bits = pb.allocate_array(32)
        self.compute_bits = []
        for i in range(32):
            self.compute_bits.append(XOR3Gadget(
                pb, _rotr(W, i, rot1), _rotr(W, i, rot2),
                W[i + shift] if i + shift < 32 else LC.of(1),
                i + shift >= 32, self.result_bits[i]))
        self.pack_result = PackingGadget(pb, self.result_bits, result)

    def generate_constraints(self):
        for g in self.compute_bits:
            g.generate_constraints()
        self.pack_result.generate_constraints(False)

    def generate_witness(self):
        for g in self.compute_bits:
            g.generate_witness()
        self.pack_result.witness_from_bits()


class BigSigmaGadget:
    """Σ0/Σ1 of the round function (sha256_aux.tcc:162-204)."""

    def __init__(self, pb: Protoboard, W: List, result, rot1, rot2, rot3):
        self.pb = pb
        self.result = result
        self.result_bits = pb.allocate_array(32)
        self.compute_bits = [
            XOR3Gadget(pb, _rotr(W, i, rot1), _rotr(W, i, rot2),
                       _rotr(W, i, rot3), False, self.result_bits[i])
            for i in range(32)
        ]
        self.pack_result = PackingGadget(pb, self.result_bits, result)

    def generate_constraints(self):
        for g in self.compute_bits:
            g.generate_constraints()
        self.pack_result.generate_constraints(False)

    def generate_witness(self):
        for g in self.compute_bits:
            g.generate_witness()
        self.pack_result.witness_from_bits()


class ChoiceGadget:
    """Ch(x,y,z) (sha256_aux.tcc:210-243)."""

    def __init__(self, pb: Protoboard, X, Y, Z, result):
        self.pb, self.X, self.Y, self.Z = pb, X, Y, Z
        self.result = result
        self.result_bits = pb.allocate_array(32)
        self.pack_result = PackingGadget(pb, self.result_bits, result)

    def generate_constraints(self):
        for i in range(32):
            x, y, z = vlc(self.X[i]), vlc(self.Y[i]), vlc(self.Z[i])
            self.pb.add_constraint(x, y - z, LC.var(self.result_bits[i]) - z)
        self.pack_result.generate_constraints(False)

    def generate_witness(self):
        pb = self.pb
        for i in range(32):
            x, y, z = pb.lc_val(vlc(self.X[i])), pb.lc_val(vlc(self.Y[i])), \
                pb.lc_val(vlc(self.Z[i]))
            pb.setval(self.result_bits[i], (x & y) | ((1 - x) & z))
        self.pack_result.witness_from_bits()


class MajorityGadget:
    """Maj(x,y,z) (sha256_aux.tcc:247-291)."""

    def __init__(self, pb: Protoboard, X, Y, Z, result):
        self.pb, self.X, self.Y, self.Z = pb, X, Y, Z
        self.result = result
        self.result_bits = pb.allocate_array(32)
        self.pack_result = PackingGadget(pb, self.result_bits, result)

    def generate_constraints(self):
        for i in range(32):
            rb = LC.var(self.result_bits[i])
            generate_boolean_constraint(self.pb, rb)
            s = vlc(self.X[i]) + vlc(self.Y[i]) + vlc(self.Z[i]) - 2 * rb
            self.pb.add_constraint(s, 1 - s, LC())
        self.pack_result.generate_constraints(False)

    def generate_witness(self):
        pb = self.pb
        for i in range(32):
            v = pb.lc_val(vlc(self.X[i])) + pb.lc_val(vlc(self.Y[i])) + \
                pb.lc_val(vlc(self.Z[i]))
            pb.setval(self.result_bits[i], v // 2)
        self.pack_result.witness_from_bits()


class LastbitsGadget:
    """Truncate X (X_bits wide) to its low 32 bits (sha256_aux.tcc:20-56)."""

    def __init__(self, pb: Protoboard, X, X_bits: int, result, result_bits):
        self.pb = pb
        self.X = X
        self.result = result
        self.result_bits = result_bits
        self.full_bits = list(result_bits) + \
            [pb.allocate() for _ in range(len(result_bits), X_bits)]
        self.unpack_bits = PackingGadget(pb, self.full_bits, X)
        self.pack_result = PackingGadget(pb, result_bits, result)

    def generate_constraints(self):
        self.unpack_bits.generate_constraints(True)
        self.pack_result.generate_constraints(False)

    def generate_witness(self):
        self.unpack_bits.witness_from_packed()
        self.pack_result.witness_from_bits()


class MessageScheduleGadget:
    """sha256_components.tcc:55-146."""

    def __init__(self, pb: Protoboard, M: List, packed_W: List[int]):
        self.pb = pb
        self.packed_W = packed_W
        self.W_bits: List[List] = [None] * 64
        words = _word_views_lsb_first(M)
        self.pack_W = []
        for i in range(16):
            self.W_bits[i] = words[i]
            self.pack_W.append(PackingGadget(pb, self.W_bits[i], packed_W[i]))

        self.sigma0 = [None] * 64
        self.sigma1 = [None] * 64
        self.compute_sigma0 = [None] * 64
        self.compute_sigma1 = [None] * 64
        self.unreduced_W = [None] * 64
        self.mod_reduce_W = [None] * 64
        for i in range(16, 64):
            self.sigma0[i] = pb.allocate()
            self.sigma1[i] = pb.allocate()
            self.compute_sigma0[i] = SmallSigmaGadget(
                pb, self.W_bits[i - 15], self.sigma0[i], 7, 18, 3)
            self.compute_sigma1[i] = SmallSigmaGadget(
                pb, self.W_bits[i - 2], self.sigma1[i], 17, 19, 10)
            self.unreduced_W[i] = pb.allocate()
            self.W_bits[i] = pb.allocate_array(32)
            self.mod_reduce_W[i] = LastbitsGadget(
                pb, self.unreduced_W[i], 32 + 2, packed_W[i], self.W_bits[i])

    def generate_constraints(self):
        for i in range(16):
            self.pack_W[i].generate_constraints(False)
        for i in range(16, 64):
            self.compute_sigma0[i].generate_constraints()
            self.compute_sigma1[i].generate_constraints()
            self.pb.add_constraint(
                LC.of(1),
                LC.var(self.sigma0[i]) + LC.var(self.sigma1[i]) +
                LC.var(self.packed_W[i - 16]) + LC.var(self.packed_W[i - 7]),
                LC.var(self.unreduced_W[i]))
            self.mod_reduce_W[i].generate_constraints()

    def generate_witness(self):
        pb = self.pb
        for i in range(16):
            self.pack_W[i].witness_from_bits()
        for i in range(16, 64):
            self.compute_sigma0[i].generate_witness()
            self.compute_sigma1[i].generate_witness()
            pb.setval(self.unreduced_W[i],
                      pb.val(self.sigma0[i]) + pb.val(self.sigma1[i]) +
                      pb.val(self.packed_W[i - 16]) + pb.val(self.packed_W[i - 7]))
            self.mod_reduce_W[i].generate_witness()


class RoundFunctionGadget:
    """sha256_components.tcc:148-250."""

    def __init__(self, pb: Protoboard, a, b, c, d, e, f, g, h,
                 W: int, K: int, new_a: List[int], new_e: List[int]):
        self.pb = pb
        self.a, self.b, self.c, self.d = a, b, c, d
        self.e, self.f, self.g, self.h = e, f, g, h
        self.W, self.K = W, K
        self.new_a, self.new_e = new_a, new_e

        self.sigma0 = pb.allocate()
        self.sigma1 = pb.allocate()
        self.compute_sigma0 = BigSigmaGadget(pb, a, self.sigma0, 2, 13, 22)
        self.compute_sigma1 = BigSigmaGadget(pb, e, self.sigma1, 6, 11, 25)
        self.choice = pb.allocate()
        self.compute_choice = ChoiceGadget(pb, e, f, g, self.choice)
        self.majority = pb.allocate()
        self.compute_majority = MajorityGadget(pb, a, b, c, self.majority)
        self.packed_d = pb.allocate()
        self.pack_d = PackingGadget(pb, d, self.packed_d)
        self.packed_h = pb.allocate()
        self.pack_h = PackingGadget(pb, h, self.packed_h)
        self.unreduced_new_a = pb.allocate()
        self.unreduced_new_e = pb.allocate()
        self.packed_new_a = pb.allocate()
        self.packed_new_e = pb.allocate()
        self.mod_reduce_new_a = LastbitsGadget(
            pb, self.unreduced_new_a, 32 + 3, self.packed_new_a, new_a)
        self.mod_reduce_new_e = LastbitsGadget(
            pb, self.unreduced_new_e, 32 + 3, self.packed_new_e, new_e)

    def generate_constraints(self):
        self.compute_sigma0.generate_constraints()
        self.compute_sigma1.generate_constraints()
        self.compute_choice.generate_constraints()
        self.compute_majority.generate_constraints()
        self.pack_d.generate_constraints(False)
        self.pack_h.generate_constraints(False)
        self.pb.add_constraint(
            LC.of(1),
            LC.var(self.packed_h) + LC.var(self.sigma1) + LC.var(self.choice)
            + self.K + LC.var(self.W) + LC.var(self.sigma0)
            + LC.var(self.majority),
            LC.var(self.unreduced_new_a))
        self.pb.add_constraint(
            LC.of(1),
            LC.var(self.packed_d) + LC.var(self.packed_h)
            + LC.var(self.sigma1) + LC.var(self.choice) + self.K
            + LC.var(self.W),
            LC.var(self.unreduced_new_e))
        self.mod_reduce_new_a.generate_constraints()
        self.mod_reduce_new_e.generate_constraints()

    def generate_witness(self):
        pb = self.pb
        self.compute_sigma0.generate_witness()
        self.compute_sigma1.generate_witness()
        self.compute_choice.generate_witness()
        self.compute_majority.generate_witness()
        self.pack_d.witness_from_bits()
        self.pack_h.witness_from_bits()
        pb.setval(self.unreduced_new_a,
                  pb.val(self.packed_h) + pb.val(self.sigma1)
                  + pb.val(self.choice) + self.K + pb.val(self.W)
                  + pb.val(self.sigma0) + pb.val(self.majority))
        pb.setval(self.unreduced_new_e,
                  pb.val(self.packed_d) + pb.val(self.packed_h)
                  + pb.val(self.sigma1) + pb.val(self.choice) + self.K
                  + pb.val(self.W))
        self.mod_reduce_new_a.generate_witness()
        self.mod_reduce_new_e.generate_witness()


class Sha256CompressionGadget:
    """sha256_gadget.tcc:19-230: one compression of a 512-bit block."""

    def __init__(self, pb: Protoboard, prev_output: List, new_block: List,
                 output: DigestVariable):
        self.pb = pb
        self.packed_W = pb.allocate_array(64)
        self.message_schedule = MessageScheduleGadget(pb, new_block,
                                                      self.packed_W)
        words = _word_views_lsb_first(prev_output)
        # round_a = prev.rbegin()+7*32..8*32 = first digest word (a), LSB-first
        round_a = [words[0]]
        round_b = [words[1]]
        round_c = [words[2]]
        round_d = [words[3]]
        round_e = [words[4]]
        round_f = [words[5]]
        round_g = [words[6]]
        round_h = [words[7]]

        self.round_functions = []
        for i in range(64):
            round_h.append(round_g[i])
            round_g.append(round_f[i])
            round_f.append(round_e[i])
            round_d.append(round_c[i])
            round_c.append(round_b[i])
            round_b.append(round_a[i])
            new_round_a = pb.allocate_array(32)
            round_a.append(new_round_a)
            new_round_e = pb.allocate_array(32)
            round_e.append(new_round_e)
            self.round_functions.append(RoundFunctionGadget(
                pb, round_a[i], round_b[i], round_c[i], round_d[i],
                round_e[i], round_f[i], round_g[i], round_h[i],
                self.packed_W[i], SHA256_K[i], round_a[i + 1],
                round_e[i + 1]))

        self.unreduced_output = pb.allocate_array(8)
        self.reduced_output = pb.allocate_array(8)
        out_words = _word_views_lsb_first(output.bits)
        self.reduce_output = []
        for i in range(8):
            # output.bits.rbegin()+(7-i)*32 .. (8-i)*32 == out_words[i]
            self.reduce_output.append(LastbitsGadget(
                pb, self.unreduced_output[i], 32 + 1,
                self.reduced_output[i], out_words[i]))

    def generate_constraints(self):
        self.message_schedule.generate_constraints()
        for rf in self.round_functions:
            rf.generate_constraints()
        for i in range(4):
            self.pb.add_constraint(
                LC.of(1),
                LC.var(self.round_functions[3 - i].packed_d)
                + LC.var(self.round_functions[63 - i].packed_new_a),
                LC.var(self.unreduced_output[i]))
            self.pb.add_constraint(
                LC.of(1),
                LC.var(self.round_functions[3 - i].packed_h)
                + LC.var(self.round_functions[63 - i].packed_new_e),
                LC.var(self.unreduced_output[4 + i]))
        for i in range(8):
            self.reduce_output[i].generate_constraints()

    def generate_witness(self):
        pb = self.pb
        self.message_schedule.generate_witness()
        for rf in self.round_functions:
            rf.generate_witness()
        for i in range(4):
            pb.setval(self.unreduced_output[i],
                      pb.val(self.round_functions[3 - i].packed_d)
                      + pb.val(self.round_functions[63 - i].packed_new_a))
            pb.setval(self.unreduced_output[4 + i],
                      pb.val(self.round_functions[3 - i].packed_h)
                      + pb.val(self.round_functions[63 - i].packed_new_e))
        for i in range(8):
            self.reduce_output[i].generate_witness()

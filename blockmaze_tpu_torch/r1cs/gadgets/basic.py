"""Packing / digest / block gadgets (libsnark gadgetlib1 basic_gadgets and
hash_io), with identical allocation and constraint order."""

from __future__ import annotations

from typing import List

from ..protoboard import (
    LC,
    Protoboard,
    generate_boolean_constraint,
    packing_sum,
    vlc,
)


class PackingGadget:
    """packed = Σ bits[i]·2^i (basic_gadgets.tcc:32-59). No allocation."""

    def __init__(self, pb: Protoboard, bits: List, packed):
        self.pb = pb
        self.bits = bits
        self.packed = packed

    def generate_constraints(self, enforce_bitness: bool):
        self.pb.add_constraint(LC.of(1), packing_sum(self.bits), vlc(self.packed))
        if enforce_bitness:
            for b in self.bits:
                generate_boolean_constraint(self.pb, b)

    def witness_from_bits(self):
        acc = 0
        for i, b in enumerate(self.bits):
            acc += self.pb.lc_val(b) << i
        self.pb.setval(self.packed, acc)

    def witness_from_packed(self):
        v = self.pb.lc_val(self.packed)
        for i, b in enumerate(self.bits):
            if b == 0:
                # reference writes through pb.val(ONE) into the constant term;
                # a valid witness always writes 1 there, so it is a no-op
                assert (v >> i) & 1 == 1
                continue
            self.pb.setval(b, (v >> i) & 1)


class MultipackingGadget:
    """basic_gadgets.tcc:62-106."""

    def __init__(self, pb: Protoboard, bits: List, packed_vars: List,
                 chunk_size: int):
        self.pb = pb
        num_chunks = -(-len(bits) // chunk_size)
        assert len(packed_vars) == num_chunks
        self.packers = [
            PackingGadget(pb, bits[i * chunk_size:(i + 1) * chunk_size],
                          packed_vars[i])
            for i in range(num_chunks)
        ]

    def generate_constraints(self, enforce_bitness: bool):
        for p in self.packers:
            p.generate_constraints(enforce_bitness)

    def witness_from_bits(self):
        for p in self.packers:
            p.witness_from_bits()


class DigestVariable:
    """hash_io.tcc:13-19: allocates `size` bit variables."""

    def __init__(self, pb: Protoboard, size: int):
        self.pb = pb
        self.size = size
        self.bits = pb.allocate_array(size)

    def generate_constraints(self):
        for b in self.bits:
            generate_boolean_constraint(self.pb, b)

    def fill_with_bits(self, bits: List[int]):
        assert len(bits) == self.size
        for var, bit in zip(self.bits, bits):
            self.pb.setval(var, bit)


class BlockVariable:
    """hash_io block_variable with parts: concatenation, no allocation."""

    def __init__(self, pb: Protoboard, parts: List[List]):
        self.pb = pb
        self.bits = []
        for p in parts:
            self.bits.extend(p)

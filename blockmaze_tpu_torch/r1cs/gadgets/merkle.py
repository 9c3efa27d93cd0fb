"""Merkle authentication-path gadgets (libsnark gadgetlib1/gadgets/merkle_tree
+ hashes/digest_selector_gadget + bit_vector_copy), exact allocation order.

The in-circuit node hash is a single padding-free SHA-256 compression of
left||right with the standard IV (sha256_two_to_one_hash_gadget,
sha256_gadget.tcc:152-191)."""

from __future__ import annotations

from typing import List

from ..protoboard import LC, Protoboard, vlc
from .basic import DigestVariable, MultipackingGadget
from .sha256 import Sha256CompressionGadget, sha256_default_IV
from ...fields.constants import FR_CAPACITY


class Sha256TwoToOneHashGadget:
    """hash = compress(IV, left||right) (sha256_gadget.tcc:152-191)."""

    def __init__(self, pb: Protoboard, block_bits: List[int],
                 output: DigestVariable):
        self.f = Sha256CompressionGadget(pb, sha256_default_IV(), block_bits,
                                         output)

    def generate_constraints(self, ensure_output_bitness: bool = False):
        self.f.generate_constraints()

    def generate_witness(self):
        self.f.generate_witness()


class MerkleAuthenticationPathVariable:
    """Per level: left and right digest variables
    (merkle_authentication_path_variable.tcc:14-53)."""

    def __init__(self, pb: Protoboard, tree_depth: int):
        self.pb = pb
        self.tree_depth = tree_depth
        self.left_digests = []
        self.right_digests = []
        for _ in range(tree_depth):
            self.left_digests.append(DigestVariable(pb, 256))
            self.right_digests.append(DigestVariable(pb, 256))

    def generate_constraints(self):
        for i in range(self.tree_depth):
            self.left_digests[i].generate_constraints()
            self.right_digests[i].generate_constraints()

    def generate_witness(self, address: int, path_bits: List[List[int]]):
        for i in range(self.tree_depth):
            if address & (1 << (self.tree_depth - 1 - i)):
                self.left_digests[i].fill_with_bits(path_bits[i])
            else:
                self.right_digests[i].fill_with_bits(path_bits[i])


class DigestSelectorGadget:
    """input = is_right ? right : left (digest_selector_gadget.tcc)."""

    def __init__(self, pb: Protoboard, input_d: DigestVariable, is_right,
                 left: DigestVariable, right: DigestVariable):
        self.pb = pb
        self.input = input_d
        self.is_right = is_right
        self.left, self.right = left, right

    def generate_constraints(self):
        for i in range(256):
            self.pb.add_constraint(
                vlc(self.is_right),
                LC.var(self.right.bits[i]) - LC.var(self.left.bits[i]),
                LC.var(self.input.bits[i]) - LC.var(self.left.bits[i]))

    def generate_witness(self):
        pb = self.pb
        if pb.lc_val(vlc(self.is_right)) == 1:
            for i in range(256):
                pb.setval(self.right.bits[i], pb.val(self.input.bits[i]))
        else:
            for i in range(256):
                pb.setval(self.left.bits[i], pb.val(self.input.bits[i]))


class FieldVectorCopyGadget:
    """do_copy * (source - target) = 0 (basic_gadgets.tcc:115-147)."""

    def __init__(self, pb: Protoboard, source: List[int], target: List[int],
                 do_copy):
        self.pb, self.source, self.target, self.do_copy = pb, source, target, do_copy

    def generate_constraints(self):
        for s, t in zip(self.source, self.target):
            self.pb.add_constraint(vlc(self.do_copy),
                                   LC.var(s) - LC.var(t), LC.of(0))

    def generate_witness(self):
        pb = self.pb
        if pb.lc_val(vlc(self.do_copy)) != 0:
            for s, t in zip(self.source, self.target):
                pb.setval(t, pb.val(s))


class BitVectorCopyGadget:
    """basic_gadgets.tcc:150-194."""

    def __init__(self, pb: Protoboard, source_bits: List[int],
                 target_bits: List[int], do_copy, chunk_size: int):
        self.pb = pb
        self.source_bits, self.target_bits = source_bits, target_bits
        self.do_copy = do_copy
        num_chunks = -(-len(source_bits) // chunk_size)
        self.packed_source = pb.allocate_array(num_chunks)
        self.pack_source = MultipackingGadget(pb, source_bits,
                                              self.packed_source, chunk_size)
        self.packed_target = pb.allocate_array(num_chunks)
        self.pack_target = MultipackingGadget(pb, target_bits,
                                              self.packed_target, chunk_size)
        self.copier = FieldVectorCopyGadget(pb, self.packed_source,
                                            self.packed_target, do_copy)

    def generate_constraints(self, enforce_source_bitness: bool,
                             enforce_target_bitness: bool):
        self.pack_source.generate_constraints(enforce_source_bitness)
        self.pack_target.generate_constraints(enforce_target_bitness)
        self.copier.generate_constraints()

    def generate_witness(self):
        pb = self.pb
        if pb.lc_val(vlc(self.do_copy)) == 1:
            for s, t in zip(self.source_bits, self.target_bits):
                pb.setval(t, pb.val(s))
        self.pack_source.witness_from_bits()
        self.pack_target.witness_from_bits()


class MerkleTreeCheckReadGadget:
    """merkle_tree_check_read_gadget.tcc:12-105."""

    def __init__(self, pb: Protoboard, tree_depth: int, address_bits,
                 leaf: DigestVariable, root: DigestVariable,
                 path: MerkleAuthenticationPathVariable, read_successful):
        self.pb = pb
        self.tree_depth = tree_depth
        self.internal_output = [DigestVariable(pb, 256)
                                for _ in range(tree_depth - 1)]
        self.computed_root = DigestVariable(pb, 256)
        self.hashers = []
        for i in range(tree_depth):
            block = path.left_digests[i].bits + path.right_digests[i].bits
            out = self.computed_root if i == 0 else self.internal_output[i - 1]
            self.hashers.append(Sha256TwoToOneHashGadget(pb, block, out))
        self.propagators = []
        for i in range(tree_depth):
            inp = self.internal_output[i] if i < tree_depth - 1 else leaf
            self.propagators.append(DigestSelectorGadget(
                pb, inp, address_bits[tree_depth - 1 - i],
                path.left_digests[i], path.right_digests[i]))
        self.check_root = BitVectorCopyGadget(
            pb, self.computed_root.bits, root.bits, read_successful,
            FR_CAPACITY)

    def generate_constraints(self):
        for h in self.hashers:
            h.generate_constraints(False)
        for p in self.propagators:
            p.generate_constraints()
        self.check_root.generate_constraints(False, False)

    def generate_witness(self):
        for i in range(self.tree_depth - 1, -1, -1):
            self.propagators[i].generate_witness()
            self.hashers[i].generate_witness()
        self.check_root.generate_witness()

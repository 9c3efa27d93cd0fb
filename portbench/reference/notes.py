"""What a BlockMaze transaction states, worked out from its plain data with
the standard library: note commitments, PRFs, the Merkle root and the
packing of the public bits into field elements.

Follows the reference's definitions (src/mint/Note.h:30-44, deposit/Note.h
:47-79, deposit/util.h Compute_PRF, IncrementalMerkleTree.tcc:14-24,
libff pack_bit_vector_into_field_element_vector). uint256 values are 32
bytes in the reference's memory order; bits are memory-order bytes, most
significant bit first within each byte (mint/util.h:94-105).
"""

from __future__ import annotations

import hashlib
import struct

# bits a BN254 scalar holds when bits are packed (Fp_model::capacity())
FR_CAPACITY = 253


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def prf(sk: bytes, r: bytes) -> bytes:
    """Compute_PRF(sk, r) = SHA256(sk || r)."""
    return sha256(sk + r)


def note_cm(value: int, sn: bytes, r: bytes) -> bytes:
    """A note's commitment SHA256(LE64(value) || sn || r)."""
    return sha256(struct.pack("<Q", value) + sn + r)


def note_s_cm(value: int, pk: bytes, r: bytes, sn: bytes) -> bytes:
    """A transfer note's commitment SHA256(LE64(value) || pk || r || sn)."""
    return sha256(struct.pack("<Q", value) + pk + r + sn)


def bits(data: bytes) -> list:
    return [(byte >> (7 - j)) & 1 for byte in data for j in range(8)]


def pack(bit_list: list) -> list:
    """Bits into field elements of FR_CAPACITY bits, least significant
    first."""
    out = []
    for off in range(0, len(bit_list), FR_CAPACITY):
        out.append(sum(b << j for j, b in
                       enumerate(bit_list[off:off + FR_CAPACITY])))
    return out


_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_K = (
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
)
_M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def compress(block: bytes) -> bytes:
    """One SHA-256 compression of a 64-byte block from the standard IV,
    without padding: how the Merkle tree joins two nodes."""
    if len(block) != 64:
        raise ValueError(f"a block is 64 bytes, not {len(block)}")
    w = list(struct.unpack(">16I", block))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = _IV
    for i in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + ((e & f) ^ (~e & g)) + _K[i] + w[i]) & _M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & _M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & _M32, c, b, a, \
            (t1 + t2) & _M32
    return struct.pack(">8I", *((x + y) & _M32 for x, y in zip((a, b, c, d,
                                                               e, f, g, h),
                                                              _IV)))


def merkle_root(leaves: list, depth: int) -> bytes:
    """The root of a tree of 2^depth leaves, `leaves` first and the rest
    empty (32 zero bytes)."""
    level, empty = list(leaves), bytes(32)
    for _ in range(depth):
        if len(level) % 2:
            level.append(empty)
        level = [compress(level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
        empty = compress(empty + empty)
    return level[0] if level else empty

"""Host-side note hashing and bit-layout utilities.

uint256 values are represented as 32-byte `bytes` in the reference's memory
order (bitcoin-style little-endian storage: uint256S("1") -> b'\\x01' + 31
zeros). Hash outputs (CSHA256::Finalize into uint256 memory) are the raw SHA
digest bytes. Bit vectors use the circuit convention of
src/mint/util.h:94-105: memory-order bytes, MSB-first within each byte.
Mirrors src/mint/Note.h:30-44 and src/deposit/util.h Compute_PRF.
"""

from __future__ import annotations

import hashlib
import struct


def uint256_from_hex(s: str) -> bytes:
    """uint256S semantics: hex string (big-endian number) -> LE memory bytes."""
    s = s.removeprefix("0x")
    v = int(s, 16)
    return v.to_bytes(32, "little")


def uint256_to_hex(b: bytes) -> str:
    """GetHex: memory bytes -> big-endian hex string."""
    return int.from_bytes(b, "little").to_bytes(32, "big").hex()


def bytes_to_bits(data: bytes) -> list:
    """Memory-order bytes, MSB-first per byte (convertBytesToVector)."""
    out = []
    for byte in data:
        for j in range(8):
            out.append((byte >> (7 - j)) & 1)
    return out


def bits_to_bytes(bits: list) -> bytes:
    out = bytearray(len(bits) // 8)
    for i in range(len(out)):
        c = 0
        for j in range(8):
            c = (c << 1) | bits[i * 8 + j]
        out[i] = c
    return bytes(out)


def uint64_to_bits(v: int) -> list:
    """convertIntToVectorLE then MSB-first per byte (util.h:16-24)."""
    return bytes_to_bits(struct.pack("<Q", v))


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def compute_prf(sk: bytes, r: bytes) -> bytes:
    """Compute_PRF(sk, r) = SHA256(sk || r) (src/deposit/util.h:231-241)."""
    return sha256(sk + r)


def compute_crh(pk: bytes, r: bytes) -> bytes:
    """CRH for send: SHA256 over pk(160b)||r(256b) — Compute_CRH writes
    exactly 20 + 32 bytes (send/util.h:247-258); the circuit's pk_sender is
    a 160-bit DigestVariable, so a wrong-width pk must fail here, not in
    fill_with_bits deep inside witness generation."""
    assert len(pk) == 20, f"CRH pk must be a 20-byte address, got {len(pk)}"
    assert len(r) == 32, f"CRH r must be 32 bytes, got {len(r)}"
    return sha256(pk + r)


class Note:
    """Note{value, sn, r}; cm = SHA256(LE64(value)||sn||r) (mint/Note.h:30)."""

    def __init__(self, value: int, sn: bytes, r: bytes):
        self.value = value
        self.sn = sn
        self.r = r

    def cm(self) -> bytes:
        return sha256(struct.pack("<Q", self.value) + self.sn + self.r)


class NoteS:
    """NoteS{value, pk(uint160), r, sn_old}; cm = SHA256(LE64(value)||pk||r||sn)
    (deposit/Note.h:47-79)."""

    def __init__(self, value: int, pk: bytes, r: bytes, sn: bytes):
        assert len(pk) == 20
        self.value = value
        self.pk = pk
        self.r = r
        self.sn = sn

    def cm(self) -> bytes:
        return sha256(struct.pack("<Q", self.value) + self.pk + self.r + self.sn)

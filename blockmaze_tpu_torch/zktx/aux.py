"""One-time (stealth) addresses and encrypted AUX memos.

Ports the semantics of go-ethereum/zktx/zktx.go:306-381,525-550:

  NewRandomPubKey(sA, pkB)        = H(sA·pkB)·G + pkB     (sender side)
  GenerateKeyForRandomB(R, kB)    : priv = H(kB·R) + kB.D (receiver side)
  Encrypt(pub, m)                 = AES-128-CTR with key = pub.X[:16],
                                    output iv(16) || ct (geth ecies.SymEncrypt)
  AUX                             = RLP([value, Rs, SNa]) encrypted to the
                                    DH-derived one-time pubkey

secp256k1 and AES-128 are implemented locally (pure Python, byte-compatible);
message sizes are tiny (96-byte memos), so throughput is irrelevant.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# secp256k1
# ---------------------------------------------------------------------------

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
     0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)

Point = Optional[Tuple[int, int]]  # None = infinity


def _add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def scalar_mult(k: int, p: Point) -> Point:
    r: Point = None
    while k:
        if k & 1:
            r = _add(r, p)
        p = _add(p, p)
        k >>= 1
    return r


def keygen() -> Tuple[int, Tuple[int, int]]:
    d = secrets.randbelow(N - 1) + 1
    return d, scalar_mult(d, G)


def _hash_point_go(pt: Tuple[int, int]) -> bytes:
    """SHA256(big.Int.Bytes(x) || big.Int.Bytes(y)) with bs[0] %= 128 —
    matches the Go code, including big.Int's minimal big-endian encoding."""
    def be(v: int) -> bytes:
        return v.to_bytes((v.bit_length() + 7) // 8, "big") if v else b""

    bs = bytearray(hashlib.sha256(be(pt[0]) + be(pt[1])).digest())
    bs[0] %= 128
    return bytes(bs)


def new_random_pub_key(sA: int, pkB: Tuple[int, int]) -> Tuple[int, int]:
    """H(sA·pkB)·G + pkB (zktx.go:531-550)."""
    shared = scalar_mult(sA, pkB)
    bs = _hash_point_go(shared)
    return _add(scalar_mult(int.from_bytes(bs, "big"), G), pkB)


def generate_key_for_random_b(R: Tuple[int, int], kB_priv: int,
                              kB_pub: Tuple[int, int]) -> Tuple[int, Tuple[int, int]]:
    """Receiver derives the one-time private key: H(kB·R) + kB.D
    (zktx.go:358-381). Returns (priv, pub)."""
    shared = scalar_mult(kB_priv, R)
    bs = _hash_point_go(shared)
    priv = int.from_bytes(bs, "big") + kB_priv  # Go keeps the raw sum
    pub = _add(scalar_mult(int.from_bytes(bs, "big"), G), kB_pub)
    return priv, pub


# ---------------------------------------------------------------------------
# AES-128-CTR (pure Python; byte-compatible with geth ecies.SymEncrypt)
# ---------------------------------------------------------------------------

_SBOX = None


def _mk_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # multiplicative inverse table via exp/log over GF(2^8)
    def xtime(a):
        return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1

    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= xtime(x)
    sbox = [0] * 256
    for i in range(256):
        inv = 0 if i == 0 else exp[255 - log[i]]
        b = inv
        res = 0x63
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            res ^= b
        sbox[i] = res ^ inv
    _SBOX = sbox
    return sbox


def _aes128_expand(key: bytes):
    sbox = _mk_sbox()
    words = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(words[i - 1])
        if i % 4 == 0:
            t = [sbox[t[1]] ^ rcon, sbox[t[2]], sbox[t[3]], sbox[t[0]]]
            rcon = ((rcon << 1) ^ 0x1B) & 0xFF if rcon & 0x80 else rcon << 1
        words.append([a ^ b for a, b in zip(words[i - 4], t)])
    return [b for w in words for b in w]


def _aes128_encrypt_block(block: bytes, w) -> bytes:
    sbox = _mk_sbox()
    # state in input order = column-major (st[r + 4c])
    st = list(block)

    def add_round_key(st, rk):
        return [a ^ b for a, b in zip(st, rk)]

    def sub_bytes(st):
        return [sbox[b] for b in st]

    def shift_rows(st):
        out = list(st)
        for r in range(1, 4):
            row = [st[r + 4 * c] for c in range(4)]
            row = row[r:] + row[:r]
            for c in range(4):
                out[r + 4 * c] = row[c]
        return out

    def gmul(a, b):
        res = 0
        for _ in range(8):
            if b & 1:
                res ^= a
            hi = a & 0x80
            a = (a << 1) & 0xFF
            if hi:
                a ^= 0x1B
            b >>= 1
        return res

    def mix_columns(st):
        out = [0] * 16
        for c in range(4):
            col = st[4 * c:4 * c + 4]
            out[4 * c + 0] = gmul(col[0], 2) ^ gmul(col[1], 3) ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ gmul(col[1], 2) ^ gmul(col[2], 3) ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ gmul(col[2], 2) ^ gmul(col[3], 3)
            out[4 * c + 3] = gmul(col[0], 3) ^ col[1] ^ col[2] ^ gmul(col[3], 2)
        return out

    st = add_round_key(st, w[0:16])
    for rnd in range(1, 10):
        st = sub_bytes(st)
        st = shift_rows(st)
        st = mix_columns(st)
        st = add_round_key(st, w[16 * rnd:16 * rnd + 16])
    st = sub_bytes(st)
    st = shift_rows(st)
    st = add_round_key(st, w[160:176])
    return bytes(st)


def aes128_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    w = _aes128_expand(key)
    out = bytearray()
    counter = int.from_bytes(iv, "big")
    for off in range(0, len(data), 16):
        ks = _aes128_encrypt_block(counter.to_bytes(16, "big"), w)
        chunk = data[off:off + 16]
        out.extend(a ^ b for a, b in zip(chunk, ks))
        counter = (counter + 1) % (1 << 128)
    return bytes(out)


def sym_encrypt(pub: Tuple[int, int], m: bytes,
                iv: Optional[bytes] = None) -> bytes:
    """Encrypt(pub, m): key = pub.X big-endian bytes[:16]; iv||AES-CTR(m)."""
    ke = pub[0].to_bytes(32, "big")[:16]
    iv = iv if iv is not None else secrets.token_bytes(16)
    return iv + aes128_ctr(ke, iv, m)


def sym_decrypt(pub: Tuple[int, int], ct: bytes) -> bytes:
    ke = pub[0].to_bytes(32, "big")[:16]
    return aes128_ctr(ke, ct[:16], ct[16:])


# ---------------------------------------------------------------------------
# RLP (subset sufficient for AUX{uint64, Hash, Hash})
# ---------------------------------------------------------------------------

def _rlp_encode_bytes(b: bytes) -> bytes:
    if len(b) == 1 and b[0] < 0x80:
        return b
    if len(b) <= 55:
        return bytes([0x80 + len(b)]) + b
    ln = len(b).to_bytes((len(b).bit_length() + 7) // 8, "big")
    return bytes([0xB7 + len(ln)]) + ln + b


def _rlp_int(v: int) -> bytes:
    if v == 0:
        return _rlp_encode_bytes(b"")
    return _rlp_encode_bytes(v.to_bytes((v.bit_length() + 7) // 8, "big"))


def rlp_encode_aux(value: int, rs: bytes, sna: bytes) -> bytes:
    body = _rlp_int(value) + _rlp_encode_bytes(rs) + _rlp_encode_bytes(sna)
    assert len(body) <= 55 or True
    if len(body) <= 55:
        return bytes([0xC0 + len(body)]) + body
    ln = len(body).to_bytes((len(body).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + body


def rlp_decode_aux(data: bytes):
    def read_item(buf, pos):
        b0 = buf[pos]
        if b0 < 0x80:
            return buf[pos:pos + 1], pos + 1
        if b0 <= 0xB7:
            n = b0 - 0x80
            return buf[pos + 1:pos + 1 + n], pos + 1 + n
        if b0 <= 0xBF:
            ln = b0 - 0xB7
            n = int.from_bytes(buf[pos + 1:pos + 1 + ln], "big")
            return buf[pos + 1 + ln:pos + 1 + ln + n], pos + 1 + ln + n
        raise ValueError("nested list")

    b0 = data[0]
    if b0 <= 0xF7:
        body = data[1:1 + (b0 - 0xC0)]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(data[1:1 + ln], "big")
        body = data[1 + ln:1 + ln + n]
    pos = 0
    value_b, pos = read_item(body, pos)
    rs, pos = read_item(body, pos)
    sna, pos = read_item(body, pos)
    return int.from_bytes(value_b, "big"), rs, sna


# ---------------------------------------------------------------------------
# AUX memo (zktx.go:328-356)
# ---------------------------------------------------------------------------

def compute_aux(random_receiver_pk: Tuple[int, int], value: int,
                rs: bytes, sna: bytes, iv: Optional[bytes] = None) -> bytes:
    return sym_encrypt(random_receiver_pk,
                       rlp_encode_aux(value, rs, sna), iv)


def dec_aux(key_pub: Tuple[int, int], data: bytes):
    return rlp_decode_aux(sym_decrypt(key_pub, data))


# ---------------------------------------------------------------------------
# ECDSA over secp256k1 (deposit txs are signed with the one-time key:
# types.SignTx(tx, HomesteadSigner, randomKeyB), api.go:1929; the pool and
# state processor recover the signer and require it to equal the address of
# the tx's (X, Y) pubkey — ExtractPKBAddress, transaction_signing.go:96-113)
# ---------------------------------------------------------------------------

def ecdsa_sign(priv: int, msg_hash: bytes, k: Optional[int] = None):
    """Sign a 32-byte hash; returns (r, s, recovery_id). Deterministic k via
    HMAC-ish hash when not supplied (tests); random otherwise."""
    z = int.from_bytes(msg_hash, "big") % N
    while True:
        if k is None:
            kk = int.from_bytes(
                hashlib.sha256(priv.to_bytes(32, "big") + msg_hash +
                               secrets.token_bytes(16)).digest(), "big") % N
        else:
            kk = k % N
        if kk == 0:
            k = None
            continue
        X = scalar_mult(kk, G)
        r = X[0] % N
        if r == 0:
            k = None
            continue
        s = (z + r * priv) * pow(kk, -1, N) % N
        if s == 0:
            k = None
            continue
        rec = (X[1] & 1) ^ (1 if X[0] >= N else 0)
        return r, s, rec


def ecdsa_recover(msg_hash: bytes, r: int, s: int, rec: int) -> Tuple[int, int]:
    """Recover the signer's public key (the ExtractPKBAddress primitive)."""
    z = int.from_bytes(msg_hash, "big") % N
    x = r + (rec >> 1) * N
    # lift x
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if (y & 1) != (rec & 1):
        y = P - y
    Rpt = (x, y)
    rinv = pow(r, -1, N)
    # Q = r^-1 (s·R − z·G)
    q = _add(scalar_mult(s * rinv % N, Rpt),
             scalar_mult((-z * rinv) % N, G))
    assert q is not None, "invalid signature"
    return q


def ecdsa_verify(pub: Tuple[int, int], msg_hash: bytes, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    z = int.from_bytes(msg_hash, "big") % N
    sinv = pow(s, -1, N)
    pt = _add(scalar_mult(z * sinv % N, G), scalar_mult(r * sinv % N, pub))
    return pt is not None and pt[0] % N == r

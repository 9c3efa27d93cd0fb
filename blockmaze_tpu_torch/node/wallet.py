"""Wallet sequence state + SNfile persistence.

Reproduces the reference's wallet bookkeeping (go-ethereum/zktx/zktx.go:34-92
Sequence/SequenceS/InitializeSN; internal/ethapi/api.go:1503-1519 SNfile
rewrite; cmd/geth/config.go:163-192 load at boot):

  - `SequenceNumber` is the last *confirmed-submitted* sequence, and
    `SequenceNumberAfter` the sequence produced by the most recent zk tx;
  - before each zk tx the node checks chain state: if SequenceNumberAfter's
    SN already exists on-chain (and is not the genesis SN) the wallet is
    corrupt ("sn is lost"); if SequenceNumber's SN is *absent* the previous
    tx never landed, so SequenceNumberAfter rolls back to SequenceNumber
    (api.go:1414-1431);
  - after every successful submission the full SequenceS is RLP-encoded and
    rewritten as one hex line to datadir/SN.

The serialized format is RLP (same container encoding as geth's) over
[seq1, seq2, sns?, pkbx, pkby, stage]; each Sequence is
[sn(32), cmt(32), random(32), value, valid].
"""

from __future__ import annotations

import dataclasses
import os
from enum import IntEnum
from typing import Callable, Optional

from ..chain.state import initial_sn, zero_cmt


class Stage(IntEnum):
    """zktx.go:56-63 (const iota)."""
    ORIGIN = 0
    MINT = 1
    SEND = 2
    UPDATE = 3
    DEPOSIT = 4
    REDEEM = 5


@dataclasses.dataclass
class Sequence:
    sn: bytes
    cmt: bytes
    random: bytes
    value: int
    valid: bool = True


@dataclasses.dataclass
class SequenceS:
    seq1: Sequence
    seq2: Sequence
    sns: Optional[Sequence]
    pkbx: int
    pkby: int
    stage: int


def initialize_sequence() -> Sequence:
    """InitializeSN (zktx.go:79-92): the genesis zero-value sequence."""
    return Sequence(sn=initial_sn(), cmt=zero_cmt(), random=b"\x00" * 32,
                    value=0)


# ---------------------------------------------------------------------------
# RLP (the standard encoding; geth uses the same container format)
# ---------------------------------------------------------------------------

def _rlp_bytes(b: bytes) -> bytes:
    if len(b) == 1 and b[0] < 0x80:
        return b
    if len(b) <= 55:
        return bytes([0x80 + len(b)]) + b
    ln = len(b).to_bytes((len(b).bit_length() + 7) // 8, "big")
    return bytes([0xB7 + len(ln)]) + ln + b


def _rlp_int(v: int) -> bytes:
    if v == 0:
        return b"\x80"
    return _rlp_bytes(v.to_bytes((v.bit_length() + 7) // 8, "big"))


def _rlp_list(items) -> bytes:
    body = b"".join(items)
    if len(body) <= 55:
        return bytes([0xC0 + len(body)]) + body
    ln = len(body).to_bytes((len(body).bit_length() + 7) // 8, "big")
    return bytes([0xF7 + len(ln)]) + ln + body


def _rlp_decode(data: bytes, pos: int = 0):
    b0 = data[pos]
    if b0 < 0x80:
        return data[pos:pos + 1], pos + 1
    if b0 <= 0xB7:
        n = b0 - 0x80
        return data[pos + 1:pos + 1 + n], pos + 1 + n
    if b0 <= 0xBF:
        ll = b0 - 0xB7
        n = int.from_bytes(data[pos + 1:pos + 1 + ll], "big")
        s = pos + 1 + ll
        return data[s:s + n], s + n
    # list
    if b0 <= 0xF7:
        n = b0 - 0xC0
        s = pos + 1
    else:
        ll = b0 - 0xF7
        n = int.from_bytes(data[pos + 1:pos + 1 + ll], "big")
        s = pos + 1 + ll
    end = s + n
    items = []
    while s < end:
        item, s = _rlp_decode(data, s)
        items.append(item)
    return items, end


def _enc_seq(s: Sequence) -> bytes:
    return _rlp_list([_rlp_bytes(s.sn), _rlp_bytes(s.cmt),
                      _rlp_bytes(s.random), _rlp_int(s.value),
                      _rlp_int(1 if s.valid else 0)])


def _dec_seq(items) -> Sequence:
    sn, cmt, random, value, valid = items
    return Sequence(sn=bytes(sn), cmt=bytes(cmt), random=bytes(random),
                    value=int.from_bytes(value, "big"),
                    valid=bool(int.from_bytes(valid, "big")))


def encode_sequence_s(s: SequenceS) -> bytes:
    return _rlp_list([
        _enc_seq(s.seq1), _enc_seq(s.seq2),
        _enc_seq(s.sns) if s.sns is not None else _rlp_list([]),
        _rlp_int(s.pkbx), _rlp_int(s.pkby), _rlp_int(int(s.stage)),
    ])


def decode_sequence_s(data: bytes) -> SequenceS:
    items, _ = _rlp_decode(data)
    seq1, seq2, sns, pkbx, pkby, stage = items
    return SequenceS(
        seq1=_dec_seq(seq1), seq2=_dec_seq(seq2),
        sns=_dec_seq(sns) if sns else None,
        pkbx=int.from_bytes(pkbx, "big"), pkby=int.from_bytes(pkby, "big"),
        stage=int.from_bytes(stage, "big"))


# ---------------------------------------------------------------------------
# Wallet
# ---------------------------------------------------------------------------

class WalletError(Exception):
    pass


class Wallet:
    """Per-node zk wallet: the Sequence pair, send-side SNS, and the SNfile.

    `datadir/SN` holds one hex line (the RLP SequenceS), rewritten after each
    zk transaction and loaded at construction if present.
    """

    def __init__(self, datadir: str):
        self.datadir = datadir
        os.makedirs(datadir, exist_ok=True)
        self.path = os.path.join(datadir, "SN")
        self.genesis_sn = initial_sn()
        self.sequence_number = initialize_sequence()
        self.sequence_number_after = initialize_sequence()
        self.sns: Optional[Sequence] = None
        self.stage = Stage.ORIGIN
        if os.path.exists(self.path):
            self._load()

    def _load(self):
        with open(self.path) as f:
            line = f.readline().strip()
        if not line:
            return
        s = decode_sequence_s(bytes.fromhex(line))
        self.sequence_number = s.seq1
        self.sequence_number_after = s.seq2
        self.sns = s.sns
        self.stage = Stage(s.stage)

    def persist(self):
        """api.go:1506-1519: rewrite the first (only) line."""
        s = SequenceS(self.sequence_number, self.sequence_number_after,
                      self.sns, 0, 0, int(self.stage))
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(encode_sequence_s(s).hex() + "\n")
        os.replace(tmp, self.path)

    def recover(self, sn_exists: Callable[[bytes], bool]):
        """Pre-transaction recovery checks (api.go:1414-1431).

        sn_exists: chain-state query `state.Exist(addr(SN))`.
        Raises WalletError("sn is lost") when the *pending* SN already
        appears on-chain; rolls the pending sequence back when the previous
        transaction never landed.
        """
        if (sn_exists(self.sequence_number_after.sn)
                and self.sequence_number_after.sn != self.genesis_sn):
            raise WalletError("sn is lost")
        if (not sn_exists(self.sequence_number.sn)
                and self.sequence_number.sn != self.genesis_sn):
            self.sequence_number_after = self.sequence_number

    def advance(self, new_seq: Sequence, stage: Stage):
        """Post-submission bookkeeping + persist (api.go:1503-1519)."""
        self.sequence_number = self.sequence_number_after
        self.sequence_number_after = new_seq
        self.stage = stage
        self.persist()

"""Blockchain state machine semantics for the four zk transaction types.

Ports the consensus-critical logic of the reference geth fork
(core/state_processor.go:95-203, core/state_transition.go:221-241,
core/types/transaction.go:40-46, merkle/merkle.go, zktx/zktx.go:79-92) as a
standalone state machine: nullifier accounting ("SN must not exist as an
account"), hidden-balance commitment updates, per-code proof verification,
block-level commitment Merkle roots, and deposit one-time-key single-use.

Hashes here use the framework's uint256 memory-byte convention (see
crypto/notes.py); GetHex of these bytes matches the reference's hex strings.
"""

from __future__ import annotations

import dataclasses
import hashlib
from enum import IntEnum
from typing import Dict, List, Optional

from ..crypto import notes as NT
from ..zktx import api


class TxCode(IntEnum):
    """core/types/transaction.go:40-46."""
    PUBLIC = 0x00
    MINT = 0x01
    SEND = 0x02
    DEPOSIT = 0x03
    UPDATE = 0x04  # disabled in the reference
    REDEEM = 0x05


ZKTX_ADDRESS = bytes.fromhex("ff" * 20)


def address_hash(addr: bytes) -> bytes:
    """common.Address.Hash(): 20-byte address left-padded to 32 bytes."""
    return b"\x00" * (32 - len(addr)) + addr


def initial_sn() -> bytes:
    """InitializeSN (zktx.go:79-92): PRF(hash(ZKTxAddress), 0)."""
    return NT.compute_prf(address_hash(ZKTX_ADDRESS), b"\x00" * 32)


def zero_cmt() -> bytes:
    """Lazy CMT init (state_object.go:112-118): GenCMT(0, PRF(SK,0), 0)."""
    sn = initial_sn()
    return api.gen_cmt(0, sn, b"\x00" * 32)


@dataclasses.dataclass
class Account:
    balance: int = 0
    nonce: int = 0
    cmt: bytes = b""

    def __post_init__(self):
        if not self.cmt:
            self.cmt = zero_cmt()


@dataclasses.dataclass
class ZkTransaction:
    code: TxCode
    sender: bytes                      # 20-byte address
    zk_value: int = 0
    zk_sn: Optional[bytes] = None
    zk_sns: Optional[bytes] = None
    zk_cmt: Optional[bytes] = None
    zk_cmts: Optional[bytes] = None
    zk_proof: Optional[object] = None  # serialization.libsnark_io.Proof
    rt_cmt: Optional[bytes] = None
    one_time_addr: Optional[bytes] = None  # deposit signer address
    # transaction.go:64-100 extras carried by the node layer:
    aux: Optional[bytes] = None            # encrypted memo (SendTx)
    x: Optional[int] = None                # ephemeral/one-time pubkey X
    y: Optional[int] = None                # ephemeral/one-time pubkey Y
    cmt_blocks: Optional[List[int]] = None  # CMTBlock list (DepositTx)
    sig: Optional[tuple] = None            # (r, s, recid) one-time-key sig


class StateDB:
    """Account + nullifier state (nullifiers are accounts keyed by SN bytes,
    matching CreateAccount(addr(SN)); SetNonce 1)."""

    def __init__(self):
        self.accounts: Dict[bytes, Account] = {}

    def exists(self, key: bytes) -> bool:
        return key in self.accounts

    def get(self, addr: bytes) -> Account:
        if addr not in self.accounts:
            self.accounts[addr] = Account()
        return self.accounts[addr]

    def get_cmt_balance(self, addr: bytes) -> bytes:
        return self.get(addr).cmt

    def create_nullifier(self, sn: bytes):
        key = sn[:20] if len(sn) > 20 else sn
        self.accounts[key] = Account(nonce=1)


def tx_hash(tx: "ZkTransaction") -> bytes:
    """Framework tx hash: keccak256 over the canonical field serialization
    (the reference's tx.Hash() analog; used as the signing payload for the
    one-time-key deposit signature)."""
    from ..crypto.keccak import keccak256
    parts = [bytes([int(tx.code)]), tx.sender, tx.zk_value.to_bytes(8, "big")]
    for b in (tx.zk_sn, tx.zk_sns, tx.zk_cmt, tx.zk_cmts, tx.rt_cmt):
        parts.append(b or b"")
    parts.append(tx.aux or b"")
    return keccak256(b"".join(parts))


class ChainError(Exception):
    pass


class ChainState:
    """Applies zk transactions with the reference's consensus rules."""

    def __init__(self, zktx_service: api.ZkTx):
        self.db = StateDB()
        self.zktx = zktx_service
        self.init_sn = initial_sn()
        # RTCMT -> block number index (core/blockchain.go:902)
        self.rt_index: Dict[bytes, int] = {}
        self.blocks: List[dict] = []

    def _nullifier_key(self, sn: bytes) -> bytes:
        return sn[:20]

    def _check_sn(self, sn: bytes):
        """state_processor.go:109/121/137/154: the nullifier check runs
        BEFORE proof verification for every zk code."""
        if self.db.exists(self._nullifier_key(sn)) and sn != self.init_sn:
            raise ChainError("sn is already used")

    def _consume_sn(self, sn: bytes):
        self.db.create_nullifier(sn)

    def apply_transaction(self, tx: ZkTransaction):
        """state_processor.go:95-203."""
        acct = self.db.get(tx.sender)
        cmt_balance = acct.cmt

        if tx.code == TxCode.MINT:
            self._check_sn(tx.zk_sn)
            if acct.balance < tx.zk_value:
                raise ChainError("insufficient plaintext balance for mint")
            ok = self.zktx.verify_mint_proof(
                tx.zk_proof, cmt_balance, tx.zk_sn, tx.zk_cmt, tx.zk_value)
            if not ok:
                raise ChainError("invalid zk mint proof")
            self._consume_sn(tx.zk_sn)
            acct.balance -= tx.zk_value
        elif tx.code == TxCode.SEND:
            self._check_sn(tx.zk_sn)
            ok = self.zktx.verify_send_proof(
                tx.zk_proof, cmt_balance, tx.zk_sn, tx.zk_cmts, tx.zk_cmt)
            if not ok:
                raise ChainError("invalid zk send proof")
            self._consume_sn(tx.zk_sn)
        elif tx.code == TxCode.DEPOSIT:
            self._check_sn(tx.zk_sn)
            # NB: CMTRoot recomputation from the named blocks happens at pool
            # admission (tx_pool.go:650-665, node.Network.validate_tx); the
            # state processor re-verifies the proof against the root carried
            # by the tx (state_processor.go:147) without re-deriving it.
            ok = self.zktx.verify_deposit_proof(
                tx.zk_proof, tx.rt_cmt, tx.one_time_addr, cmt_balance,
                tx.zk_sn, tx.zk_cmt, tx.zk_sns)
            if not ok:
                raise ChainError("invalid zk deposit proof")
            # deposit txs must be signed by the one-time key; the recovered
            # signer must equal addr(X, Y) (state_processor.go:141-146,
            # transaction_signing.go:96-113)
            if tx.sig is not None:
                from ..crypto.keccak import pubkey_to_address
                from ..zktx import aux as _za
                r, s, rec = tx.sig
                pub = _za.ecdsa_recover(tx_hash(tx), r, s, rec)
                if pubkey_to_address(*pub) != tx.one_time_addr:
                    raise ChainError("deposit signature mismatch")
            self._consume_sn(tx.zk_sn)
            # one-time pubkey single use (state_processor.go:172-179)
            if self.db.exists(tx.one_time_addr):
                raise ChainError("cannot use randompubkey for a second time")
            self.db.accounts[tx.one_time_addr] = Account(nonce=1)
        elif tx.code == TxCode.REDEEM:
            self._check_sn(tx.zk_sn)
            ok = self.zktx.verify_redeem_proof(
                tx.zk_proof, cmt_balance, tx.zk_sn, tx.zk_cmt, tx.zk_value)
            if not ok:
                raise ChainError("invalid zk redeem proof")
            self._consume_sn(tx.zk_sn)
            acct.balance += tx.zk_value
        else:
            raise ChainError(f"unsupported tx code {tx.code}")

        # state_transition.go:221-223: hidden balance commitment update
        acct.cmt = tx.zk_cmt

    def finalize_block(self, txs: List[ZkTransaction]) -> dict:
        """miner/worker.go:461-467 + consensus Finalize: collect SendTx CMTS
        into header.CMT; RTCMT = block-level merkle root."""
        cmts = [tx.zk_cmts for tx in txs if tx.code == TxCode.SEND]
        rtcmt = cmt_root(cmts)
        block = {"number": len(self.blocks), "cmt": cmts, "rtcmt": rtcmt}
        self.blocks.append(block)
        self.rt_index[rtcmt] = block["number"]
        return block


# ---------------------------------------------------------------------------
# Block-level commitment Merkle root (merkle/merkle.go:40-84) — a simple
# SHA-256 binary tree, distinct from the in-circuit incremental tree.
# ---------------------------------------------------------------------------

EMPTY_ROOT = b"\x00" * 32


def cmt_root(cmts: List[bytes]) -> bytes:
    if not cmts:
        return EMPTY_ROOT
    data = list(cmts)
    if len(data) % 2 != 0:
        data.append(data[-1])
    nodes = [hashlib.sha256(d).digest() for d in data]
    for _ in range(len(data) // 2):
        if len(nodes) % 2 != 0:
            nodes.append(nodes[-1])
        nodes = [hashlib.sha256(nodes[j] + nodes[j + 1]).digest()
                 for j in range(0, len(nodes), 2)]
        if len(nodes) == 1:
            break
    return nodes[0]

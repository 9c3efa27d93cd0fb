"""Node + simulated network: the reference's RPC transaction-builder surface.

Maps go-ethereum/internal/ethapi/api.go onto the framework:

  Node.send_mint_transaction     <- SendMintTransaction   (api.go:1396-1525)
  Node.send_send_transaction     <- SendSendTransaction   (api.go:1560-1735)
  Node.send_deposit_transaction  <- SendDepositTransaction(api.go:1745-1959)
  Node.send_redeem_transaction   <- SendRedeemTransaction (api.go:1963+)
  Node.get_balance2              <- GetBalance2           (api.go:518-524)
  Node.get_pub_key_rlp           <- GetPubKeyRLP          (api.go:1542-1556)

A `Network` is the shared consensus substrate (tx pool + chain state + block
production) standing in for the devp2p mesh: every Node submits transactions
to it and reads chain state from it, exactly as each geth process does against
the p2p network. Mining collects SendTx commitments into the block header CMT
list and finalizes RTCMT (miner/worker.go:461-467, consensus Finalize).

SK convention: the reference's large-scale-test simplification is
SK = ZKTxAddress.Hash() (api.go "we suppose that SK = CRH(addr)"); here the
stated intent is applied per-node: SK = Hash(node address) so wallets are
distinct. Chain rules are SK-agnostic, so consensus behavior is unchanged.
"""

from __future__ import annotations

import random as _random
import secrets
from typing import Dict, List, Optional, Tuple

from ..chain import state as CS
from ..crypto.keccak import pubkey_to_address
from ..zktx import api as zapi
from ..zktx import aux as ZA
from . import wallet as W

ZKCMTNODES = 1  # zktx.go:74 — minimum cmt count for the deposit Merkle root


def _rand_hash() -> bytes:
    return secrets.token_bytes(32)


tx_hash = CS.tx_hash


class Network:
    """Shared consensus substrate: tx pool + chain state + block producer."""

    def __init__(self, zktx_service: zapi.ZkTx, seed: Optional[int] = None):
        self.chain = CS.ChainState(zktx_service)
        self.zktx = zktx_service
        self.pending: List[CS.ZkTransaction] = []
        self.tx_index: Dict[bytes, Tuple[CS.ZkTransaction, int]] = {}
        self.rng = _random.Random(seed)

    # -- funding / state queries (the StateAndHeaderByNumber surface) ------
    def fund(self, addr: bytes, amount: int):
        self.chain.db.get(addr).balance += amount

    def sn_exists(self, sn: bytes) -> bool:
        return self.chain.db.exists(sn[:20])

    def balance_of(self, addr: bytes) -> int:
        return self.chain.db.get(addr).balance

    def cmt_balance_of(self, addr: bytes) -> bytes:
        return self.chain.db.get_cmt_balance(addr)

    # -- tx pool (core/tx_pool.go:613-665) ---------------------------------
    def validate_tx(self, tx: CS.ZkTransaction):
        acct = self.chain.db.get(tx.sender)
        cmtb = acct.cmt
        if tx.code == CS.TxCode.MINT:
            if acct.balance < tx.zk_value:
                raise CS.ChainError("pool: insufficient balance for mint")
            ok = self.zktx.verify_mint_proof(tx.zk_proof, cmtb, tx.zk_sn,
                                             tx.zk_cmt, tx.zk_value)
        elif tx.code == CS.TxCode.SEND:
            ok = self.zktx.verify_send_proof(tx.zk_proof, cmtb, tx.zk_sn,
                                             tx.zk_cmts, tx.zk_cmt)
        elif tx.code == CS.TxCode.REDEEM:
            ok = self.zktx.verify_redeem_proof(tx.zk_proof, cmtb, tx.zk_sn,
                                               tx.zk_cmt, tx.zk_value)
        elif tx.code == CS.TxCode.DEPOSIT:
            # recompute RTcmt from the named blocks (tx_pool.go:650-665)
            cmts: List[bytes] = []
            for bn in tx.cmt_blocks:
                if bn >= len(self.chain.blocks):
                    raise CS.ChainError("pool: unknown CMT block")
                cmts.extend(self.chain.blocks[bn]["cmt"])
            depth = getattr(self.zktx, "merkle_depth", None)
            rt = (zapi.gen_rt(cmts, depth) if depth else zapi.gen_rt(cmts))
            if not cmts or rt != tx.rt_cmt:
                raise CS.ChainError("pool: invalid CMTRoot")
            # deposit signature must recover to addr(X, Y)
            # (transaction_signing.go:96-113 + pool check)
            r, s, rec = tx.sig
            pub = ZA.ecdsa_recover(tx_hash(tx), r, s, rec)
            if pubkey_to_address(*pub) != tx.one_time_addr:
                raise CS.ChainError("pool: deposit signature mismatch")
            ok = self.zktx.verify_deposit_proof(
                tx.zk_proof, tx.rt_cmt, tx.one_time_addr, cmtb, tx.zk_sn,
                tx.zk_cmt, tx.zk_sns)
        else:
            raise CS.ChainError("pool: unsupported code")
        if not ok:
            raise CS.ChainError("pool: invalid proof")

    def submit(self, tx: CS.ZkTransaction) -> bytes:
        self.validate_tx(tx)
        self.pending.append(tx)
        return tx_hash(tx)

    # -- block production ---------------------------------------------------
    def mine_block(self) -> dict:
        """Apply pending txs (state_processor semantics) and finalize the
        block header (CMT list + RTCMT)."""
        txs, self.pending = self.pending, []
        for tx in txs:
            self.chain.apply_transaction(tx)
        block = self.chain.finalize_block(txs)
        for tx in txs:
            self.tx_index[tx_hash(tx)] = (tx, block["number"])
        return block

    def get_transaction(self, h: bytes):
        return self.tx_index.get(h)


class NodeError(Exception):
    pass


class Node:
    """One wallet-bearing participant (a geth process in the reference)."""

    def __init__(self, network: Network, datadir: str,
                 address: Optional[bytes] = None,
                 key_priv: Optional[int] = None):
        self.net = network
        self.address = address or secrets.token_bytes(20)
        self.sk = CS.address_hash(self.address)  # per-node zk secret key
        if key_priv is None:
            self.key_priv, self.key_pub = ZA.keygen()
        else:
            self.key_priv = key_priv
            self.key_pub = ZA.scalar_mult(key_priv, ZA.G)
        self.wallet = W.Wallet(datadir)

    # -- queries ------------------------------------------------------------
    def get_balance2(self) -> dict:
        """GetBalance2 (api.go:518-524): plaintext + on-chain commitment."""
        return {"balance": self.net.balance_of(self.address),
                "cmt_balance": self.net.cmt_balance_of(self.address).hex(),
                "wallet_value": self.wallet.sequence_number_after.value}

    def get_pub_key_rlp(self) -> bytes:
        """GetPubKeyRLP (api.go:1542-1556): RLP([X, Y]) of the node key."""
        return W._rlp_list([W._rlp_int(self.key_pub[0]),
                            W._rlp_int(self.key_pub[1])])

    @staticmethod
    def decode_pub_key_rlp(data: bytes) -> Tuple[int, int]:
        items, _ = W._rlp_decode(data)
        return (int.from_bytes(items[0], "big"),
                int.from_bytes(items[1], "big"))

    # -- mint (api.go:1396-1525) ---------------------------------------------
    def send_mint_transaction(self, value: int) -> bytes:
        self.wallet.recover(self.net.sn_exists)
        sn = self.wallet.sequence_number_after
        if self.net.balance_of(self.address) < value:
            raise NodeError("not enough balance")

        new_random = _rand_hash()
        new_sn = zapi.compute_prf(self.sk, new_random)
        new_value = sn.value + value
        new_cmt = zapi.gen_cmt(new_value, new_sn, new_random)

        proof, _ = self.net.zktx.gen_mint_proof(
            sn.value, new_value, value, self.sk, sn.random, new_random,
            sn_old=sn.sn)

        tx = CS.ZkTransaction(code=CS.TxCode.MINT, sender=self.address,
                              zk_value=value, zk_sn=sn.sn, zk_cmt=new_cmt,
                              zk_proof=proof)
        h = self.net.submit(tx)
        self.wallet.advance(W.Sequence(new_sn, new_cmt, new_random,
                                       new_value), W.Stage.MINT)
        return h

    # -- send (api.go:1560-1735) ----------------------------------------------
    def send_send_transaction(self, value: int, receiver_pub_rlp: bytes) -> bytes:
        self.wallet.recover(self.net.sn_exists)
        sn = self.wallet.sequence_number_after

        receiver_pub = self.decode_pub_key_rlp(receiver_pub_rlp)
        # one-time (stealth) key: R = sA*G published; receiver PK randomized
        sA, R = ZA.keygen()
        random_receiver_pk = ZA.new_random_pub_key(sA, receiver_pub)
        pk_recv160 = pubkey_to_address(*random_receiver_pk)

        new_random = _rand_hash()
        # pk_sender is the 20-byte account address: the reference passes
        # common.Address both to ComputeCRH (api.go:1665, zktx.go:274 pk[20])
        # and as GenSendProof's pk_sender (api.go:1687, zktx.go:406) — the
        # circuit's pk_sender DigestVariable is 160-bit.
        new_rs = zapi.compute_crh(self.address, new_random)
        cmts = zapi.gen_cmt_s(value, pk_recv160, new_rs, sn.sn)

        new_sn = zapi.compute_prf(self.sk, new_random)
        new_value = sn.value - value
        new_cmt = zapi.gen_cmt(new_value, new_sn, new_random)

        proof, _ = self.net.zktx.gen_send_proof(
            sn.value, new_value, value, self.sk, sn.random, new_random,
            self.address, pk_recv160, sn_old=sn.sn)
        aux = ZA.compute_aux(random_receiver_pk, value, new_rs, sn.sn)

        tx = CS.ZkTransaction(code=CS.TxCode.SEND, sender=self.address,
                              zk_sn=sn.sn, zk_cmt=new_cmt, zk_cmts=cmts,
                              zk_proof=proof)
        tx.aux = aux
        tx.x, tx.y = R  # sender's ephemeral pubkey, read by the receiver
        h = self.net.submit(tx)
        self.wallet.sns = W.Sequence(b"\x00" * 32, cmts, new_rs, value)
        self.wallet.advance(W.Sequence(new_sn, new_cmt, new_random,
                                       new_value), W.Stage.SEND)
        return h

    # -- deposit (api.go:1745-1959) --------------------------------------------
    def send_deposit_transaction(self, send_tx_hash: bytes) -> bytes:
        self.wallet.recover(self.net.sn_exists)
        found = self.net.get_transaction(send_tx_hash)
        if found is None:
            raise NodeError("there does not exist a transaction "
                            + send_tx_hash.hex())
        tx_send, send_block = found

        # gather cmts from the send block + random others until >= ZKCMTNODES
        # (api.go:1823-1855), then sort block numbers and flatten (:1857-1862)
        latest = len(self.net.chain.blocks) - 1
        block_nums = [send_block]
        block_cmts = {send_block: list(self.net.chain.blocks[send_block]["cmt"])}
        count = len(block_cmts[send_block])
        while count < ZKCMTNODES:
            if len(block_nums) > latest + 1:
                raise NodeError("insufficient cmts for merkle tree")
            bn = self.net.rng.randint(0, latest)
            if bn in block_nums:
                continue
            cmts = list(self.net.chain.blocks[bn]["cmt"])
            block_cmts[bn] = cmts
            block_nums.append(bn)
            count += len(cmts)
        block_nums.sort()
        cmts_for_merkle: List[bytes] = []
        for bn in block_nums:
            cmts_for_merkle.extend(block_cmts[bn])
        depth = getattr(self.net.zktx, "merkle_depth", None)
        rt = (zapi.gen_rt(cmts_for_merkle, depth) if depth
              else zapi.gen_rt(cmts_for_merkle))

        # derive the one-time key and decrypt the memo
        R = (tx_send.x, tx_send.y)
        ot_priv, ot_pub = ZA.generate_key_for_random_b(
            R, self.key_priv, self.key_pub)
        value_s, rs, sna = ZA.dec_aux(ot_pub, tx_send.aux)
        if value_s <= 0:
            raise NodeError("transfer amount must be larger than 0")

        snb = self.wallet.sequence_number_after
        new_random = _rand_hash()
        new_sn = zapi.compute_prf(self.sk, new_random)
        sns = zapi.compute_prf(self.sk, rs)
        new_value = snb.value + value_s
        new_cmt = zapi.gen_cmt(new_value, new_sn, new_random)
        ot_addr = pubkey_to_address(*ot_pub)

        proof, _ = self.net.zktx.gen_deposit_proof(
            snb.value, new_value, value_s, self.sk, snb.random, new_random,
            rs, sna, ot_addr, cmts_for_merkle, sn_old=snb.sn)

        if self.net.chain.db.exists(ot_addr):
            raise NodeError("pubkeyb can not be used for a second time")

        tx = CS.ZkTransaction(code=CS.TxCode.DEPOSIT, sender=self.address,
                              zk_sn=snb.sn, zk_sns=sns, zk_cmt=new_cmt,
                              zk_proof=proof, rt_cmt=rt,
                              one_time_addr=ot_addr)
        tx.cmt_blocks = block_nums
        tx.x, tx.y = ot_pub
        # deposit txs are signed with the one-time key (api.go:1929)
        tx.sig = ZA.ecdsa_sign(ot_priv % ZA.N, tx_hash(tx))
        h = self.net.submit(tx)
        self.wallet.advance(W.Sequence(new_sn, new_cmt, new_random,
                                       new_value), W.Stage.DEPOSIT)
        return h

    # -- redeem (api.go:1963+) ---------------------------------------------
    def send_redeem_transaction(self, value: int) -> bytes:
        self.wallet.recover(self.net.sn_exists)
        sn = self.wallet.sequence_number_after
        if sn.value < value:
            raise NodeError("hidden balance too low for redeem")

        new_random = _rand_hash()
        new_sn = zapi.compute_prf(self.sk, new_random)
        new_value = sn.value - value
        new_cmt = zapi.gen_cmt(new_value, new_sn, new_random)

        proof, _ = self.net.zktx.gen_redeem_proof(
            sn.value, new_value, value, self.sk, sn.random, new_random,
            sn_old=sn.sn)

        tx = CS.ZkTransaction(code=CS.TxCode.REDEEM, sender=self.address,
                              zk_value=value, zk_sn=sn.sn, zk_cmt=new_cmt,
                              zk_proof=proof)
        h = self.net.submit(tx)
        self.wallet.advance(W.Sequence(new_sn, new_cmt, new_random,
                                       new_value), W.Stage.REDEEM)
        return h

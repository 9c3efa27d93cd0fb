"""User-facing node layer (L9): wallet sequence state with durable SNfile
persistence and the RPC transaction-builder surface of the reference geth
fork (internal/ethapi/api.go Send{Mint,Send,Deposit,Redeem}Transaction,
GetBalance2, GetPubKeyRLP)."""

from .wallet import Sequence, SequenceS, Stage, Wallet
from .node import Network, Node

__all__ = ["Sequence", "SequenceS", "Stage", "Wallet", "Network", "Node"]

"""blockmaze_tpu_torch's node, wallet and chain state against the JAX
package's: the cases of tests/test_node.py on the port's Network and Node
(with test_node's FakeZkTx, hash-commitment proofs), and one seeded
mint -> send -> deposit -> redeem lifecycle on both packages reaching the
same state: balances, each block's commitments and root, both wallets."""

import dataclasses
import types

import pytest

import test_node
from blockmaze_tpu.node import Network as JaxNetwork
from blockmaze_tpu.node import Node as JaxNode
from blockmaze_tpu.node import node as jnode_mod
from blockmaze_tpu.zktx import aux as jaux
from blockmaze_tpu_torch.chain import state as CS
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.merkle import incremental as MK
from blockmaze_tpu_torch.node import Network, Node
from blockmaze_tpu_torch.node import node as node_mod
from blockmaze_tpu_torch.node import wallet as W
from blockmaze_tpu_torch.node.node import NodeError
from blockmaze_tpu_torch.zktx import api as zapi
from blockmaze_tpu_torch.zktx import aux

from test_node import FakeZkTx
from test_torch_zktx import SeededSecrets

# tests/test_node.py's cases, each run with the port's modules in place of
# the JAX package's (FakeZkTx stays test_node's)
_PORT = dict(vars(test_node), __name__=__name__, CS=CS, NT=NT, MK=MK,
             Network=Network, Node=Node, NodeError=NodeError, W=W,
             zapi=zapi)
for _name, _fn in vars(test_node).items():
    if _name.startswith("test_"):
        globals()[_name] = types.FunctionType(_fn.__code__, _PORT, _name)


@pytest.fixture
def net():
    return Network(FakeZkTx(), seed=7)


def lifecycle(network_cls, node_cls, datadir):
    """mint 100 -> send 40 -> deposit -> redeem 25 (scripts/lifecycle.py's
    steps); returns the state the two packages must agree on."""
    net = network_cls(FakeZkTx(), seed=42)
    alice = node_cls(net, str(datadir / "a"))
    bob = node_cls(net, str(datadir / "b"))
    net.fund(alice.address, 500)
    net.fund(bob.address, 10)
    blocks = []
    alice.send_mint_transaction(100)
    blocks.append(net.mine_block())
    h_send = alice.send_send_transaction(40, bob.get_pub_key_rlp())
    blocks.append(net.mine_block())
    bob.send_deposit_transaction(h_send)
    blocks.append(net.mine_block())
    bob.send_redeem_transaction(25)
    blocks.append(net.mine_block())

    def wallet(node):
        w = node.wallet
        return (dataclasses.astuple(w.sequence_number),
                dataclasses.astuple(w.sequence_number_after),
                w.sns and dataclasses.astuple(w.sns), int(w.stage))

    return {"balances": [net.balance_of(n.address) for n in (alice, bob)],
            "cmt_balances": [net.cmt_balance_of(n.address)
                             for n in (alice, bob)],
            "blocks": [(b["number"], list(b["cmt"]), b["rtcmt"])
                       for b in blocks],
            "wallets": [wallet(alice), wallet(bob)],
            "balance2": [alice.get_balance2(), bob.get_balance2()]}


def test_seeded_lifecycle_matches_jax(tmp_path, monkeypatch):
    for mod in (node_mod, jnode_mod, aux, jaux):
        monkeypatch.setattr(mod, "secrets", SeededSecrets(2024))
    got = lifecycle(Network, Node, tmp_path / "port")
    want = lifecycle(JaxNetwork, JaxNode, tmp_path / "jax")
    assert got == want
    assert [b["wallet_value"] for b in got["balance2"]] == [60, 15]
    assert got["balances"] == [400, 35]

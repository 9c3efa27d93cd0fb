"""Mint on the port: the circuit, a transaction's witness as the service
synthesises it, and the service's own calls (zktx.go GenMintProof and
VerifyMintProof)."""

from blockmaze_tpu_torch.circuits import instances
from blockmaze_tpu_torch.circuits.mint import MintGadget
from blockmaze_tpu_torch.crypto import notes as NT
from blockmaze_tpu_torch.r1cs.protoboard import Protoboard
from blockmaze_tpu_torch.zktx import api

CIRCUIT = "mint"


def service(key_dir, config, device):
    """The node's ZkTx on the keys in key_dir, warmed for mint."""
    svc = api.ZkTx(key_dir, config.get("merkle_depth"), device)
    svc.warm([CIRCUIT])
    return svc


def protoboard():
    """The circuit with its constraints, for keygen."""
    return instances.protoboard(CIRCUIT)


def witness(tx, config):
    """(primary, aux) of the transaction, the witness alone."""
    sk, r_old, r = tx["sk"], tx["r_old"], tx["r"]
    note_old = NT.Note(tx["value_old"], NT.compute_prf(sk, r_old), r_old)
    note = NT.Note(tx["value_old"] + tx["value_s"], NT.compute_prf(sk, r), r)
    pb = Protoboard()
    MintGadget(pb).generate_witness(note_old, note, note_old.cm(), note.cm(),
                                    tx["value_s"], sk)
    return pb.primary_input(), pb.auxiliary_input()


def prove_tx(svc, tx):
    """A wallet's call: (the proof's wire hex, the public input)."""
    return svc.gen_mint_proof(tx["value_old"], tx["value_old"] + tx["value_s"],
                              tx["value_s"], tx["sk"], tx["r_old"], tx["r"])


def verify_tx(svc, tx, proof_hex) -> bool:
    """A node's call on the transaction's public fields."""
    sn_old = api.compute_prf(tx["sk"], tx["r_old"])
    cm_old = api.gen_cmt(tx["value_old"], sn_old, tx["r_old"])
    cm = api.gen_cmt(tx["value_old"] + tx["value_s"],
                     api.compute_prf(tx["sk"], tx["r"]), tx["r"])
    return svc.verify_mint_proof(proof_hex, cm_old, sn_old, cm,
                                 tx["value_s"])

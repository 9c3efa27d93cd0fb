"""The send deployment of the port's benchmark (portbench/configs/send.*) on
the CPU: the port's public input against the plain reference's statement
on transactions of the cell's stream and at the ends of the draw, the
witnesses against send's R1CS, an overspend the circuit rejects, the
reference's imports, the configuration's sizes against the code, and the
cells send.prove and deposit.batch8 as the harness resolves them."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from blockmaze_tpu_torch.fields import tfield as tf
from blockmaze_tpu_torch.groth16.prover import _wire_words, wire_widen
from blockmaze_tpu_torch.msm import pippenger as pp
from blockmaze_tpu_torch.ntt import domain as D
from blockmaze_tpu_torch.r1cs.gadgets.basic import PackingGadget
from portbench import loops, spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "portbench", "configs")
CELLS = ["send.prove", "deposit.batch8"]

REF = spec.load_module(os.path.join(CONFIGS, "send_ref.py"))
PROG = spec.load_module(os.path.join(CONFIGS, "send.py"))


def config():
    return spec.read_json(os.path.join(CONFIGS, "send.json"))


def transaction(case: str) -> dict:
    """A transaction of the cell's stream; the edge cases move value_s to
    an end of the draw's range [0, value_old]."""
    rng = loops.stream(2**31 + 22, "pool")
    tx = REF.transaction(rng)
    if case == "drawn_2":
        tx = REF.transaction(rng)
    elif case == "value_s_zero":
        tx["value_s"] = 0
    elif case == "value_s_all":
        tx["value_s"] = tx["value_old"]
    elif case == "overspend":
        tx["value_s"] = tx["value_old"] + 1
    return tx


CASES = ["drawn", "drawn_2", "value_s_zero", "value_s_all"]


@pytest.fixture(scope="module")
def board():
    """send's protoboard with its constraints (the instance's witness)."""
    return PROG.protoboard()


def satisfied(board, primary, aux) -> bool:
    board.values = [1] + list(primary) + list(aux)
    return board.is_satisfied()


@pytest.mark.parametrize("case", CASES)
def test_public_input_is_the_references_statement(case):
    """The port's witness states what the reference works out: CRH, cmtS
    and the new note at value_old - value_s; another sender's address or
    another value_s states something else."""
    cfg, tx = config(), transaction(case)
    primary, aux = PROG.witness(tx, cfg)
    assert len(primary) == cfg["public_inputs"]
    assert len(primary) + len(aux) == cfg["variables"]
    assert primary == REF.statement(tx, cfg)
    other = dict(tx, pk_sender=bytes(20))
    assert primary != REF.statement(other, cfg)
    other = dict(tx, value_s=tx["value_s"] ^ 1)
    if other["value_s"] <= tx["value_old"]:
        assert primary != REF.statement(other, cfg)


@pytest.mark.parametrize("case", CASES)
def test_witness_satisfies_the_send_r1cs(board, case):
    primary, aux = PROG.witness(transaction(case), config())
    assert satisfied(board, primary, aux)


@pytest.mark.parametrize("case", CASES)
def test_wide_wires_take_the_exact_limbs(case):
    """Every send witness has wires of 2^64 and above (the packed inputs,
    the comparison's alpha_packed = 2^64 + value_old - value_s): the
    prover's limbs equal ints_to_limbs on each of them."""
    primary, aux = PROG.witness(transaction(case), config())
    wires = [1] + list(primary) + list(aux)
    words, wide = _wire_words(primary, aux, np.empty(len(wires), np.int64))
    assert len(wide) == sum(w >= 2**64 for w in wires) >= len(primary)
    limbs = wire_widen(torch.from_numpy(words), torch.from_numpy(wide))
    assert np.array_equal(limbs.numpy().view(np.uint32),
                          tf.ints_to_limbs(wires))


def test_overspend_leaves_the_r1cs_unsatisfied(board, monkeypatch):
    """value_s = value_old + 1: the witness generator refuses it (alpha =
    2^64 - 1 has no bit pattern whose bit 64 is the constant ONE, as the
    bug-compatible comparison packs it). Built without that refusal, the
    witness fails the R1CS, while a witness within the draw still holds:
    the reference's rule value_s <= value_old is the circuit's."""
    cfg, tx = config(), transaction("overspend")
    with pytest.raises(AssertionError):
        PROG.witness(tx, cfg)

    def lenient(gadget):
        v = gadget.pb.lc_val(gadget.packed)
        for i, b in enumerate(gadget.bits):
            if b != 0:
                gadget.pb.setval(b, (v >> i) & 1)
    monkeypatch.setattr(PackingGadget, "witness_from_packed", lenient)
    assert not satisfied(board, *PROG.witness(tx, cfg))
    assert satisfied(board, *PROG.witness(transaction("value_s_all"), cfg))


def test_send_reference_imports_nothing_of_jax_or_the_port():
    code = textwrap.dedent(f"""
        import json, random, sys
        sys.path.insert(0, {ROOT!r})
        from portbench import spec
        ref = spec.load_module({CONFIGS!r} + "/send_ref.py")
        ref.statement(ref.transaction(random.Random(1)), {{}})
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    modules = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not modules & {"jax", "jaxlib", "flax", "blockmaze_tpu",
                          "blockmaze_tpu_torch", "torch"}


def test_config_states_what_the_code_gives(board):
    cfg = config()
    assert cfg["name"] == cfg["circuit"] == PROG.CIRCUIT == "send"
    assert cfg["variables"] == board.num_variables
    assert cfg["constraints"] == len(board.constraints)
    assert cfg["public_inputs"] == board.primary_input_size
    dom = D.get_evaluation_domain(len(board.constraints)
                                  + board.primary_input_size + 1)
    assert isinstance(dom, D.BasicDomain)
    assert cfg["domain"] == {"kind": "basic", "size": dom.m}
    assert cfg["pippenger_window"] == pp.default_window(board.num_variables)
    assert len(cfg["vk_ic"]) == cfg["public_inputs"] + 1
    assert cfg["reduced"] == []


@pytest.mark.parametrize("name,config_name,traffic", [
    ("send.prove", "send", {"kind": "prove", "pool": 4}),
    ("deposit.batch8", "deposit", {"kind": "batch", "batch": 8})])
def test_cell_resolves(name, config_name, traffic):
    cell = spec.Cell(ROOT, name)
    assert cell.chips == 1
    assert cell.config["name"] == config_name
    assert cell.traffic == traffic
    assert os.path.exists(cell.config_py)
    assert os.path.exists(cell.config_ref_py)
    reported = [m["name"] for m in cell.end_to_end()]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer()


@pytest.mark.parametrize("name", CELLS)
def test_cell_metrics_have_readers(name):
    """Every metric the cell reports, end to end or per layer, has a
    reader under portbench/metrics/ with a read(run)."""
    cell = spec.Cell(ROOT, name)
    for m in cell.end_to_end() + cell.per_layer():
        assert callable(cell.metric_reader(m["name"]).read), m["name"]

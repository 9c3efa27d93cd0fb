"""The port's bench (blockmaze_tpu_torch/scripts/bench.py) and its
witness-only functions (blockmaze_tpu_torch/circuits/witnesses.py) on the
CPU, at small sizes: their witnesses equal to the JAX package's
scripts/witnesses.py and to circuits/instances.py; the bench on a chain
circuit with seeded keys (each timed proof equal to Prover.prove at its
(r, s) and accepted by both verifiers, its rates as bench.py defines
them); its headline against bench.py's own block; bench.py's JSON keys a
subset of the port's; bench.py's key errors; the knobs and exit codes.
bench.py itself imports jax and sets up caches at import, so it is read
with ast, never imported."""

import ast
import copy
import functools
import importlib.util
import json
import os

import pytest
import torch

from blockmaze_tpu.groth16 import verifier as jverifier
from blockmaze_tpu_torch.circuits import instances, witnesses
from blockmaze_tpu_torch.fields.constants import R_MOD
from blockmaze_tpu_torch.groth16 import verifier
from blockmaze_tpu_torch.groth16.prover import Prover
from blockmaze_tpu_torch.r1cs.examples import chain_circuit
from blockmaze_tpu_torch.scripts import _common, bench

# small tensors: one intra-op thread per test process (xdist runs several)
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
WINDOW, LANES = 4, 64      # every plain MSM pays ~254 sequential doublings
NCONS = 6                  # chain circuit: 7 variables, basic domain m = 8
REPS = 2
CHAIN_BASELINE = 0.5       # a stand-in reference rate for the chain circuit


def _bench_py():
    with open(os.path.join(ROOT, "bench.py")) as f:
        return ast.parse(f.read())


@functools.lru_cache(maxsize=None)
def _jax_witnesses():
    """The JAX package's scripts/witnesses.py, loaded by path (scripts/ is
    not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_witnesses", os.path.join(ROOT, "scripts", "witnesses.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def _witness(name):
    pb = witnesses.WITNESS[name]()
    return pb.primary_input(), pb.auxiliary_input(), len(pb.constraints)


@pytest.mark.parametrize("name", ["mint", "send", "redeem", "deposit"])
def test_witness_equals_jax(name):
    jpb = _jax_witnesses().WITNESS[name]()
    primary, aux, ncons = _witness(name)
    assert ncons == len(jpb.constraints) == 0    # generate_witness only
    assert primary == jpb.primary_input()
    assert aux == jpb.auxiliary_input()


@pytest.mark.parametrize("name", ["mint", "redeem"])
def test_witness_equals_instances(name):
    pb = instances.protoboard(name)
    primary, aux, _ = _witness(name)
    assert pb.constraints and pb.is_satisfied()
    assert primary == pb.primary_input()
    assert aux == pb.auxiliary_input()


def test_witnesses_copy_verbatim_but_imports():
    """Below its docstring and imports the port's file is the JAX one."""
    def body(path):
        with open(os.path.join(ROOT, path)) as f:
            text = f.read()
        return text[text.index("\n\ndef _u256"):]
    assert body("blockmaze_tpu_torch/circuits/witnesses.py") == \
        body("scripts/witnesses.py")


@pytest.fixture(scope="module")
def chain_run(tmp_path_factory):
    """bench.run over the chain circuit with seeded keys in a fresh cache
    (keygen first, through _common.resolve_keys), REPS timed proofs;
    bench_circuit wrapped to keep its proofs. Returns (keys, the JSON line,
    the proofs, the rejected circuits)."""
    cache = str(tmp_path_factory.mktemp("keys"))
    keys = _common.resolve_keys("chain", CPU, make_pb=lambda: chain_circuit(
        NCONS), cache=cache)
    kept = []
    real = bench.bench_circuit

    def keeping(*a, **kw):
        res = real(*a, **kw)
        kept.append(res)
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "bench_circuit", keeping)
        mp.setitem(bench.BASELINE, "chain", CHAIN_BASELINE)
        out, rejected = bench.run(
            ["chain"], CPU, REPS, LANES, WINDOW,
            witness={"chain": lambda: chain_circuit(NCONS)}, cache=cache)
    (fields, proofs, ok), = kept
    assert ok and fields.items() <= out.items()
    return keys, out, proofs, rejected


def test_bench_line(chain_run):
    keys, out, proofs, rejected = chain_run
    assert rejected == [] and out["chain_verified"]
    assert out["chain_key_source"] == "seeded cache"
    assert (out["chain_n"], out["chain_m"], out["chain_domain"]) == \
        (NCONS + 1, NCONS + 2, "basic")
    assert (out["chain_lanes"], out["chain_window"]) == (LANES, WINDOW)
    assert (out["backend"], out["lanes"], out["window"]) == \
        ("cpu", LANES, WINDOW)
    assert len(proofs) == 1 + REPS and len(out["chain_prove_secs"]) == REPS
    # the plain versions launch no kernel
    assert out["launches"] == {} and out["chain_launches"] == {}
    json.dumps(out)


def test_bench_rates(chain_run):
    _, out, _, _ = chain_run
    secs = out["chain_prove_secs"]
    assert all(t > 0 for t in secs)
    assert out["chain_proofs_per_sec"] == REPS / sum(secs)
    assert out["chain_proofs_per_sec_with_witness"] == \
        1.0 / (sum(secs) / REPS + out["chain_witness_sec"])
    assert out["chain_vs_baseline"] == \
        out["chain_proofs_per_sec"] / CHAIN_BASELINE
    # neither deposit nor mint benched: bench.py's headline of 0.0
    assert (out["metric"], out["value"], out["value_e2e"],
            out["vs_baseline"]) == ("deposit_proofs_per_sec", 0.0, 0.0, 0.0)


def _accepted(vk, primary, proof):
    """Both verifiers accept the proof and reject it for another input."""
    bad = [(primary[0] + 1) % R_MOD] + list(primary[1:])
    return all(v(vk, primary, proof) and not v(vk, bad, proof)
               for v in (jverifier.verify, verifier.verify))


def test_bench_first_proof_verifies(chain_run):
    keys, _, proofs, _ = chain_run
    assert _accepted(keys.vk, chain_circuit(NCONS).primary_input(),
                     proofs[0])


@pytest.mark.parametrize("rep", range(REPS))
def test_bench_timed_proof_equals_prove(chain_run, rep):
    """Timed proof `rep` (at (3 + rep, 5 + rep)) is Prover.prove's at the
    same (r, s), and both verifiers accept it."""
    keys, _, proofs, _ = chain_run
    pb = chain_circuit(NCONS)
    primary = pb.primary_input()
    want = Prover(keys.dpk, CPU, lanes=LANES, window=WINDOW).prove(
        primary, pb.auxiliary_input(), r=3 + rep, s=5 + rep)
    got = proofs[1 + rep]
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert _accepted(keys.vk, primary, got)


def _bench_py_headline():
    """bench.py's headline block (the `if "deposit_proofs_per_sec" in out`
    statement of its main), compiled alone."""
    main = next(n for n in _bench_py().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    block = next(n for n in main.body if isinstance(n, ast.If)
                 and isinstance(n.test, ast.Compare)
                 and getattr(n.test.left, "value", None)
                 == "deposit_proofs_per_sec")
    return compile(ast.Module(body=[block], type_ignores=[]), "bench.py",
                   "exec")


def _rates(circ, pps):
    return {f"{circ}_proofs_per_sec": pps,
            f"{circ}_proofs_per_sec_with_witness": pps / 3,
            f"{circ}_vs_baseline": pps * 7}


@pytest.mark.parametrize("benched", [["mint", "send", "deposit"],
                                     ["send", "mint"], ["send"], []])
def test_headline_matches_bench_py(benched):
    out = {"metric": "deposit_proofs_per_sec", "unit": "proofs/s"}
    for i, circ in enumerate(benched):
        out.update(_rates(circ, 1.5 + i))
    want = copy.deepcopy(out)
    exec(_bench_py_headline(), {"out": want})
    got = bench.headline(copy.deepcopy(out))
    assert want.items() <= got.items()
    head = "deposit" if "deposit" in benched else \
        "mint" if "mint" in benched else None
    assert got["value_e2e"] == (
        out[f"{head}_proofs_per_sec_with_witness"] if head else 0.0)


def test_headline_after_every_circuit():
    """The line is printed after each circuit: a mint headline becomes
    deposit's once deposit is benched."""
    out = bench.headline({**_rates("mint", 2.0)})
    assert out["metric"] == "mint_proofs_per_sec"
    out = bench.headline({**out, **_rates("deposit", 1.0)})
    assert (out["metric"], out["value"]) == ("deposit_proofs_per_sec", 1.0)


def _bench_py_keys():
    """(bench.py's per-circuit key suffixes, the `out[f"{circ}_..."]`
    targets; its constant top-level keys)."""
    suffixes, top = set(), set()
    for node in ast.walk(_bench_py()):
        if isinstance(node, ast.Subscript) and \
                getattr(node.value, "id", None) == "out":
            k = node.slice
            if isinstance(k, ast.JoinedStr) and \
                    isinstance(k.values[0], ast.FormattedValue) and \
                    k.values[0].value.id == "circ":
                suffixes.add(k.values[1].value)
            elif isinstance(k, ast.Constant) and isinstance(node.ctx,
                                                           ast.Store):
                top.add(k.value)
        elif isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "out":
            top |= {k.value for k in node.value.keys}
    return suffixes, top


def test_bench_py_keys_are_the_ports(chain_run):
    _, out, _, _ = chain_run
    suffixes, top = _bench_py_keys()
    assert {"_warmup_sec", "_proofs_per_sec", "_witness_sec",
            "_first_prove_sec", "_vs_baseline",
            "_proofs_per_sec_with_witness"} <= suffixes
    assert {"metric", "unit", "lanes", "window", "backend", "value",
            "value_e2e", "vs_baseline"} <= top
    assert {f"chain{s}" for s in suffixes} | top <= set(out)
    assert {f"chain_{s}" for s in ("prove_secs", "key_sec", "key_source")} \
        | {"build_sec", "library", "launches"} <= set(out)


def test_key_dir_missing_keys_recorded(tmp_path, capsys):
    """bench.py's error strings, one a circuit, and the run goes on: mint
    never generated, send with only an npz of another cache version."""
    stale = tmp_path / "sendpk.v0.npz"
    stale.write_bytes(b"")
    out, rejected = bench.run(["mint", "send"], CPU, 1,
                              key_dir=str(tmp_path))
    assert rejected == []
    assert out["errors"] == [
        "mint: reference keys not generated",
        f"send: npz cache is stale (found {[str(stale)]}, need v1) and no "
        f"pk.txt to rebuild"]
    assert not any(k.startswith(("mint_", "send_")) for k in out)
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert len(lines) == 2 and lines[0]["errors"] == out["errors"][:1]
    assert bench.key_error("mint", str(tmp_path)) == out["errors"][0]


def test_nothing_benched_exits_one(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["mint", "--device", "cpu", "--key-dir", str(tmp_path)])
    assert e.value.code == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("BENCH FAILED: no circuit benched")
    assert json.loads(lines[-1])["errors"] == \
        ["mint: reference keys not generated"]


def _canned(ok):
    def fake(circ, dev, reps, *a, **kw):
        return _rates(circ, 4.0), [], ok
    return fake


@pytest.mark.parametrize("ok", [True, False])
def test_main_ok_line_or_rejection(ok, monkeypatch, capsys):
    """A rejected proof exits 1; otherwise BENCH OK, then the whole line
    with deposit's headline."""
    monkeypatch.setattr(bench, "bench_circuit", _canned(ok))
    if ok:
        bench.main(["deposit", "mint", "--device", "cpu"])
    else:
        with pytest.raises(SystemExit) as e:
            bench.main(["deposit", "mint", "--device", "cpu"])
        assert e.value.code == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("BENCH OK" if ok else "BENCH FAILED")
    last = json.loads(lines[-1])
    assert (last["metric"], last["value"]) == ("deposit_proofs_per_sec", 4.0)


def test_knobs_from_environment_and_flags(monkeypatch):
    args = bench.arguments([])
    assert (args.circuits, args.reps, args.lanes, args.window) == \
        (["deposit", "mint", "send", "redeem"], 3, None, None)
    monkeypatch.setenv("BMTPU_BENCH_CIRCUITS", "mint, send")
    monkeypatch.setenv("BMTPU_REPS", "5")
    monkeypatch.setenv("BMTPU_LANES", "32768")
    monkeypatch.setenv("BMTPU_WINDOW", "13")
    args = bench.arguments([])
    assert (args.circuits, args.reps, args.lanes, args.window) == \
        (["mint", "send"], 5, 32768, 13)
    args = bench.arguments(["redeem", "--reps", "2", "--window", "12"])
    assert (args.circuits, args.reps, args.lanes, args.window) == \
        (["redeem"], 2, 32768, 12)


@pytest.mark.parametrize("argv", [["deposit20"], ["chain"], ["--reps", "0"]])
def test_refused_arguments(argv):
    with pytest.raises(SystemExit) as e:
        bench.arguments(argv + ["--device", "cpu"])
    assert e.value.code == 2

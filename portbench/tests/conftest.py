"""Fixtures of the benchmark's CPU tests: a copy of the checkout with the
toy chain configuration added as new files and entries only.

Run from the repository's root: python -m pytest portbench/tests -q
(all on the CPU, with the port's plain kernels; a few minutes).
"""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench.tests import chainfiles  # noqa: E402


def add_chain(root: str):
    """The chain configuration, a one-witness prove mix and a metric of its
    own written into the checkout at `root`, with their entries."""
    from blockmaze_tpu_torch.groth16 import generator
    from blockmaze_tpu_torch.r1cs.examples import chain_circuit
    portbench = os.path.join(root, "portbench")
    for name, text in (("configs/chain.py", chainfiles.CONFIG_PY),
                       ("configs/chain_ref.py", chainfiles.CONFIG_REF_PY),
                       ("metrics/test.proofs.py", chainfiles.METRIC_PY),
                       ("traffic/prove1.json",
                        json.dumps({"kind": "prove", "pool": 1})),
                       ("traffic/batch2.json",
                        json.dumps({"kind": "batch", "batch": 2, "warm": 1})),
                       ("traffic/tx1.json",
                        json.dumps({"kind": "tx", "warm": 1}))):
        with open(os.path.join(portbench, name), "w") as f:
            f.write(text)
    seed = 7
    _, vk, _ = generator.generate_cached(
        chain_circuit(12, 3), "chain", seed,
        os.path.join(portbench, "_cache", "keys"), "cpu")
    ic = [vk.gamma_ABC_first] + [p for _, p in sorted(vk.gamma_ABC_rest)]
    with open(os.path.join(portbench, "configs", "chain.json"), "w") as f:
        json.dump({"name": "chain", "circuit": "chain", "constraints": 12,
                   "setup_seed": seed, "vk_ic": [[p[0], p[1]] for p in ic]},
                  f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "chain", "source": "toy",
                             "file": "portbench/configs/chain.json",
                             "reduced": [], "why": "CPU tests"})
    for traffic in ("prove1", "batch2", "tx1"):
        bench["workloads"].append({"name": f"chain.{traffic}",
                                   "config": "chain", "traffic": traffic,
                                   "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] in ("proofs_per_s", "proof_p90_s"):
            m["workloads"] += ["chain.prove1", "chain.batch2"]
        if m["name"] == "tx_per_s":
            m["workloads"] += ["chain.tx1"]
    bench["per_layer"].append({"name": "test.proofs", "unit": "proofs",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "proofs_per_s",
                               "workloads": ["chain.prove1"]})
    with open(path, "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="package")
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and portbench/ with the chain cells added."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    add_chain(root)
    return root

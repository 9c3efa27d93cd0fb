"""The benchmark as data: BENCHMARK.json at the checkout's root and the
files it names, found by name.

- a configuration: portbench/configs/<config>.json (the deployment, as run),
  <config>.py beside it (the program's side: the circuit, a transaction's
  witness, the service's calls and, optionally, prover(dpk, devices), what
  serves its prove and batch traffic on the cell's cards: an object with
  prove, prove_batch, timings and close, as portbench/loops.py sets out;
  without it, one card's Prover) and <config>_ref.py (the plain
  reference: a transaction drawn from the traffic's stream, and the
  statement it proves);
- a traffic mix: portbench/traffic/<traffic>.json, whose "kind" names the
  loop of portbench/loops.py that drives it and whose other keys are that
  loop's parameters;
- a per-layer metric: portbench/metrics/<metric>.py, whose read(run)
  returns the metric's value or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(path: str):
    """The Python file at `path` as a module of its own."""
    name = "portbench_" + os.path.relpath(path, HERE).replace(os.sep, "_") \
        .replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.bench = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {', '.join(cells)})")
        self.workload = cells[name]
        self.name = name
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = read_json(os.path.join(root, entry["file"]))
        base = os.path.splitext(os.path.join(root, entry["file"]))[0]
        self.config_py = base + ".py"
        self.config_ref_py = base + "_ref.py"
        bench_dir = os.path.join(root, "portbench")
        self.traffic = read_json(os.path.join(
            bench_dir, "traffic", self.workload["traffic"] + ".json"))
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def metric_reader(self, name: str):
        return load_module(os.path.join(self.metrics_dir, name + ".py"))

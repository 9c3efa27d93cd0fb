"""The harness end to end on the CPU (the port's plain kernels) on the toy
chain configuration, which the checkout fixture adds as new files and
entries only: the harness finds its configuration, traffic mixes and a
per-layer metric of its own by name and runs them, and nothing it runs
loads JAX or the JAX package."""

import json
import os
import subprocess
import sys
import textwrap

from portbench import run, trace
from portbench.tests.conftest import REPO

SEED = 2**31 + 4099


def in_process(root, workload, seconds, trace_on=False):
    """run.run_cell in a fresh interpreter; (result, the top-level module
    names loaded once the run has closed)."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        from portbench import run, trace
        if {trace_on!r}:
            # the profiler over the plain kernels' many small ops is too
            # large for a test: the window's trace is a synthetic one
            class Fake(trace.Tracer):
                def __enter__(self):
                    import time
                    self.t0 = time.perf_counter()
                    return self
                def __exit__(self, *exc):
                    import time
                    self.t1 = time.perf_counter()
                    return False
                def trace(self):
                    t0, t1 = self.t0, self.t1
                    mid = (t0 + t1) / 2
                    return trace.Trace([("k", t0, mid)], (t0, t1),
                                       mid - t0, [(t0, mid)])
            run.Tracer = Fake
        if __name__ == "__main__":
            res = run.run_cell({root!r}, {workload!r}, {SEED}, {seconds},
                               {trace_on!r}, ["cpu"])
            print(json.dumps({{"result": res,
                              "modules": sorted({{m.split(".")[0]
                                                 for m in sys.modules}})}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["result"], set(got["modules"])


def test_added_cell_runs_and_imports_no_jax(checkout):
    res, modules = in_process(checkout, "chain.prove1", 0.5, trace_on=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # the per-layer metric added as a file of its own, read from the run
    assert res["metrics"]["test.proofs"]["value"] >= 1
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert list(res)[-1] == "checks"
    assert not modules & run.FORBIDDEN
    assert "blockmaze_tpu_torch" in modules


def test_service_cell_end_to_end_metrics(checkout):
    res, modules = in_process(checkout, "chain.tx1", 0.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"tx_per_s", "setup_s"}
    assert res["checks"]["verdict"] == {"value": 0, "limit": 0}
    assert not modules & run.FORBIDDEN


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from portbench import spec
    for w in bench["workloads"]:
        cell = spec.Cell(REPO, w["name"])
        assert os.path.exists(cell.config_py)
        assert os.path.exists(cell.config_ref_py)
        for m in cell.end_to_end() + cell.per_layer():
            assert hasattr(cell.metric_reader(m["name"]), "read")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end())
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()


def test_trace_reduction_is_unused_without_trace():
    assert trace.Tracer(False).trace() is None

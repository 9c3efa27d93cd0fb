"""portbench/spanrun.py end to end on the CPU on the toy chain cells: the
window's spans read as the per-layer metrics of span_metrics.json, the
idle time split by span, and nothing it runs loads JAX."""

import json
import subprocess
import sys
import textwrap

from portbench import run
from portbench.tests.conftest import REPO

SEED = 2**31 + 4099


def spanrun_in_process(root, workload, seconds, trace_on):
    """spanrun.run_cell in a fresh interpreter, a synthetic device trace
    (the card busy over the window's first half) when trace_on."""
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path.insert(0, {REPO!r})
        from portbench import spanrun, trace

        class Fake(spanrun.DriftTracer):
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                self.t1 = time.perf_counter()
                self.drift_us = 0.0
                return False

            def trace(self):
                t0, t1 = self.t0, self.t1
                mid = (t0 + t1) / 2
                return trace.Trace([("k", t0, mid)], (t0, t1), mid - t0,
                                   [(t0, mid)])

        if {trace_on!r}:
            spanrun.DriftTracer = Fake
        if __name__ == "__main__":
            res = spanrun.run_cell({root!r}, {workload!r}, {SEED},
                                   {seconds}, {trace_on!r}, ["cpu"])
            print(json.dumps({{"result": res,
                              "modules": sorted({{m.split(".")[0]
                                                 for m in sys.modules}})}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return got["result"], set(got["modules"])


def test_spanrun_prove_cell(checkout):
    res, modules = spanrun_in_process(checkout, "chain.prove1", 0.5, True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    for name in ("prover.limbs_ms", "prover.upload_ms", "prover.blinds_ms",
                 "prover.fetch_ms", "prover.unblind_ms", "prover.group_ms",
                 "msm.wait_ms", "kernel.launches_per_proof"):
        assert m[name]["value"] >= 0, name
    assert "batch.limbs_ms" not in m and "zktx.witness_s" not in m
    bd = res["breakdown"]
    idle = res["device"]["window_s"] - res["device"]["busy_s"]
    assert abs(sum(v for _, v in bd["idle_spans"]) - idle) < 1e-6 * idle
    assert bd["span_seconds"]["prover.prove"][0] == res["attempted"]
    assert res["device"]["clock_drift_us"] == 0.0
    assert list(res)[-1] == "checks"
    assert not modules & run.FORBIDDEN


def test_spanrun_batch_cell_untraced(checkout):
    res, _ = spanrun_in_process(checkout, "chain.batch2", 0.5, False)
    assert res["correct"], res["checks"]
    assert res["metrics"]["batch.limbs_ms"]["value"] > 0
    assert res["metrics"]["batch.wait_ms"]["value"] > 0
    assert "idle_spans" not in res["breakdown"]
    assert "clock_drift_us" not in res["device"]

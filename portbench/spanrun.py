"""One run of one cell with the program's span recorder on over the window.

    python3 -m portbench.spanrun --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout: portbench/run.py's run (the same set-up,
window, judge and result line), with blockmaze_tpu_torch.utils.spans
enabled around the window and the kernels' launch counts read at both of
its ends. The result line adds:

- metrics: the per-layer metrics of portbench/span_metrics.json that read
  something in this run (readers in portbench/metrics/, found by name);
- breakdown: span_seconds (each span name's count, inclusive and self
  seconds over the window), host.gc_by_generation (the collections'
  count and seconds by generation), zktx.synth_rest_s (tx traffic: zktx.synth_s
  less zktx.notes, zktx.witness and zktx.encode a transaction), and with
  --trace 1 idle_spans (idle device seconds by the innermost span open
  then, "between requests" outside every span) and busy_outside_roots_s
  (device-busy seconds outside every request's root span);
- device: with --trace 1, clock_drift_us, the host clock's offset from the
  wall clock (which the profiler's events are on) at the window's end less
  that at its start.

The recorder's cost is this command's end-to-end metrics against run.py's
at --trace 0. It exits 2 without a result when no card is visible or the
program has no span recorder.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from . import run, spantree, spec
from .trace import Tracer

SPAN_METRICS = os.path.join(spec.HERE, "span_metrics.json")


class DriftTracer(Tracer):
    """Tracer that also reads the clock offset at the window's end, and
    reduces the profile once."""

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self.on:
            end = time.perf_counter() - time.time_ns() / 1e9
            self.drift_us = 1e6 * (end - self.offset)
        return out

    def trace(self):
        if not hasattr(self, "_trace"):
            self._trace = super().trace()
        return self._trace


@contextlib.contextmanager
def recording(seen: dict):
    """run.run_cell's window with the recorder on and its Tracer a
    DriftTracer; seen gets the loop, the window's return, its spans and
    its launches by kernel."""
    from blockmaze_tpu_torch.utils import kernels as kn
    from blockmaze_tpu_torch.utils import spans
    window = run.window

    def recorded(loop, seconds, trace):
        before = kn.counts()
        spans.drain()
        spans.enable()
        try:
            out = window(loop, seconds, trace)
        finally:
            spans.disable()
        after = kn.counts()
        seen.update(loop=loop, window=out, spans=spans.drain(),
                    launches={k: v - before[k] for k, v in after.items()
                              if v != before[k]})
        return out

    saved = run.window, run.Tracer
    run.window, run.Tracer = recorded, DriftTracer
    try:
        yield
    finally:
        run.window, run.Tracer = saved


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, devices) -> dict:
    """run.run_cell's result with what the window's spans read."""
    seen = {}
    with recording(seen):
        result = run.run_cell(root, workload, seed, seconds, trace, devices)
    records, _, window_s, tracer = seen["window"]
    tr = tracer.trace()
    r = run.Run(seen["loop"], records, window_s, None, tr)
    r.spans, r.launches = seen["spans"], seen["launches"]
    cell = spec.Cell(root, workload)
    for m in spec.read_json(SPAN_METRICS):
        value = cell.metric_reader(m["name"]).read(r)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = result.setdefault("breakdown", {})
    breakdown["span_seconds"] = spantree.span_seconds(r.spans)
    breakdown["host.gc_by_generation"] = spantree.gc_by_generation(r.spans)
    breakdown["launches"] = r.launches
    tree = spantree.Tree(r.spans)
    if r.kind == "tx" and records and tree.count("zktx.prove"):
        parts = tree.seconds({"zktx.notes", "zktx.witness", "zktx.encode"},
                             spantree.ROOTS["tx"])
        breakdown["zktx.synth_rest_s"] = cell.metric_reader(
            "zktx.synth_s").read(r) - parts / tree.count("zktx.prove")
    if tr is not None:
        breakdown["idle_spans"] = spantree.idle_by_span(tr, r.spans)
        breakdown["busy_outside_roots_s"] = spantree.busy_outside_roots(
            tr, r.spans)
        result["device"]["clock_drift_us"] = tracer.drift_us
    result["checks"] = result.pop("checks")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    try:
        from blockmaze_tpu_torch.utils import spans  # noqa: F401
    except ImportError:
        run.say("the program has no span recorder "
                "(blockmaze_tpu_torch/utils/spans.py)")
        return 2
    cell = spec.Cell(os.getcwd(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        run.say(f"{args.workload} needs {cell.chips} CUDA device(s)")
        return 2
    result = run_cell(os.getcwd(), args.workload, args.seed, args.seconds,
                      bool(args.trace), run.cards(cell.chips))
    run.stop_helpers()
    result["device"]["card"] = run.card_line()
    run.say(result["device"]["card"])
    if "clock_drift_us" in result["device"]:
        run.say(f"clock drift over the window: "
                f"{result['device']['clock_drift_us']:.3f} us")
    found = run.jax_loaded()
    if found:
        run.say(f"loaded in this process: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        run.say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

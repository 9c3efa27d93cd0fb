"""One run of one cell of the port's benchmark (BENCHMARK.json) on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The run sets up (the kernel library, the
deployment's keys, the Prover or the service, the traffic's pool and a
warm-up), runs the traffic's closed loop for --seconds, then, with the
program's state freed, judges what the window produced against the plain
reference (portbench/judge.py) and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1,
which runs the window under torch.profiler), device and, last, checks,
each number compared with its limit. The same checks are the last lines
of standard error.

A cell runs on cards cuda:0 ... cuda:{chips-1} (BENCHMARK.json's
"chips"). device.memory_peak_bytes is the fullest card's peak and
memory_peak_bytes_by_card every card's; with --trace 1, busy_s is the mean
over the cell's cards of each card's busy seconds (portbench/trace.py) and
busy_s_by_card every card's.

It exits nonzero and prints no result when no card is visible, when the
card count is below the cell's, or when jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from . import judge, loops, spec
from .trace import Tracer

FORBIDDEN = {"jax", "jaxlib", "flax", "blockmaze_tpu"}


def process_age() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return "; ".join(res.stdout.strip().splitlines()) or "nvidia-smi: none"


def cards(chips: int) -> list:
    """The devices of a cell of `chips` cards: cuda:0 ... cuda:{chips-1}."""
    import torch
    return [torch.device("cuda", i) for i in range(chips)]


class Context:
    """What a loop needs: the cell's configuration (its file, its program
    module, its plain reference), its traffic's parameters, the seed, the
    cell's devices (devices, in order; device, the first, where the keys
    and a Prover of one card live), whether the window is traced, and the
    checkout's cache."""

    def __init__(self, cell: spec.Cell, seed: int, devices, trace: bool):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.devices = list(devices)
        self.device = self.devices[0]
        self.trace = trace
        # the program's keys come from this trusted setup (a control may
        # change it; the judge holds the program to the configuration's)
        self.setup_seed = cell.config["setup_seed"]
        self.cache_dir = os.path.join(cell.root, "portbench", "_cache")
        self.ref = spec.load_module(cell.config_ref_py)
        self.prog = spec.load_module(cell.config_py)


class Run:
    """What the metric readers read: the window's records, its seconds, the
    set-up seconds, the trace (or None) and the msm_round work per pool
    slot (traced prove runs)."""

    def __init__(self, loop, records, window_s, setup_s, trace):
        self.kind = loop.kind
        self.records = records
        self.window_s = window_s
        self.setup_s = setup_s
        self.trace = trace
        self.work = loop.work


def window(loop, seconds: float, trace: bool):
    """The closed loop: requests back to back until `seconds` have passed
    since the first call. (records, failed, window seconds, tracer). A
    traced window synchronises every card of loop.ctx.devices at both
    ends."""
    records, failed, n = [], 0, 0
    with Tracer(trace, loop.ctx.devices if trace else ()) as tracer:
        t0 = time.perf_counter()
        while True:
            try:
                records.append(loop.request(n))
            except Exception:       # a request that fails counts, and the
                failed += 1         # loop goes on: its trace to stderr
                traceback.print_exc()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    return records, failed, t1 - t0, tracer


def read_metrics(cell, run, trace: bool) -> dict:
    wanted = cell.per_layer() if trace else cell.end_to_end()
    out = {}
    for m in wanted:
        value = cell.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, devices, plant=None) -> dict:
    """One run of the cell on `devices` (its cards, in order: cards(chips)
    on the card, ["cpu"] for the plain kernels): the result object.
    plant(loop), if given, is called before the set-up: a control or a
    fault put in place of the program's path (portbench/control.py)."""
    import torch
    cell = spec.Cell(root, workload)
    ctx = Context(cell, seed, devices, trace)
    loop = loops.KINDS[cell.traffic["kind"]](ctx)
    if plant is not None:
        plant(loop)
    started = process_age()
    loop.setup()
    setup_s = process_age()
    say(f"set-up {setup_s:.3f} s: process start to set-up {started:.3f}, "
        + ", ".join(f"{k} {v:.3f}" for k, v in loop.laps.items()))
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda:
        for d in ctx.devices:
            torch.cuda.reset_peak_memory_stats(d)
    records, failed, window_s, tracer = window(loop, seconds, trace)
    peaks = [torch.cuda.max_memory_allocated(d) if cuda else 0
             for d in ctx.devices]
    say(f"window: {len(records)} requests, {failed} failed, "
        f"{window_s:.3f} s")
    tr = tracer.trace()
    phases = [p for rec in records for p in loop.phases(rec)]
    program_key = loop.program_key()
    loop.close()
    if cuda:
        torch.cuda.empty_cache()
    checked = judge.checks(loop, records, failed, seed, program_key)
    run = Run(loop, records, window_s, setup_s, tr)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checked.values()),
        "attempted": len(records) + failed, "failed": failed,
        "metrics": read_metrics(cell, run, trace),
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if cuda else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": max(peaks),
                   "memory_peak_bytes_by_card": peaks}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s,
                                busy_s_by_card=tr.busy_s_by_card,
                                window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.by_name(),
                               "idle_gaps": tr.idle_by_phase(phases)}
    result["checks"] = checked
    return result


def stop_helpers():
    """Stop multiprocessing's resource tracker, which prove_batch's host
    workers start, and wait for it: the run leaves no process behind."""
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    cell = spec.Cell(os.getcwd(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    result = run_cell(os.getcwd(), args.workload, args.seed, args.seconds,
                      bool(args.trace), cards(cell.chips))
    stop_helpers()
    # the card's name and power limit, read once the window has closed
    result["device"]["card"] = card_line()
    say(result["device"]["card"])
    found = jax_loaded()
    if found:
        say(f"loaded in this process: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

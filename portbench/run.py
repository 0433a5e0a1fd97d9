"""Run one cell of ``BENCHMARK.json`` on the card this is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It loads and warms up (``setup_s``), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which are also the last lines on standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits with code 1 and prints
no result; it exits with code 3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import env, registry  # noqa: E402
from portbench.harness.record import Run  # noqa: E402
from portbench.harness.trace import Tracer  # noqa: E402


def power_limit_w() -> float:
    """The card's power limit, watts, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True)
    return float(out.stdout.strip().splitlines()[0])


def execute(cell: registry.Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: float = None,
            control: bool = False) -> Run:
    """Set up, measure, read the trace and check one cell; the result
    line is :func:`result_line`'s. ``device="cpu"`` runs the program's
    plain versions (the benchmark's own tests); ``control`` puts the
    configuration's lower-precision control in the program's place."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=trace,
              device=dev, control=control)
    run.tracer = Tracer(trace, seconds, run.cuda)
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    loop = cell.loop()
    state = loop.setup(run)
    if trace:
        run.note(f"profiler primed in {run.tracer.prime():.3f} s")
    run.sync()
    run.setup["setup_s"] = time.perf_counter() - t_start
    parts = {n: sum(b - a for a, b in v)
             for n, v in run.spans.by_name.items() if n.startswith("setup.")}
    run.note(f"set-up {run.setup['setup_s']:.3f} s, of it "
             + ", ".join(f"{n[6:]} {v:.3f} s" for n, v in parts.items()))
    loop.window(run, state)
    run.setup["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                      if run.cuda else 0)
    run.note(f"memory peak (max_memory_allocated) "
             f"{run.setup['memory_peak_bytes']} bytes")
    if trace:
        run.note(f"profiler started in the window in "
                 f"{run.tracer.start_s:.3f} s")
        run.summary = run.tracer.summary()
    loop.check(run, state)
    del state
    gc.collect()
    return run


def metrics(run: Run) -> dict:
    """The cell's end-to-end metrics (untraced run) or the per-layer
    metrics whose readers found something to read (traced run)."""
    out = {}
    if not run.traced:
        for m in run.cell.end_to_end():
            name = m["name"]
            value = run.setup["setup_s"] if name == "setup_s" \
                else run.e2e[name]
            out[name] = {"value": value, "unit": m["unit"]}
        return out
    for m in run.cell.per_layer():
        value = registry.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(run: Run, kind: str, power_w) -> dict:
    """The contract's JSON object; ``checks`` comes last."""
    device = {"platform": "gpu" if run.cuda else "cpu", "kind": kind,
              "count": run.cell.chips,
              "memory_peak_bytes": int(run.setup["memory_peak_bytes"]),
              "power_limit_w": power_w}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics(run),
           "device": device}
    if run.traced and run.summary is not None:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
        out["breakdown"] = run.summary.breakdown
    out["checks"] = {name: {"value": value if math.isfinite(value)
                            else str(value), "limit": limit}
                     for name, value, limit in run.checks}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = registry.Cell(registry.load_benchmark(), args.workload)
    env.set_cache_env()
    env.require_cards(cell.chips)
    import torch

    run = execute(cell, args.seed, args.seconds, bool(args.trace),
                  "cuda", T_START)
    found = env.forbidden_modules()
    if found:
        print(f"portbench: the run loaded forbidden modules: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        return 3
    line = result_line(run, torch.cuda.get_device_name(0), power_limit_w())
    for name, value, limit in run.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

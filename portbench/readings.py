"""The correctness check's readings over many seeds, in one process: the
program's sound runs, and the configuration's lower-precision control in
its place. The limits in ``limits/`` are set from these readings (above
the sound runs' largest, below the control's smallest).

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 4 5 6 --seconds 2 [--fault NAME --fault-seeds 7 8 9] \
        [--out readings.json]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``,
the check) with its result's ``checks``; ``--fault`` runs the program
with a fault of ``faults.py`` planted on its seeds. The JSON written to
``--out`` holds them all.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import env, registry  # noqa: E402


@contextlib.contextmanager
def _planted(fault):
    """Plant ``fault`` (or nothing) for the ``with`` block."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault is not None:
        fault(patch)
    try:
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def readings(cell: registry.Cell, seeds, control_seeds, seconds: float,
             device: str = "cuda", fault: str = None,
             fault_seeds=()) -> dict:
    """``{"sound": [...], "control": [...], "fault:<name>": [...]}``:
    each a run's seed, its compared numbers and whether it came out
    correct."""
    from portbench.faults import FAULTS
    from portbench.harness.registry import load_module

    run_mod = load_module(registry.BENCH / "run.py", "portbench_run")
    kinds = [("sound", seeds), ("control", control_seeds)]
    if fault:
        kinds.append((f"fault:{fault}", fault_seeds))
    out = {}
    for kind, seq in kinds:
        out[kind] = []
        planted = FAULTS[cell.mix["loop"]][fault] \
            if kind.startswith("fault:") else None
        for seed in seq:
            t0 = time.perf_counter()
            with _planted(planted):
                run = run_mod.execute(cell, seed, seconds, False, device,
                                      control=kind == "control")
            rec = {"seed": seed, "correct": run.correct,
                   "numbers": {n: v for n, v, _ in run.checks},
                   "limits": {n: lim for n, _, lim in run.checks},
                   "e2e": dict(run.e2e),
                   "seconds": time.perf_counter() - t0}
            print(f"readings {cell.name} {kind} seed {seed}: "
                  f"{json.dumps(rec)}", file=sys.stderr, flush=True)
            out[kind].append(rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = registry.Cell(registry.load_benchmark(), args.workload)
    env.set_cache_env()
    env.require_cards(cell.chips)
    out = readings(cell, args.seeds, args.control_seeds, args.seconds,
                   fault=args.fault, fault_seeds=args.fault_seeds)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    for kind in out:
        for name in cell.limits:
            vals = [r["numbers"][name] for r in out[kind]]
            if vals:
                print(f"{cell.name} {kind} {name}: min {min(vals)!r} "
                      f"max {max(vals)!r} over {len(vals)} seeds")
    return 0


if __name__ == "__main__":
    sys.exit(main())

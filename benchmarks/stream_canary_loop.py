"""Phase ``stream`` of ``chip_smoke.py`` run again and again on one ``pio``
store, to count how often the stream canary refuses a fold-in and to show
what each of its probes paid::

    python3 benchmarks/stream_canary_loop.py [--runs 8] [--seed 0]

Runs the script's ``card`` and ``build`` phases, its ``pio`` phase once
(ingest, ``cli train``), then its ``stream`` phase ``--runs`` times, each
with bursts drawn from a seed of its own and the trainer's cursor moved
to the log's end with its consumed count set to 0. A failed run is
recorded and the next one runs. Each canary check prints the line of
``chip_smoke.CanaryProbeLog``; the last line is a JSON tally: runs, runs
that failed and why, canary checks and refusals. Needs the CUDA card.
"""

import argparse
import contextlib
import io
import json
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


class _Tee(io.TextIOBase):
    def __init__(self, *outs):
        self.outs = outs

    def write(self, s):
        for o in self.outs:
            o.write(s)
        return len(s)

    def flush(self):
        for o in self.outs:
            o.flush()


def reset_cursor(home: str) -> None:
    from predictionio_tpu_torch.data.storage.registry import Storage
    from predictionio_tpu_torch.streaming import EventCursor

    st = Storage(env={"PIO_HOME": home})
    try:
        app = st.apps().get_by_name(cs.PIO_APP)
        cur = EventCursor(st, app.id, "stream-trainer")
        cur.consumed_total = 0
        cur.save()
    finally:
        st.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cs.phase_card()
    cs.phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    data = cs.load_surrogate(args.seed)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    home = tempfile.mkdtemp(prefix="pio_home_", dir=scratch)
    runs = []
    try:
        with cs.phase("pio"):
            pio = cs.phase_pio(data, dev, home)
        for run in range(args.runs):
            reset_cursor(home)
            buf = io.StringIO()
            t0 = time.perf_counter()
            failure = None
            with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
                try:
                    cs.phase_stream(data, dev, home, pio, args.seed + run)
                except SystemExit as e:
                    failure = str(e)
                    print(f"run {run + 1}: {failure}", flush=True)
            # the next run's bursts are stamped after this run's
            pio["log_end_ms"] = int(time.time() * 1000) + 1
            verdicts = re.findall(r"canary check \d+: verdict=(\w+)",
                                  buf.getvalue())
            runs.append({"run": run + 1, "seconds": round(
                time.perf_counter() - t0, 1), "failure": failure,
                "checks": len(verdicts),
                "refusals": verdicts.count("rollback")})
            print(f"stream canary loop: {json.dumps(runs[-1])}", flush=True)
    finally:
        shutil.rmtree(home, ignore_errors=True)
    tally = {"runs": len(runs),
             "runs_failed": sum(r["failure"] is not None for r in runs),
             "runs_refused": sum(r["refusals"] > 0 for r in runs),
             "checks": sum(r["checks"] for r in runs),
             "refusals": sum(r["refusals"] for r in runs)}
    print(json.dumps({"stream_canary_loop": tally}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Whole ``chip_smoke.py`` runs of two or more trees, in turn on one card,
and which phase each run ended in, so a phase that fails now and then can
be compared between two commits::

    python3 benchmarks/chip_ab_smoke.py OUT LABEL=TREE LABEL=TREE ...

Each ``LABEL=TREE`` is one run, in the order given (for two commits:
parent, change, change, parent, ...). ``TREE`` is a checkout of a commit
(for the parent: ``git archive <commit>`` unpacked into a git-ignored
directory); its own ``chip_smoke.py`` runs with the tree as the working
directory, one process a run, and builds the kernels into the tree's own
``build/``. Each run's output goes to ``OUT/<n>_<label>.log``. A line a
run then prints here: its label, exit code, seconds, the phases that
passed, the phase it failed in and the failure, and the stream canary's
refusals. The last line tallies the failed runs by label. Needs the CUDA
card.
"""

import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

#: one run's limit: a whole chip_smoke.py run takes ~300 s on the H100
RUN_TIMEOUT_S = 900


def summary(label: str, rc: int, seconds: float, log: str) -> dict:
    passed = re.findall(r"^phase (\S+) seconds=", log, re.M)
    failed = re.findall(r"^chip_smoke: FAILED: (.*)$", log, re.M)
    return {"label": label, "rc": rc, "seconds": round(seconds, 1),
            "phases_passed": passed,
            "failed_after": passed[-1] if failed and passed else None,
            "failure": failed[0] if failed else None,
            "canary_refusals": re.findall(r"^stream canary refused.*$", log,
                                          re.M)}


def main(argv: list) -> int:
    out = Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    runs = [a.split("=", 1) for a in argv[1:]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    fails = Counter()
    for n, (label, tree) in enumerate(runs):
        t0 = time.perf_counter()
        path = out / f"{n}_{label}.log"
        with path.open("w") as f:
            try:
                rc = subprocess.run([sys.executable, "chip_smoke.py"],
                                    cwd=tree, stdout=f,
                                    stderr=subprocess.STDOUT,
                                    timeout=RUN_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        row = summary(label, rc, time.perf_counter() - t0, path.read_text())
        fails[label] += rc != 0
        print(json.dumps(row), flush=True)
    print(json.dumps({"runs": Counter(label for label, _ in runs),
                      "failed": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

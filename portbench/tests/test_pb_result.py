"""A whole run on the CPU at the tiny sizes (the look for a card
skipped): the last line carries the contract's keys only, each cell
reports its metrics, and the import guard holds."""

import json
import math
import subprocess
import sys

import pytest

from portbench.harness import env, registry

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]
CELLS = ["ml20m-explicit.train", "ml20m-implicit.train",
         "ml20m-explicit.score-all"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_keys_and_metrics(run_module, tiny_cell, name, trace):
    cell = tiny_cell(name)
    run = run_module.execute(cell, 2**31 + 11, 0.4, trace, "cpu")
    line = run_module.result_line(run, "cpu", None)
    keys = list(line)
    want = CONTRACT + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    json.loads(json.dumps(line, allow_nan=False))
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if not trace:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cell.end_to_end()}
    else:
        # on the CPU only the host-clock metrics have something to read
        host = {m["name"] for m in cell.per_layer()
                if m["source"] == "host_clock"}
        assert set(line["metrics"]) == host
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])


def test_non_finite_check_reads_as_text(run_module, tiny_cell):
    run = run_module.execute(tiny_cell("ml20m-explicit.score-all"), 3, 0.2,
                             False, "cpu")
    run.checks = [("rank_gap", math.inf, 1e-5)]
    line = run_module.result_line(run, "cpu", None)
    assert line["correct"] is False
    assert line["checks"]["rank_gap"] == {"value": "inf", "limit": 1e-5}
    json.loads(json.dumps(line, allow_nan=False))


def test_forbidden_names_compare_whole_top_levels():
    assert env.forbidden_modules(["predictionio_tpu_torch",
                                  "predictionio_tpu_torch.models.als",
                                  "jaxtyping", "flaxen.x"]) == []
    assert env.forbidden_modules(["predictionio_tpu.models", "jaxlib.xla",
                                  "jax", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "predictionio_tpu"]


IMPORTS = """
import sys, json
sys.path.insert(0, {root!r})
from portbench.harness import registry, env
{body}
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""


def _tops(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", IMPORTS.format(root=str(registry.ROOT),
                                              body=body)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    tops = _tops(
        "from portbench.tests.conftest import tiny\n"
        "env.set_cache_env()\n"
        "run = registry.load_module(registry.BENCH / 'run.py', 'r')\n"
        "bench = registry.load_benchmark()\n"
        "for name in [w['name'] for w in bench['workloads']]:\n"
        "    run.execute(tiny(registry.Cell(bench, name)), 5, 0.2, True,"
        " 'cpu')\n"
        "assert env.forbidden_modules() == [], env.forbidden_modules()\n")
    assert "predictionio_tpu_torch" in tops
    assert not tops & set(env.FORBIDDEN)


def test_the_references_load_nothing_of_the_program():
    tops = _tops(
        "for p in sorted((registry.BENCH / 'reference').glob('*.py')):\n"
        "    registry.load_module(p, 'ref_' + p.stem)\n")
    assert not tops & (set(env.FORBIDDEN) | {"predictionio_tpu_torch"})

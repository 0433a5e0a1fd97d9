"""BENCHMARK.json holds to the contract's shape, and the harness finds
every cell's pieces by name; a dummy cell, configuration, mix and metric
run from new files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_entry_keys(bench):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for part, want in keys.items():
        names = [e["name"] for e in bench[part]]
        assert len(names) == len(set(names)), part
        for e in bench[part]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for text in ("why", "layer"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200
                    assert "\n" not in e[text] and "\t" not in e[text]
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_bounds_and_metric_wiring(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell = registry.Cell(bench, w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end()}


def test_every_cell_reports_enough(bench):
    used = set()
    for w in bench["workloads"]:
        cell = registry.Cell(bench, w["name"])
        used.add(w["config"])
        names = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer()
    assert used == {c["name"] for c in bench["configs"]}
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_each_piece_is_found_by_name(bench):
    for w in bench["workloads"]:
        cell = registry.Cell(bench, w["name"])
        loop = cell.loop()
        for fn in ("setup", "window", "check"):
            assert callable(getattr(loop, fn))
        assert cell.limits
        assert cell.config["name"] == w["config"]
        assert registry.reference(cell.config["reference"])
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]).read)
    for k in ("fused_gram", "chol_solve", "fused_topk"):
        assert registry.roofline(k).KERNELS
    for c in bench["configs"]:
        path = registry.ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")


DUMMY_METRIC = '''
def read(run):
    return 42.0
'''


def test_a_dummy_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark gets a new configuration, traffic mix,
    limits file and per-layer metric as new files and new entries, and a
    cell of them runs (on the CPU, tiny) with the metric in its line."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = registry.load_benchmark()
    cfg = json.loads((registry.ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy-config"
    cfg["dataset"] = {"generator": "ml20m_surrogate", "scale": 0.006,
                      "seed": 0, "n_users": 300, "n_items": 90}
    cfg["algorithm"]["rank"] = 8
    (root / "portbench/configs/dummy-config.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/dummy-mix.json").write_text(json.dumps(
        {"loop": "score", "kernels": ["fused_topk"], "flush_users": 64,
         "num": 5, "in_flight": 3, "check_flushes": 2}))
    (root / "portbench/limits/dummy.cell.json").write_text(json.dumps(
        {"limits": {"rank_gap": 1e-5, "score_err": 1e-5}}))
    (root / "portbench/metrics/dummy_metric.json_free.py").write_text(
        DUMMY_METRIC)
    bench["configs"].append({"name": "dummy-config", "source": "x",
                             "file": "portbench/configs/dummy-config.json",
                             "reduced": [], "why": "a dummy"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1,
                               "why": "a dummy"})
    bench["end_to_end"][1]["workloads"].append("dummy.cell")
    bench["per_layer"].append({
        "name": "dummy_metric.json_free", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "dummy", "moves":
        "score_users_per_s", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {str(registry.ROOT)!r}]\n"
        "from portbench.harness import registry, env\n"
        "assert registry.ROOT == __import__('pathlib').Path(sys.path[0])\n"
        "env.set_cache_env()\n"
        "run = registry.load_module(registry.BENCH / 'run.py', 'r')\n"
        "cell = registry.Cell(registry.load_benchmark(), 'dummy.cell')\n"
        "for trace in (False, True):\n"
        "    res = run.execute(cell, 7, 0.3, trace, 'cpu')\n"
        "    print(json.dumps(run.result_line(res, 'cpu', None)))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(x) for x in out.stdout.splitlines()[-2:]]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"score_users_per_s", "setup_s"}
    assert traced["metrics"]["dummy_metric.json_free"]["value"] == 42.0


@pytest.mark.parametrize("name", ["ml20m-explicit.train",
                                  "ml20m-implicit.train",
                                  "ml20m-explicit.score-all"])
def test_configs_state_what_they_run(bench, name):
    cell = registry.Cell(bench, name)
    cfg = cell.config
    assert cfg["algorithm"]["rank"] == 64
    assert cfg["precision"] == "float32"
    assert cfg["dataset"]["n_ratings"] == 20_000_263
    assert cell.config_entry["reduced"] == []
    assert "control" in cfg

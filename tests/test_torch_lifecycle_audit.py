"""The port's ``audit-lifecycle`` (``analysis/lifecycle_audit.py``) held
to the JAX package's: the /proc snapshot, the leak and settle steps, the
manifest's bytes and its ratchet, the diff and the text report on the
same inputs; each of the six entries cycled on the CPU with a zero
census; the deliberately leaky fixture caught by both the static
``leaked-thread`` rule and the runtime gate; and the CLI contract of the
JAX package's ``tests/test_lifecycle_audit.py``, with ``--device cpu``.
"""

import json
import threading
import time

import pytest

from predictionio_tpu.analysis import lifecycle_audit as jla
from predictionio_tpu_torch.analysis import check_source
from predictionio_tpu_torch.analysis import lifecycle_audit as la
from predictionio_tpu_torch.cli import main


def _manifest(cycles=3, **entries):
    return {"version": la.MANIFEST_VERSION, "cycles": cycles,
            "entries": {name: {"threads": rec[0], "fds": rec[1],
                               "sockets": rec[2]}
                        for name, rec in entries.items()}}


def test_the_constants_are_the_jax_packages():
    assert la.RESOURCES == jla.RESOURCES
    assert la.MANIFEST_VERSION == jla.MANIFEST_VERSION
    assert la.DEFAULT_CYCLES == jla.DEFAULT_CYCLES
    assert la.SETTLE_SEC == jla.SETTLE_SEC
    assert list(la.ENTRY_POINTS) == list(jla.ENTRY_POINTS)
    assert [d for _, d in la.ENTRY_POINTS.values()] \
        == [d for _, d in jla.ENTRY_POINTS.values()]


def test_snapshot_counts_what_the_jax_packages_counts():
    for _ in range(5):  # a thread of the runner may come or go between
        a, b, c = jla.snapshot(), la.snapshot(), jla.snapshot()
        if a == c:
            break
    assert set(b) == set(la.RESOURCES)
    assert b == a == c
    assert b["threads"] >= 1


def test_a_spawned_thread_is_visible():
    before = la.snapshot()
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    try:
        assert la.snapshot()["threads"] >= before["threads"] + 1
    finally:
        stop.set()
        t.join(timeout=5.0)


@pytest.mark.parametrize("before,after", [
    ({"threads": 5, "fds": 10, "sockets": 2},
     {"threads": 7, "fds": 8, "sockets": 2}),
    ({"threads": 1, "fds": 1, "sockets": 1}, {"threads": 1}),
    ({}, {"threads": 3, "fds": 4, "sockets": 5}),
])
def test_leak_is_the_jax_packages(before, after):
    assert la._leak(before, after) == jla._leak(before, after)


def test_settle_absorbs_a_thread_mid_exit():
    before = la.snapshot()
    t = threading.Thread(target=lambda: time.sleep(0.2), daemon=True)
    t.start()
    after = la._settle(before, settle_sec=5.0)
    assert not any(la._leak(before, after).values())
    # and both settle to the same census once nothing moves
    assert la._settle(before, 0.2) == jla._settle(before, 0.2)


MANIFESTS = {
    "clean": _manifest(a=(0, 0, 0), b=(0, 0, 0)),
    "leaky": _manifest(clean=(0, 0, 0), leaky=(2, 0, 1)),
    "one-cycle": _manifest(cycles=1, a=(3, 1, 0)),
}


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_manifests_are_byte_equal_and_cross_read(name, tmp_path):
    m = MANIFESTS[name]
    p, j = tmp_path / "port.json", tmp_path / "jax.json"
    la.write_manifest(str(p), m)
    jla.write_manifest(str(j), m)
    assert p.read_bytes() == j.read_bytes()
    assert la.load_manifest(str(j)) == jla.load_manifest(str(p)) == m


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_the_capped_write_is_the_jax_packages(name, tmp_path):
    cap = _manifest(a=(2, 1, 0), leaky=(1, 0, 0))
    p, j = tmp_path / "port.json", tmp_path / "jax.json"
    la.write_manifest(str(p), MANIFESTS[name], cap=cap)
    jla.write_manifest(str(j), MANIFESTS[name], cap=cap)
    assert p.read_bytes() == j.read_bytes()


def test_load_rejects_a_wrong_version(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"version": 99, "entries": {}}))
    with pytest.raises(ValueError):
        la.load_manifest(str(path))


@pytest.mark.parametrize("current,base", [
    (_manifest(a=(3, 0, 0)), _manifest(a=(0, 0, 0))),
    (_manifest(new_entry=(0, 0, 0)), _manifest()),
    (_manifest(a=(0, 0, 0)), _manifest(a=(2, 0, 0))),
    (_manifest(cycles=0, a=(1, 2, 3)), _manifest(a=(0, 0, 0), b=(1, 1, 1))),
])
def test_diff_is_the_jax_packages(current, base):
    assert la.diff_manifests(current, base) \
        == jla.diff_manifests(current, base)


@pytest.mark.parametrize("name", sorted(MANIFESTS))
def test_format_text_is_the_jax_packages(name):
    assert la.format_text(MANIFESTS[name]) \
        == jla.format_text(MANIFESTS[name])


def test_the_committed_baseline_is_all_zeros_and_the_jax_packages():
    doc = la.load_manifest(la.DEFAULT_BASELINE)
    assert set(doc["entries"]) == set(la.ENTRY_POINTS)
    assert all(v == 0 for rec in doc["entries"].values()
               for v in rec.values())
    with open(la.DEFAULT_BASELINE, "rb") as p, \
            open(jla.DEFAULT_BASELINE, "rb") as j:
        assert p.read() == j.read()


class TestRunAudit:
    def test_an_injected_clean_entry_gets_the_device(self):
        seen = []

        def build(device):
            seen.append(device)
            return lambda: None

        m = la.run_audit(entry_points={"noop": (build, "does nothing")},
                         cycles=2, settle_sec=0.2, device="cpu")
        assert m["cycles"] == 2
        assert m["entries"]["noop"] == {"threads": 0, "fds": 0,
                                        "sockets": 0}
        assert [str(d) for d in seen] == ["cpu"]

    def test_an_unknown_entry_raises(self):
        with pytest.raises(la.AuditError, match="unknown entry"):
            la.run_audit(["nope"], entry_points={"a": (None, "")},
                         device="cpu")

    def test_a_broken_setup_is_an_environment_error(self):
        def boom(device):
            raise RuntimeError("no storage")

        with pytest.raises(la.AuditError, match="entry setup failed"):
            la.run_audit(entry_points={"a": (boom, "")}, settle_sec=0.2,
                         device="cpu")

    def test_no_card_raises_unless_the_cpu_is_asked_for(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(la.AuditError, match="CUDA is not available"):
            la.run_audit(entry_points={"a": (lambda d: lambda: None, "")})


@pytest.mark.parametrize("name", list(la.ENTRY_POINTS))
def test_each_entry_cycles_clean_on_the_cpu(name):
    m = la.run_audit([name], cycles=1, settle_sec=2.0, device="cpu")
    assert m["entries"] == {name: {"threads": 0, "fds": 0, "sockets": 0}}


#: the acceptance fixture: a scrape daemon whose handle nobody joins,
#: judged by the static rule and by the runtime gate
LEAKY_SRC = '''
import threading
import time


class LeakyPoller:
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        pass  # the bug: no stop event, no join

    def _run(self):
        while True:
            time.sleep(0.05)
'''


class TestLeakedFixtureFailsBothGates:
    def test_the_static_rule_flags_the_fixture(self):
        findings = check_source(
            LEAKY_SRC, path="predictionio_tpu_torch/server/leaky.py")
        assert [f.rule for f in findings] == ["leaked-thread"]

    def test_the_runtime_gate_counts_the_leak(self):
        ns: dict = {}
        exec(LEAKY_SRC, ns)
        poller_cls = ns["LeakyPoller"]

        def build(device):
            def cycle():
                p = poller_cls()
                p.start()
                p.stop()

            return cycle

        m = la.run_audit(
            entry_points={"leaky": (build, "leaks 1 thread/cycle")},
            cycles=3, settle_sec=0.3, device="cpu")
        assert m["entries"]["leaky"]["threads"] >= 3
        violations, _ = la.diff_manifests(m, _manifest(leaky=(0, 0, 0)))
        assert any("leaky" in v and "threads" in v for v in violations)


class TestCLI:
    def test_list_entries(self, capsys):
        assert main(["audit-lifecycle", "--list-entries"]) == 0
        out = capsys.readouterr().out
        for name in la.ENTRY_POINTS:
            assert name in out

    def test_an_unknown_entry_is_an_environment_error(self):
        assert main(["audit-lifecycle", "--entry", "nope",
                     "--device", "cpu"]) == 2

    def test_no_card_is_an_environment_error(self, capsys):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is present")
        assert main(["audit-lifecycle", "--entry", "storage_server",
                     "--cycles", "1"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err

    def test_no_baseline_skips_the_gate(self, tmp_path, capsys):
        rc = main(["audit-lifecycle", "--entry", "storage_server",
                   "--cycles", "1", "--device", "cpu",
                   "--baseline", str(tmp_path / "none.json")])
        assert rc == 0
        assert "gate skipped" in capsys.readouterr().err

    def test_write_then_gate_green(self, tmp_path, capsys):
        path = str(tmp_path / "b.json")
        assert main(["audit-lifecycle", "--entry", "storage_server",
                     "--cycles", "1", "--device", "cpu",
                     "--baseline", path, "--write-baseline"]) == 0
        doc = la.load_manifest(path)
        assert "storage_server" in doc["entries"]
        rc = main(["audit-lifecycle", "--entry", "storage_server",
                   "--cycles", "1", "--device", "cpu",
                   "--baseline", path,
                   "--out", str(tmp_path / "artifact.json")])
        assert rc == 0
        assert "released its threads" in capsys.readouterr().err
        artifact = json.loads((tmp_path / "artifact.json").read_text())
        assert artifact["version"] == la.MANIFEST_VERSION

    def test_an_entry_missing_from_the_baseline_fails(self, tmp_path,
                                                      capsys):
        path = tmp_path / "b.json"
        path.write_text(json.dumps(
            {"version": la.MANIFEST_VERSION, "cycles": 1,
             "entries": {}}))
        rc = main(["audit-lifecycle", "--entry", "storage_server",
                   "--cycles", "1", "--device", "cpu",
                   "--baseline", str(path)])
        assert rc == 1
        assert "not in the baseline" in capsys.readouterr().err

    def test_json_format_is_the_manifest(self, capsys):
        assert main(["audit-lifecycle", "--entry", "fleet", "--cycles",
                     "1", "--device", "cpu", "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["entries"] == {"fleet": {"threads": 0, "fds": 0,
                                            "sockets": 0}}

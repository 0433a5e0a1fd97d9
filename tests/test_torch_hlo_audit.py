"""The port's collective census, ``audit-hlo``
(``predictionio_tpu_torch/analysis/hlo_audit.py`` and the recorder of
``parallel/collectives.py``), held to the JAX package's
(``predictionio_tpu/analysis/hlo_audit.py``).

Each class of the JAX package's ``tests/test_hlo_audit.py`` has its
counterpart here: the recorder's counts and shapes (``TestParseCollectives``:
the port has calls, not HLO text), the golden counts of ``gramian_allreduce``
and ``sharded_rank``, ``diff_manifests`` and ``write_manifest`` of both
packages fed the same manifests, the committed ``cpu`` section against a
live run, the seeded fault (a sharded table made whole through
``unshard_table``) failing with its join named, and the CLI. Then what the
port adds: the joins between mesh positions, the peak of live bytes, and
two gloo ranks recording the one-process mesh's census.
"""

import copy
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.analysis import hlo_audit as jha
from predictionio_tpu_torch.analysis import hlo_audit as ha
from predictionio_tpu_torch.cli import main
from predictionio_tpu_torch.parallel import collectives as pc
from predictionio_tpu_torch.parallel.collectives import (
    record_collectives,
    tag_position,
)
from predictionio_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def mesh_of(data=8, model=1):
    return make_mesh(data=data, model=model, devices=[CPU] * (data * model))


def blocks(n=8, rows=2, cols=3):
    return [torch.full((rows, cols), float(p)) for p in range(n)]


# -- the recorder (the JAX package's TestParseCollectives) ---------------------

RECORDED = {
    "all_reduce_sum": (
        lambda m: pc.all_reduce_sum(blocks(), axis=None, mesh=m),
        "all-reduce", ["f32[2,3]"]),
    "gramian_allreduce": (
        lambda m: pc.gramian_allreduce(blocks(), mesh=m),
        "all-reduce", ["f32[3,3]"]),
    "all_gather": (
        lambda m: pc.all_gather(blocks(), axis=None, mesh=m),
        "all-gather", ["f32[16,3]"]),
    "all_gather_stacked": (
        lambda m: pc.all_gather(blocks(), axis=None, mesh=m, tiled=False),
        "all-gather", ["f32[8,2,3]"]),
    "reduce_scatter": (
        lambda m: pc.reduce_scatter(blocks(rows=8), axis=None, mesh=m),
        "reduce-scatter", ["f32[1,3]"]),
    "ring_permute": (
        lambda m: pc.ring_permute(blocks(), axis="data", mesh=m),
        "collective-permute", ["f32[2,3]"]),
    "sharded": (
        lambda m: pc.sharded(m, in_specs=("data",), out_specs=("data",))(
            lambda xs: [x * 2 for x in xs])(torch.ones(16, 3)),
        "all-gather", ["f32[16,3]"]),
    "merge_candidates": (
        lambda m: pc.merge_candidates(
            [torch.rand(4, 8) for _ in range(4)],
            [torch.arange(8).repeat(4, 1) + 8 * s for s in range(4)], 8),
        "all-gather", ["f32[4,32]", "s32[4,32]"]),
}


@pytest.mark.parametrize("case", sorted(RECORDED))
def test_each_collective_records_its_hlo_op_and_result_shape(case):
    call, op, shapes = RECORDED[case]
    mesh = mesh_of()
    with record_collectives() as rec:
        call(mesh)
    assert rec.counts() == {op: len(shapes)}
    assert rec.shapes() == {op: shapes}


def test_a_collective_called_by_another_records_once():
    # gramian_allreduce calls all_reduce_sum; sharded_top_k's only
    # collective is its merge's two all-gathers
    mesh = mesh_of()
    with record_collectives() as rec:
        pc.gramian_allreduce(blocks(), mesh=mesh)
        pc.sharded_top_k(torch.rand(4, 64), 8, mesh_of(2, 4), axis="model")
    assert rec.records == [("all-reduce", "f32[3,3]"),
                           ("all-gather", "f32[4,32]"),
                           ("all-gather", "s32[4,32]")]


def test_a_replicated_out_spec_is_no_collective():
    mesh = mesh_of()
    with record_collectives() as rec:
        pc.sharded(mesh, in_specs=(), out_specs=())(
            lambda xs: [x + 1 for x in xs])(torch.ones(4))
    assert rec.records == []


def test_only_the_opening_thread_is_recorded():
    mesh = mesh_of()
    with record_collectives() as rec:
        t = threading.Thread(target=lambda: pc.all_gather(
            blocks(), axis=None, mesh=mesh))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert rec.records == []
        pc.all_gather(blocks(), axis=None, mesh=mesh)
    assert rec.counts() == {"all-gather": 1}


def test_off_by_default_and_one_recorder_at_a_time():
    assert pc._recorder is None
    with record_collectives():
        with pytest.raises(RuntimeError, match="already on"):
            with record_collectives():
                pass
    assert pc._recorder is None
    # off, a tag is a no-op and a collective records nothing
    x = torch.ones(3)
    assert tag_position(x, 2) is x


@pytest.mark.parametrize("dtype,name", [
    (torch.float32, "f32[2,3]"), (torch.int32, "s32[2,3]"),
    (torch.int64, "s64[2,3]"), (torch.bfloat16, "bf16[2,3]"),
    (torch.int8, "s8[2,3]"), (torch.bool, "pred[2,3]")])
def test_hlo_shapes(dtype, name):
    assert pc.hlo_shape(torch.zeros((2, 3), dtype=dtype)) == name
    assert pc.hlo_shape(torch.zeros((), dtype=torch.float32)) == "f32[]"


def test_positions_are_kept_by_byte_range_of_a_storage():
    whole = torch.arange(16.0)
    with record_collectives(positions=True) as rec:
        tag_position(whole[:8], 0)
        tag_position(whole[8:], 1)
        place = rec.placement
        assert place.of(whole[2:5]) == {0}
        assert place.of(whole[8:]) == {1}
        assert place.of(whole) == {0, 1}
        assert place.of(torch.arange(16.0)) == frozenset()
        tag_position(whole, 3)  # a re-cut replaces what it covers
        assert place.of(whole[:8]) == {3}


# -- joins and temp bytes -------------------------------------------------------

def _census(run):
    return ha.census(lambda dev: run, CPU)


def test_an_op_mixing_two_positions_is_a_join():
    a, b = torch.ones(4, 2), torch.ones(4, 2)

    def setup(dev):
        tag_position(a, 0)
        tag_position(b, 1)
        return lambda: torch.cat([a, b]) + 1
    rec = ha.census(setup, CPU)
    # the cat joins; the add reads the joined result: a join too
    assert rec["joins"] == {"aten.cat": ["f32[8,2]"],
                            "aten.add": ["f32[8,2]"]}
    assert rec["collectives"] == {}


def test_a_view_and_one_positions_ops_are_no_join():
    x = torch.ones(8, 2)

    def setup(dev):
        tag_position(x[:4], 0)
        tag_position(x[4:], 1)
        return lambda: (x.t(), x[:4] * 2, x[4:].sum())
    assert ha.census(setup, CPU)["joins"] == {}


def test_a_collectives_ops_are_no_join_and_its_result_has_no_position():
    mesh = mesh_of()
    shards = blocks()

    def setup(dev):
        for p, s in enumerate(shards):
            tag_position(s, p)

        def run():
            gathered = pc.all_gather(shards, axis=None, mesh=mesh)
            return [g.sum() + s for g, s in zip(gathered, shards)]
        return run
    rec = ha.census(setup, CPU)
    assert rec["joins"] == {}
    assert rec["collectives"] == {"all-gather": 1}


def _row_sources():
    src = [torch.full((1, 3), float(p)) for p in range(3)]
    for p, s in enumerate(src):
        tag_position(s, p)
    return src


def test_an_indexed_write_from_a_second_position_is_a_join():
    # _user_vecs' pattern: rows of several shards scattered into one
    # result by index, each write reading the whole result
    def setup(dev):
        src = _row_sources()

        def run():
            out = torch.empty(3, 3)
            for p, s in enumerate(src):
                out[torch.tensor([p])] = s
            return out
        return run
    joins = ha.census(setup, CPU)["joins"]
    assert joins == {"aten.index_put_": ["f32[3,3]"] * 2}


def test_blocks_side_by_side_join_only_when_read_across():
    # a write into a row of its own is no move; reading the rows of two
    # positions together is
    def setup(dev):
        src = _row_sources()

        def run():
            out = torch.empty(3, 3)
            for p, s in enumerate(src):
                out[p] = s[0]
            return out[1:].sum()
        return run
    assert ha.census(setup, CPU)["joins"] == {"aten.sum": ["f32[]"]}


def test_temp_bytes_is_the_peak_of_live_bytes():
    def run():
        a = torch.zeros(1024)
        del a
        b = torch.zeros(512)
        c = torch.zeros(256)
        return b, c
    assert _census(run)["temp_bytes"] == 4096
    assert _census(lambda: None)["temp_bytes"] == 0


def test_the_setups_collectives_are_not_the_entrys():
    mesh = mesh_of()

    def setup(dev):
        pc.all_gather(blocks(), axis=None, mesh=mesh)
        return lambda: pc.all_reduce_sum(blocks(), axis=None, mesh=mesh)
    assert ha.census(setup, CPU)["collectives"] == {"all-reduce": 1}


# -- golden counts (TestGoldenCollectiveCounts) --------------------------------

@pytest.fixture(scope="module")
def live_cpu(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "hlo.json"
    assert main(["audit-hlo", "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def test_gramian_allreduce_is_one_all_reduce(live_cpu):
    rec = live_cpu["entries"]["gramian_allreduce"]
    assert rec["collectives"] == {"all-reduce": 1}
    assert rec["collective_shapes"] == {"all-reduce": ["f32[16,16]"]}
    assert rec["joins"] == {}


def test_sharded_rank_is_two_all_gathers_and_no_join(live_cpu):
    rec = live_cpu["entries"]["sharded_rank"]
    assert rec["collectives"] == {"all-gather": 2}
    assert rec["joins"] == {}
    # the JAX package's own shapes: B x k_local * n_shards candidates
    with open(jha.DEFAULT_BASELINE, encoding="utf-8") as fh:
        jrec = json.load(fh)["entries"]["sharded_rank"]
    assert rec["collective_shapes"]["all-gather"] == [
        s.split("{")[0] for s in jrec["collective_shapes"]["all-gather"]]


def test_gather_rows_is_a_join_of_the_row_writes(live_cpu):
    rec = live_cpu["entries"]["gather_rows"]
    assert rec["collectives"] == {}
    # rows 0, 9, 27, 63 of 8 shards of 8: four owners, three joining
    # writes into the [4, 16] result
    assert rec["joins"] == {"aten.index_put_": ["f32[4,16]"] * 3}


@pytest.mark.parametrize("entry", ["lhs_einsum", "lhs_fused",
                                   "train_update_block"])
def test_a_half_step_is_one_all_gather_and_its_rebuild_no_join(live_cpu,
                                                                entry):
    rec = live_cpu["entries"][entry]
    assert rec["collective_shapes"] == {"all-gather": ["f32[64,16]"]}
    assert rec["joins"] == {}


# -- diff and write: both packages fed the same manifests (TestRunAuditAndDiff)

def _synthetic():
    """Two entries of the JAX package's committed manifest."""
    with open(jha.DEFAULT_BASELINE, encoding="utf-8") as fh:
        doc = json.load(fh)
    return {"version": 1, "devices": 8, "entries": {
        k: doc["entries"][k] for k in ("gramian_allreduce", "gather_rows")}}


def _itself(m):
    return m, m


def _new_op(m):
    base = copy.deepcopy(m)
    del base["entries"]["gramian_allreduce"]["collectives"]["all-reduce"]
    return m, base


def _grown_count(m):
    cur = copy.deepcopy(m)
    cur["entries"]["gather_rows"]["collectives"]["all-reduce"] = 3
    return cur, m


def _grown_temp(m):
    cur = copy.deepcopy(m)
    rec = cur["entries"]["gather_rows"]
    rec["temp_bytes"] = int(rec["temp_bytes"] * jha.TEMP_GROWTH_RATIO
                            + jha.TEMP_SLACK_BYTES + 4096)
    return cur, m


def _unknown_entry(m):
    cur = copy.deepcopy(m)
    cur["entries"]["rogue"] = {"collectives": {}, "temp_bytes": 0}
    return cur, m


def _shrink(m):
    cur = copy.deepcopy(m)
    del cur["entries"]["gramian_allreduce"]["collectives"]["all-reduce"]
    return cur, m


def _device_mismatch(m):
    base = copy.deepcopy(m)
    base["devices"] = 4
    return m, base


DIFF_CASES = {
    "test_identical_manifests_pass": (_itself, 0),
    "test_new_collective_fails_with_op_named": (_new_op, 1),
    "test_grown_count_fails": (_grown_count, 1),
    "test_grown_temp_fails": (_grown_temp, 1),
    "test_unknown_entry_point_fails": (_unknown_entry, 1),
    "test_shrink_reported_not_failed": (_shrink, 0),
    "test_device_count_mismatch_fails": (_device_mismatch, 1),
}


def _head(violation):
    """What a violation names (entry, op, counts), without the advice
    each package words its own way."""
    return violation.split(" — ")[0]


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_manifests_agrees_with_the_jax_package(case):
    make, n_violations = DIFF_CASES[case]
    current, baseline = make(_synthetic())
    jv, js = jha.diff_manifests(current, baseline)
    pv, ps = ha.diff_manifests(current, baseline)
    assert len(jv) == n_violations
    assert [_head(v) for v in pv] == [_head(v) for v in jv]
    assert ps == js


def _with_joins(m):
    out = copy.deepcopy(m)
    out["entries"]["gather_rows"]["joins"] = {
        "aten.index_put_": ["f32[4,16]"] * 3}
    return out


@pytest.mark.parametrize("joins,violated,shrunk", [
    ({"aten.index_put_": ["f32[4,16]"] * 3}, False, False),
    ({"aten.index_put_": ["f32[4,16]"] * 4}, True, False),
    ({"aten.index_put_": ["f32[4,16]"] * 3, "aten.cat": ["f32[64,16]"]},
     True, False),
    ({"aten.index_put_": ["f32[4,16]"]}, False, True),
    ({}, False, True)],
    ids=["equal", "grown", "new", "fewer", "gone"])
def test_joins_are_gated_as_collectives(joins, violated, shrunk):
    base = _with_joins(_synthetic())
    cur = copy.deepcopy(base)
    cur["entries"]["gather_rows"]["joins"] = joins
    violations, shrinkable = ha.diff_manifests(cur, base)
    assert bool(violations) is violated
    assert any("join" in s for s in shrinkable) is shrunk
    for v in violations:
        assert v.startswith("gather_rows: join aten.")
        assert "shapes [" in v


def _jax_view(doc):
    return {name: {k: v for k, v in rec.items() if k != "joins"}
            for name, rec in doc["entries"].items()}


@pytest.mark.parametrize("grow", [False, True],
                         ids=["test_write_ratchets_never_absorbs",
                              "test_baseline_grow_writes_as_is"])
def test_write_manifest_agrees_with_the_jax_package(grow, tmp_path):
    m = _with_joins(_synthetic())
    for rec in m["entries"].values():
        rec.setdefault("joins", {})
    grown = copy.deepcopy(m)
    grown["entries"]["gramian_allreduce"]["collectives"]["all-to-all"] = 3
    grown["entries"]["gramian_allreduce"]["collective_shapes"][
        "all-to-all"] = ["f32[8]"] * 3
    grown["entries"]["gather_rows"]["joins"]["aten.index_put_"].append(
        "f32[4,16]")
    grown["entries"]["gather_rows"]["joins"]["aten.cat"] = ["f32[64,16]"]
    grown["entries"]["extra_entry"] = copy.deepcopy(
        m["entries"]["gather_rows"])
    cap = None if grow else m
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jha.write_manifest(jpath, grown, cap=cap)
    ha.write_manifest(ppath, {**grown, "version": ha.MANIFEST_VERSION,
                              "platform": "cpu"}, cap=cap)
    jdoc = jha.load_manifest(jpath)
    pdoc = ha.section(ha.load_manifest(ppath), "cpu")
    assert _jax_view(pdoc) == _jax_view(jdoc)
    assert ("extra_entry" in pdoc["entries"]) is grow
    joins = pdoc["entries"]["gather_rows"]["joins"]
    assert joins == (grown if grow else m)["entries"]["gather_rows"]["joins"]


def test_write_keeps_the_other_platforms_section(tmp_path):
    path = str(tmp_path / "b.json")
    m = _synthetic()
    ha.write_manifest(path, {**m, "platform": "cuda"})
    ha.write_manifest(path, {**m, "platform": "cpu", "devices": 4})
    doc = ha.load_manifest(path)
    assert ha.section(doc, "cuda")["devices"] == 8
    assert ha.section(doc, "cpu")["devices"] == 4


@pytest.mark.parametrize("version", [99, 1])
def test_load_rejects_wrong_version(version, tmp_path):
    p = tmp_path / "v.json"
    p.write_text(json.dumps({"version": version, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        ha.load_manifest(str(p))


# -- the committed baseline against a live run ---------------------------------

def test_the_committed_cpu_section_equals_a_live_run(live_cpu):
    committed = ha.section(ha.load_manifest(ha.DEFAULT_BASELINE), "cpu")
    assert live_cpu["devices"] == committed["devices"] \
        == ha.AUDIT_DEVICE_COUNT
    assert live_cpu["entries"] == committed["entries"]
    assert ha.diff_manifests(live_cpu, committed) == ([], [])


def test_every_jax_entry_is_audited(live_cpu):
    assert list(ha.ENTRY_POINTS) == list(jha.ENTRY_POINTS)
    assert set(live_cpu["entries"]) == set(jha.ENTRY_POINTS)


def test_the_committed_cuda_section_has_the_cpu_sections_structure():
    doc = ha.load_manifest(ha.DEFAULT_BASELINE)
    cuda, cpu = ha.section(doc, "cuda"), ha.section(doc, "cpu")
    assert cuda is not None and cuda["devices"] == ha.AUDIT_DEVICE_COUNT
    assert ha.structure(cuda) == ha.structure(cpu)


# -- the seeded fault (TestMisSpeccedFixtureFailsCI) ---------------------------

def test_a_sharded_table_made_whole_fails_with_the_join_named():
    from predictionio_tpu_torch.analysis.numerics_audit import (
        _forced_devices,
    )

    with _forced_devices(ha.AUDIT_DEVICE_COUNT):
        rec = ha.census(ha.seeded_unshard, CPU)
    assert rec["joins"]["aten.cat"] == ["f32[64,16]"]
    committed = ha.section(ha.load_manifest(ha.DEFAULT_BASELINE), "cpu")
    current = {**committed, "entries": {"sharded_rank": rec}}
    violations, _ = ha.diff_manifests(current, committed)
    assert any(v.startswith("sharded_rank: join aten.cat x1 (baseline 0)")
               for v in violations), violations


# -- the CLI (TestAuditCLI) ------------------------------------------------------

def test_without_cuda_and_without_device_cpu_the_command_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["audit-hlo", "--entry", "gramian_allreduce"])


def test_list_entries(capsys):
    assert main(["audit-hlo", "--list-entries"]) == 0
    out = capsys.readouterr().out
    assert "gramian_allreduce" in out and "sharded_rank" in out


def test_unknown_entry_exits_2():
    assert main(["audit-hlo", "--entry", "nope", "--device", "cpu"]) == 2


def test_subset_against_committed_baseline(capsys, tmp_path):
    artifact = tmp_path / "audit.json"
    assert main(["audit-hlo", "--entry", "gramian_allreduce", "--format",
                 "json", "--out", str(artifact), "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["entries"]["gramian_allreduce"]["collectives"] == \
        {"all-reduce": 1}
    assert artifact.exists()


def test_write_and_gate_roundtrip(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    args = ["audit-hlo", "--entry", "gather_rows", "--baseline", path,
            "--device", "cpu"]
    assert main(args + ["--write-baseline"]) == 0
    capsys.readouterr()
    assert main(args) == 0
    assert "join aten.index_put_ x3" in capsys.readouterr().out


def test_gate_fails_on_doctored_baseline(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    args = ["audit-hlo", "--entry", "gather_rows", "--entry",
            "sharded_rank", "--baseline", path, "--device", "cpu"]
    assert main(args + ["--write-baseline"]) == 0
    doc = ha.load_manifest(path)
    entries = doc["platforms"]["cpu"]["entries"]
    entries["gather_rows"]["joins"]["aten.index_put_"].pop()
    entries["sharded_rank"]["collectives"]["all-gather"] = 1
    Path(path).write_text(json.dumps(doc))
    capsys.readouterr()
    assert main(args) == 1
    err = capsys.readouterr().err
    assert "gather_rows: join aten.index_put_ x3 (baseline 2)" in err
    assert "sharded_rank: all-gather x2 (baseline 1)" in err


def test_a_growing_write_is_refused_without_baseline_grow(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    args = ["audit-hlo", "--entry", "gather_rows", "--baseline", path,
            "--device", "cpu"]
    assert main(args + ["--write-baseline"]) == 0
    doc = ha.load_manifest(path)
    doc["platforms"]["cpu"]["entries"]["gather_rows"]["joins"] = {}
    Path(path).write_text(json.dumps(doc))
    assert main(args + ["--write-baseline"]) == 1
    assert ha.load_manifest(path)["platforms"]["cpu"]["entries"][
        "gather_rows"]["joins"] == {}
    assert main(args + ["--write-baseline", "--baseline-grow"]) == 0
    assert main(args) == 0


# -- a process mesh records the one-process mesh's census ----------------------

WORKER = textwrap.dedent("""
    import json, os, sys

    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ["PTPU_TORCH_FORCE_DEVICE_COUNT"] = "4"
    from predictionio_tpu_torch.parallel import multihost
    multihost.initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                     backend="gloo")
    import torch
    from predictionio_tpu_torch.analysis import hlo_audit as ha
    from predictionio_tpu_torch.parallel.collectives import (
        record_collectives, ring_permute)

    mesh = multihost.global_mesh(data=8, device="cpu")
    assert mesh.ranks == (0,) * 4 + (1,) * 4

    def ring():
        mine = [torch.full((6,), float(p)) for p in mesh.local_positions()]
        return lambda: ring_permute(mine, "data", 1, mesh=mesh)

    makers = {"gramian_allreduce": lambda: ha.gramian_call(mesh, "cpu"),
              "seqrec_train_step": lambda: ha.seqrec_call(mesh, "cpu"),
              "ring_permute": ring}

    def counters():
        return {"staged": dict(multihost.HOST_STAGED),
                "received": dict(multihost.P2P_RECEIVED)}

    def moved(a, b):
        return {k: {n: b[k][n] - a[k][n] for n in a[k]} for k in a}

    out = {}
    for name, make in makers.items():
        c0 = counters()
        make()()
        c1 = counters()
        with record_collectives() as rec:
            make()()
        c2 = counters()
        out[name] = {"collectives": rec.counts(),
                     "collective_shapes": rec.shapes(),
                     "plain": moved(c0, c1), "recorded": moved(c1, c2)}
    json.dump(out, open(os.path.join(outdir, f"rank{pid}.json"), "w"))
    multihost.shutdown()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_record_the_one_process_census(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    env = {n: x for n, x in os.environ.items()
           if not n.startswith(("PIO_", "PTPU_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0].decode())
        except subprocess.TimeoutExpired:
            for x in procs:
                x.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-3000:]}"

    want = ha.structure(ha.run_audit(
        ["gramian_allreduce", "seqrec_train_step"], device="cpu"))
    with record_collectives() as rec:
        pc.ring_permute([torch.full((6,), float(p)) for p in range(8)],
                        "data", 1, mesh=mesh_of())
    want["ring_permute"] = {"collectives": rec.counts(),
                            "collective_shapes": rec.shapes()}
    for pid in range(2):
        got = json.loads((tmp_path / f"rank{pid}.json").read_text())
        for name, rec_ in got.items():
            assert rec_["collectives"] == want[name]["collectives"], name
            assert rec_["collective_shapes"] == \
                want[name]["collective_shapes"], name
            # the recorder leaves the transport's own counts as they are
            assert rec_["recorded"] == rec_["plain"], name
        assert got["ring_permute"]["plain"]["received"] == {
            "messages": 1, "bytes": 6 * 4}

"""Each kernel's counts against shapes worked by hand, the readers'
arithmetic on a made-up trace, and the trace reduction."""

import math
from types import SimpleNamespace

import pytest

from portbench.harness import peaks
from portbench.harness.registry import metric_reader, roofline
from portbench.harness.spans import Spans
from portbench.harness.trace import TraceSummary, reduce_trace, short_name

# the ML-20M surrogate: 20,000,263 ratings; 138,493 users and 25,385
# rated items solve a system each an iteration (163,878)
NNZ, USERS, ITEMS_RATED, R = 20_000_263, 138_493, 25_385, 64
PADDED_SLOTS = 58_173_432


def test_fused_gram_counts_by_hand():
    k = roofline("fused_gram")
    # 3 ratings at rank 2: each r^2 + 4r = 12 operations
    assert k.ops(3, 2) == 36
    # 5 table rows of 2 f32 read, 3 x 12 bytes of index and weights,
    # 4 rows of A (2 x 2) and b (2) written
    assert k.nbytes(3, rows_out=4, rows_read=5, rank=2) == 40 + 36 + 96
    # an ML-20M iteration: both half-steps over the real ratings
    ops = 2 * k.ops(NNZ, R)
    assert ops == 40_000_526 * 4_352 == 174_082_289_152
    assert math.isclose(ops / peaks.PEAK_OPS["f32"], 2.598243e-3,
                        rel_tol=1e-6)


def test_chol_solve_counts_by_hand():
    k = roofline("chol_solve")
    assert k.ops(1, 3) == pytest.approx(27 / 3 + 18)
    assert k.nbytes(1, 3) == (6 + 6) * 4
    n = USERS + ITEMS_RATED
    assert n == 163_878
    assert k.ops(n, R) == pytest.approx(n * 95_573.33, rel=1e-6)
    t, by = peaks.least_seconds(k.ops(n, R), k.nbytes(n, R), "f32")
    assert by == "bytes"
    assert t == pytest.approx(n * 2_208 * 4 / 3.35e12)


def test_fused_topk_counts_by_hand():
    k = roofline("fused_topk")
    assert k.ops(2, 3, 4) == 48
    # 2 rows of 4 f32, their ids, 2 x 16 (score, id) written; 3 item rows
    assert k.nbytes(2, 1, 3, 4, 16) == 2 * (16 + 4 + 128) + 48
    t, by = peaks.least_seconds(k.ops(1024, 26_744, R),
                                k.nbytes(1024, 1, 26_744, R, 16), "f32")
    assert by == "operations"
    assert t == pytest.approx(2 * 1024 * 26_744 * 64 / 67e12)


def _run(shape, op_seconds, window_s=1.0, busy_s=0.5, work=None,
         spans=None):
    summary = TraceSummary(window_s=window_s, busy_s=busy_s,
                           op_seconds=op_seconds, host=(10.0, 11.0))
    return SimpleNamespace(
        shape=shape, summary=summary,
        tracer=SimpleNamespace(work=work or {}), setup={},
        spans=spans or Spans(), window=(0.0, 100.0),
        traced_window=lambda: summary.host)


TRAIN_SHAPE = {"rank": R, "nnz": NNZ, "users_rated": USERS,
               "items_rated": ITEMS_RATED, "n_users": USERS,
               "n_items": 26_744, "implicit": False}


def test_gram_roofline_counts_real_slots_not_padded():
    # 10 iterations, fused_gram 150 ms of device time in all
    run = _run(TRAIN_SHAPE, {"void gram_rows_kernel<float>(...)": 0.140,
                             "sum_partials(...)": 0.010,
                             "chol_solve_regs<64>": 0.03},
               work={"iterations": 10})
    got = metric_reader("fused_gram_roofline.train").read(run)
    k = roofline("fused_gram")
    least = sum(max(k.ops(NNZ, R) / 67e12,
                    k.nbytes(NNZ, a, b, R) / 3.35e12)
                for a, b in ((USERS, ITEMS_RATED), (ITEMS_RATED, USERS)))
    assert got == pytest.approx(100 * least * 10 / 0.150)
    padded = 100 * PADDED_SLOTS * (R * R + 4 * R) / 67e12 * 10 / 0.150
    assert got < padded and got == pytest.approx(
        padded * 2 * NNZ / PADDED_SLOTS, rel=1e-3)


def test_train_readers_on_a_made_up_trace():
    ops = {"gram_rows_kernel": 0.15, "chol_solve_regs": 0.03,
           "elementwise_kernel": 0.02}
    run = _run(TRAIN_SHAPE, ops, window_s=0.25, busy_s=0.2,
               work={"iterations": 10})
    assert metric_reader("halfstep_other_ms.train").read(run) == \
        pytest.approx(2.0)
    assert metric_reader("device_idle_share.train").read(run) == \
        pytest.approx(20.0)
    flop = 2 * roofline("fused_gram").ops(NNZ, R) + \
        roofline("chol_solve").ops(USERS + ITEMS_RATED, R)
    assert metric_reader("mfu.train").read(run) == pytest.approx(
        100 * flop * 10 / 0.25 / 67e12)
    imp = dict(TRAIN_SHAPE, implicit=True)
    run_i = _run(imp, ops, window_s=0.25, busy_s=0.2,
                 work={"iterations": 10})
    extra = 2 * R * R * (USERS + 26_744) * 10 / 0.25 / 67e12 * 100
    assert metric_reader("mfu.train").read(run_i) == pytest.approx(
        metric_reader("mfu.train").read(run) + extra)


def test_span_readers_leave_out_the_traced_window():
    spans = Spans()
    spans.add("train.engine", 0.0, 0.30)
    spans.add("train.algorithm", 0.001, 0.299)
    spans.add("train.engine", 10.5, 10.9)      # inside the trace
    spans.add("train.algorithm", 10.6, 10.7)
    spans.add("train.algorithm", -5.0, -4.0)   # set-up's, before the window
    run = _run(TRAIN_SHAPE, {}, spans=spans)
    assert metric_reader("dase_ms.train").read(run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["fused_gram_roofline.train",
                                  "chol_solve_roofline.train", "mfu.train",
                                  "device_idle_share.train",
                                  "halfstep_other_ms.train",
                                  "fused_topk_roofline.score", "mfu.score",
                                  "device_idle_share.score"])
def test_readers_return_nothing_without_device_work(name):
    shape = dict(TRAIN_SHAPE, num=10, itemsize=4)
    work = {"iterations": 10, "users": 1024, "flushes": 1}
    # no device operation at all: busy 0, no kernel time
    assert metric_reader(name).read(
        _run(shape, {}, busy_s=0.0, work=work)) is None
    # no trace at all
    run = _run(shape, {}, work=work)
    run.summary = None
    assert metric_reader(name).read(run) is None


def test_score_readers():
    shape = {"rank": R, "n_items": 26_744, "n_users": USERS, "num": 10,
             "itemsize": 4}
    run = _run(shape, {"void fused_topk_kernel<float>(...)": 0.40,
                       "merge_topk_kernel": 0.05},
               window_s=1.0, busy_s=0.6,
               work={"users": 1_024_000, "flushes": 1000})
    k = roofline("fused_topk")
    least = max(k.ops(1_024_000, 26_744, R) / 67e12,
                k.nbytes(1_024_000, 1000, 26_744, R, 16) / 3.35e12)
    assert metric_reader("fused_topk_roofline.score").read(run) == \
        pytest.approx(100 * least / 0.45)
    assert metric_reader("mfu.score").read(run) == pytest.approx(
        100 * k.ops(1_024_000, 26_744, R) / 67e12)


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.window",
         "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "pb.score.dispatch",
         "ts": 100.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 105.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "void k1<float>(int)",
         "ts": 120.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "k2(x)", "ts": 130.0,
         "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 190.0,
         "dur": 20.0},
    ]
    s = reduce_trace(ev, (0.0, 1.0))
    assert s.window_s == pytest.approx(1e-4)
    # 120-150 and 190-200 (clipped at the window's end)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.seconds_of(("k1",)) == pytest.approx(20e-6)
    labels = dict((n, v) for n, v in s.breakdown["idle_gaps"])
    assert labels["pb.score.dispatch / aten::copy_"] == pytest.approx(20e-6)
    assert labels["- / (python)"] == pytest.approx(40e-6)
    assert [n for n, _ in s.breakdown["device_ops"]][:2] == ["k1<float>",
                                                            "k2"]
    assert short_name("void a<b<c>>(int, float)") == "a<b<c>>"
    assert short_name("void ns::(anonymous namespace)::k<64>(float*)") == \
        "ns::k<64>"
    assert reduce_trace(ev[1:], (0.0, 1.0)) is None

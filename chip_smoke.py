#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on the CUDA card and check it.

    python3 chip_smoke.py [--seed N]

Phases, each printing one line of numbers, any failure exits non-zero:

1. card   — CUDA must be present; prints ``nvidia-smi``'s name and power
            limit.
2. build  — compiles every ``predictionio_tpu_torch/csrc/*.cu`` with nvcc
            (all at once) into ``build/torch_kernels/``.
3. kernel — ``fused_topk`` on the f32, bf16 and int8 wires at ML-20M width
            (138,493 users x 26,744 items, rank 64), B in {1, 37, 2048},
            k in {16, 128}, one ``base != 0`` case and an integer-valued tie
            case, each held against the plain version on the card. Scores
            agree within |d| <= rtol * (1 + |plain|), rtol 1e-5 on f32 and
            1e-4 on bf16/int8; every returned id's own score, recomputed in
            float64, agrees with the score returned beside it at the same
            tolerance (so an id differs from the plain version's only
            inside a near-tie); ids are exact in the tie case.
4. slice  — an ML-20M-width model made from ``--seed`` is deployed through
            ``server.engineserver.deploy`` on the card with int8 serving
            tables and batching, on a free port. Single queries and a
            concurrent burst go over HTTP and every answer is checked
            against the plain version on the same tables; one
            ``recommend_batch`` of 2,048 users runs beside them. The kernel
            launch counts are zeroed just before and read just after, and
            must be positive.

Then a ``{"kernels": [...]}`` line (time, bound, plain and library times,
launches) and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# ML-20M at rank 64: the north-star serving width
N_USERS, N_ITEMS, RANK = 138_493, 26_744, 64
BATCH = 2048                      # queries per dispatch of a batch sweep
RTOL = {"f32": 1e-5, "bf16": 1e-4, "int8": 1e-4}
#: published H100 SXM peaks (dense) for the operations on each wire, and
#: its memory rate; the bound is the larger of operations and bytes
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` single runs (CUDA
    events around each, after one warm-up run)."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(wire: str, B: int, k: int, n_items: int, r: int) -> tuple:
    """(least ms, what bounds it) for one fused_topk call: each input byte
    read once (the B gathered user rows, the item table, scales, ids),
    each output byte written once, and 2*B*I*r operations at the wire's
    peak."""
    w = {"f32": 4, "bf16": 2, "int8": 1}[wire]
    scales = (B + n_items) * 4 if wire == "int8" else 0
    nbytes = B * r * w + n_items * r * w + scales + B * 4 + B * k * 8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * n_items * r / PEAK_OPS[wire] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def verify_topk(tag, s, i, ps, U64, V64, idx, rtol):
    """Kernel (s, i) against the plain version's scores ``ps``; U64/V64
    are float64 copies of the dequantized tables on the card. Returns the
    largest score difference."""
    tol = rtol * (1.0 + ps.abs())
    err = (s - ps).abs()
    check(bool((err <= tol).all()),
          f"{tag}: scores off the plain version by {err.max().item():.3e}")
    own = torch.einsum("br,bkr->bk", U64[idx.long()], V64[i.long()])
    own_err = (own - s.double()).abs()
    check(bool((own_err <= tol.double()).all()),
          f"{tag}: a returned id does not score what was returned beside "
          f"it (off by {own_err.max().item():.3e})")
    srt = torch.sort(i.long(), dim=1).values
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{tag}: an id appears twice in one row")
    return err.max().item()


def phase_card() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    from predictionio_tpu_torch.utils.device import card_info

    info = card_info()
    print(info["nvidia_smi"], flush=True)
    print(f"phase card: {info['name']} power_limit={info['power_limit']} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    # the plain versions are held to full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return info


def phase_build() -> None:
    from predictionio_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    dt = time.perf_counter() - t0
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln]
    print(f"phase build: {len(logs)} source(s) {sorted(logs)} in "
          f"{dt:.2f}s; " + " | ".join(regs), flush=True)


def make_tables(seed: int):
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((N_USERS, RANK), dtype=np.float32)
    V = rng.standard_normal((N_ITEMS, RANK), dtype=np.float32)
    return rng, U, V


def phase_kernel(rng, U, V, dev) -> dict:
    from predictionio_tpu_torch.models.als import _quantize_rows
    from predictionio_tpu_torch.ops.fused_topk import (
        fused_topk,
        fused_topk_reference,
    )

    Ud, Vd = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
    qU, qus = _quantize_rows(U, "int8")
    qV, qvs = _quantize_rows(V, "int8")
    wires = {
        "f32": (Ud, Vd, None, None),
        "bf16": (Ud.bfloat16(), Vd.bfloat16(), None, None),
        "int8": (qU.to(dev), qV.to(dev), qus.to(dev), qvs.to(dev)),
    }
    row = {}
    for wire, (ut, vt, us, vs) in wires.items():
        U64 = ut.double() * (us.double() if us is not None else 1.0)
        V64 = vt.double() * (vs.double() if vs is not None else 1.0)
        for B in (1, 37, BATCH):
            idx = torch.from_numpy(
                rng.integers(0, N_USERS, B).astype(np.int32)).to(dev)
            for k in (16, 128):
                s, i = fused_topk(ut, idx, vt, us, vs, k=k, n_items=N_ITEMS)
                torch.cuda.synchronize()
                ps, pi = fused_topk_reference(ut, idx, vt, us, vs, k=k,
                                              n_items=N_ITEMS)
                err = verify_topk(f"{wire} B={B} k={k}", s, i, ps, U64, V64,
                                  idx, RTOL[wire])
                diff = int((i != pi).sum().item())
                reps = 20 if B == BATCH else 5
                ms = median_ms(lambda: fused_topk(
                    ut, idx, vt, us, vs, k=k, n_items=N_ITEMS), reps)
                plain_ms = median_ms(lambda: fused_topk_reference(
                    ut, idx, vt, us, vs, k=k, n_items=N_ITEMS), 3)
                uq, vq = U64[idx.long()].float(), V64.float()
                lib_ms = median_ms(
                    lambda: torch.topk(torch.matmul(uq, vq.T), k), 5)
                b_ms, b_by = bound(wire, B, k, N_ITEMS, RANK)
                print(f"phase kernel: fused_topk {wire} B={B} k={k} "
                      f"max_abs_err={err:.3e} ids_differing={diff} "
                      f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} "
                      f"bound_by={b_by}", flush=True)
                if (wire, B, k) == ("int8", BATCH, 16):
                    # the shape the serving path's batch sweep gives it
                    row = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib_ms}

    # base != 0: ids offset by base, items at or past n_items masked
    ut, vt = wires["f32"][:2]
    base = 5000
    idx = torch.from_numpy(rng.integers(0, N_USERS, 37).astype(np.int32)
                           ).to(dev)
    s, i = fused_topk(ut, idx, vt, base=base, k=64, n_items=N_ITEMS)
    ps, pi = fused_topk_reference(ut, idx, vt, base=base, k=64,
                                  n_items=N_ITEMS)
    torch.cuda.synchronize()
    check(bool((i >= base).all() and (i < N_ITEMS).all()),
          "base case: ids outside [base, n_items)")
    err = verify_topk("base case", s, i - base, ps, ut.double(),
                      vt.double(), idx, RTOL["f32"])
    print(f"phase kernel: base={base} k=64 max_abs_err={err:.3e} "
          f"ids_differing={int((i != pi).sum().item())}", flush=True)

    # exact ties: integer-valued factors make every product exact, so
    # ranks are decided by the id order alone
    tie_rng = np.random.default_rng(7)
    Ui = tie_rng.integers(-2, 3, (4096, RANK)).astype(np.float32)
    Vi = tie_rng.integers(-2, 3, (N_ITEMS, RANK)).astype(np.float32)
    idx = torch.from_numpy(tie_rng.integers(0, 4096, 64).astype(np.int32)
                           ).to(dev)
    for wire, cast in (("f32", torch.float32), ("bf16", torch.bfloat16),
                       ("int8", torch.int8)):
        ut = torch.from_numpy(Ui).to(dev).to(cast)
        vt = torch.from_numpy(Vi).to(dev).to(cast)
        for k in (16, 128):
            s, i = fused_topk(ut, idx, vt, k=k, n_items=N_ITEMS - 3)
            ps, pi = fused_topk_reference(ut, idx, vt, k=k,
                                          n_items=N_ITEMS - 3)
            torch.cuda.synchronize()
            check(torch.equal(i, pi) and torch.equal(s, ps),
                  f"tie case {wire} k={k}: ids or scores not exact")
    print("phase kernel: integer-valued tie case exact on f32/bf16/int8 "
          "k=16,128", flush=True)

    try:
        fused_topk(ut, idx, vt, k=129, n_items=N_ITEMS)
    except ValueError:
        pass
    else:
        fail("k=129 did not raise")
    return row


#: loopback only: no proxy from the environment may carry these requests
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _post(port: int, body) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with _LOCAL.open(req, timeout=60) as resp:
        out = json.loads(resp.read())
    return out, time.perf_counter() - t0


def phase_slice(rng, U, V, dev) -> int:
    from predictionio_tpu_torch.models.als import (
        _compiled_k,
        _table_leaves,
        recommend_batch,
    )
    from predictionio_tpu_torch.models.convert import als_model_from_numpy
    from predictionio_tpu_torch.ops import fused_topk as ft
    from predictionio_tpu_torch.server.engineserver import (
        ServerConfig,
        deploy,
    )
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    users = [f"u{i}" for i in range(N_USERS)]
    items = [f"i{j}" for j in range(N_ITEMS)]
    model = als_model_from_numpy(
        U, V, N_USERS, N_ITEMS, {u: n for n, u in enumerate(users)},
        {it: n for n, it in enumerate(items)}, {"rank": RANK},
        device="cpu")
    engine = recommendation_engine()
    ep = engine.params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    t0 = time.perf_counter()
    srv = deploy(engine, ep, [model],
                 ServerConfig(batching=True, serving_quant="int8"),
                 host="127.0.0.1", port=0)
    srv.start_background()
    bind_s = time.perf_counter() - t0
    bound_model = srv.query_server.models[0]
    ud, us = _table_leaves(bound_model.user_factors)
    vd, vs = _table_leaves(bound_model.item_factors)
    check(vd.is_cuda and vd.dtype == torch.int8,
          "deploy did not place int8 tables on the card")
    U64 = ud.double() * us.double()
    V64 = vd.double() * vs.double()

    def expect_ok(query, answer):
        """An answer agrees with the plain version on the bound tables."""
        got = answer["itemScores"]
        uidx = int(query["user"][1:])
        black = {int(b[1:]) for b in query.get("blackList", [])}
        kk = _compiled_k(query["num"] + len(black), N_ITEMS)
        idx = torch.tensor([uidx], dtype=torch.int32, device=dev)
        ps, pi = ft.fused_topk_reference(ud, idx, vd, us, vs, k=kk,
                                         n_items=N_ITEMS)
        keep = [j for j, it in enumerate(pi[0].tolist()) if it not in black]
        want = ps[0, keep][: query["num"]].double()
        check(len(got) == len(want), f"{query}: {len(got)} items returned")
        ids = torch.tensor([int(g["item"][1:]) for g in got], device=dev)
        s = torch.tensor([g["score"] for g in got], dtype=torch.float64,
                         device=dev)
        tol = RTOL["int8"] * (1 + want.abs())
        check(bool(((s - want).abs() <= tol).all()),
              f"{query}: scores off the plain version")
        own = (U64[uidx][None, :] * V64[ids]).sum(1)
        check(bool(((own - s).abs() <= tol).all()),
              f"{query}: an item does not score what was returned")
        check(not (set(ids.tolist()) & black), f"{query}: blacklisted item")

    queries = [{"user": f"u{u}", "num": 10}
               for u in rng.integers(0, N_USERS, 64)]
    queries[0]["blackList"] = ["i1", "i2", "i3"]
    burst = [{"user": f"u{u}", "num": 10}
             for u in rng.integers(0, N_USERS, 512)]
    batch_users = rng.integers(0, N_USERS, BATCH)

    # -- the serving path, counted ------------------------------------
    ft.LAUNCHES = 0
    single = [_post(srv.port, q) for q in queries]
    results = [None] * len(burst)

    def client(w: int, n_workers: int) -> None:
        for j in range(w, len(burst), n_workers):
            results[j] = _post(srv.port, burst[j])

    workers = [threading.Thread(target=client, args=(w, 32))
               for w in range(32)]
    launches_before_burst = ft.LAUNCHES
    t_burst = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    burst_s = time.perf_counter() - t_burst
    burst_launches = ft.LAUNCHES - launches_before_burst
    check(not any(t.is_alive() for t in workers), "burst clients hung")
    unknown, _ = _post(srv.port, {"user": "nobody", "num": 10})
    t_batch = time.perf_counter()
    ids, scores = recommend_batch(bound_model, batch_users, 10)
    batch_s = time.perf_counter() - t_batch
    launches = ft.LAUNCHES
    # ------------------------------------------------------------------

    check(launches > 0, "the serving path launched fused_topk no time")
    for q, (a, _) in zip(queries, single):
        expect_ok(q, a)
    check(all(r is not None for r in results), "a burst query got no answer")
    for q, (a, _) in zip(burst, results):
        expect_ok(q, a)
    check(unknown == {"itemScores": []}, "unknown user got items")
    check(ids.shape == (BATCH, 10) and np.isfinite(scores).all(),
          "recommend_batch: wrong shape or non-finite scores")
    idx = torch.from_numpy(batch_users.astype(np.int32)).to(dev)
    ps, _ = ft.fused_topk_reference(ud, idx, vd, us, vs, k=16,
                                    n_items=N_ITEMS)
    want = ps[:, :10].cpu().numpy()
    check(bool((np.abs(scores - want) <= RTOL["int8"]
                * (1 + np.abs(want))).all()),
          "recommend_batch: scores off the plain version")
    with _LOCAL.open(f"http://127.0.0.1:{srv.port}/status.json",
                     timeout=30) as resp:
        status = json.loads(resp.read())
    check(status["card"] == torch.cuda.get_device_name(0),
          f"/status.json names {status['card']!r}")
    check(status["servingQuant"] == "int8",
          f"/status.json serves quant {status['servingQuant']!r}")
    check(status["kernels"]["fused_topk"]["launches"] >= launches,
          "/status.json launch count")

    # layers below HTTP, after the counted run: one query through the
    # bound QueryServer in-process (template, JSON, no HTTP or batcher),
    # and the model call alone (gather, kernel, readback)
    from predictionio_tpu_torch.models.als import recommend_products

    def host_ms(fn, arg_list):
        out = []
        for a in arg_list:
            t0 = time.perf_counter()
            fn(a)
            out.append((time.perf_counter() - t0) * 1e3)
        return np.percentile(out, 50)

    inproc_ms = host_ms(srv.query_server.query, queries)
    model_ms = host_ms(lambda q: recommend_products(
        bound_model, int(q["user"][1:]), 10), queries)
    srv.close()

    lat1 = np.array([t for _, t in single]) * 1e3
    latb = np.array([t for _, t in results]) * 1e3
    print(f"phase slice: bind_s={bind_s:.3f} single p50_ms="
          f"{np.percentile(lat1, 50):.3f} p99_ms={np.percentile(lat1, 99):.3f}"
          f" | burst 512 queries x 32 clients qps={len(burst) / burst_s:.1f}"
          f" p50_ms={np.percentile(latb, 50):.3f} p99_ms="
          f"{np.percentile(latb, 99):.3f} launches={burst_launches} "
          f"mean_batch={len(burst) / max(burst_launches, 1):.2f} "
          f"| recommend_batch B={BATCH} "
          f"s={batch_s:.4f} | fused_topk launches={launches} "
          f"requests={status['requestCount']}", flush=True)
    print(f"phase slice layers: single query p50_ms over HTTP+batcher="
          f"{np.percentile(lat1, 50):.3f} in-process QueryServer.query="
          f"{inproc_ms:.3f} recommend_products={model_ms:.3f}", flush=True)
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    phase_card()
    phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng, U, V = make_tables(args.seed)
    row = phase_kernel(rng, U, V, dev)
    launches = phase_slice(rng, U, V, dev)
    kernels = [dict(name="fused_topk", route="cuda",
                    source="predictionio_tpu_torch/csrc/fused_topk.cu",
                    replaces="predictionio_tpu/ops/fused_topk.py:97",
                    launches=launches, **row)]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's numerics rule family (``predictionio_tpu_torch/analysis/
numerics.py``) and its ``audit-numerics`` census
(``analysis/numerics_audit.py``) held to the JAX package's
(``predictionio_tpu/analysis/numerics{,_audit}.py``).

Each case of the JAX package's ``tests/test_numerics.py`` classes
``TestLowPrecisionReduction``, ``TestLowPrecisionInterprocedural``,
``TestDequantOutsideFunnel``, ``TestQuantizeWithoutParityGate``,
``TestUnguardedDomain`` and ``TestRequantTornPair`` is here twice: its
JAX source through the JAX package's rules, and the same fault written in
torch, in a scratch package, through the port's; both must find the same
numerics findings. Then the port's own idiom cases, the tree clean with
no baseline, the census of a dispatch mode, ``diff_manifests`` and
``write_manifest`` of both packages fed the same synthetic manifests,
the committed ``cpu`` section against a live run, and the CLI.
"""

import copy
import json
import textwrap
from pathlib import Path

import pytest
import torch

import predictionio_tpu.analysis as janalysis
import predictionio_tpu_torch.analysis as panalysis
from predictionio_tpu.analysis import numerics_audit as jna
from predictionio_tpu_torch.analysis import numerics_audit as na
from predictionio_tpu_torch.analysis.numerics import NUMERICS_RULES
from predictionio_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"
JAX_MODELS = "predictionio_tpu/models/m.py"
JAX_UTILS = "predictionio_tpu/utils/u.py"


def src(text):
    return textwrap.dedent(text)


def numerics(findings):
    return sorted(f.rule for f in findings if f.rule in NUMERICS_RULES)


def write_package(tmp_path, files):
    """A scratch package ``pkg/`` holding ``files`` (relative path ->
    source)."""
    pkg = tmp_path / "pkg"
    for rel, text in files.items():
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(src(text))
    return pkg


def port_findings(tmp_path, files, rule_names=None):
    pkg = write_package(tmp_path, files)
    return panalysis.run_check([str(pkg)], rule_names=rule_names)


# -- one module: (JAX source, torch source, where, rule filter, findings) ----

MODELS, UTILS = "models/m.py", "utils/u.py"
LPR = ["low-precision-reduction"]

SINGLE_CASES = {
    # TestLowPrecisionReduction
    "lpr::test_positive_einsum_over_bf16": ("""
        import jax.numpy as jnp

        def gram(table):
            shadow = table.astype(jnp.bfloat16)
            return jnp.einsum("lr,ls->rs", shadow, shadow)
    """, """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            return torch.einsum("lr,ls->rs", shadow, shadow)
    """, MODELS, None, LPR),
    "lpr::test_positive_sum_method_and_matmul": ("""
        import jax.numpy as jnp

        def acc(x):
            lo = x.astype(jnp.float16)
            a = lo.sum()
            b = lo @ lo
            return a, b
    """, """
        import torch

        def acc(x):
            lo = x.half()
            a = lo.sum()
            b = lo @ lo
            return a, b
    """, MODELS, None, LPR * 2),
    "lpr::test_negative_preferred_element_type": ("""
        import jax.numpy as jnp

        def gram(table):
            shadow = table.astype(jnp.bfloat16)
            return jnp.einsum("lr,ls->rs", shadow, shadow,
                              preferred_element_type=jnp.float32)
    """, """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            return torch.sum(shadow, dtype=torch.float32)
    """, MODELS, None, []),
    "lpr::test_negative_upcast_before_reduction": ("""
        import jax.numpy as jnp

        def gram(table):
            shadow = table.astype(jnp.bfloat16)
            wide = shadow.astype(jnp.float32)
            return jnp.sum(wide)
    """, """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            wide = shadow.float()
            return torch.sum(wide)
    """, MODELS, LPR, []),
    "lpr::test_negative_outside_hot_dirs": ("""
        import jax.numpy as jnp

        def gram(table):
            shadow = table.astype(jnp.bfloat16)
            return jnp.sum(shadow)
    """, """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            return torch.sum(shadow)
    """, UTILS, None, []),
    "lpr::test_conditional_shadow_ifexp_is_seen": ("""
        import jax.numpy as jnp

        def solve(table, bf16):
            gsrc = table.astype(jnp.bfloat16) if bf16 else table
            return jnp.sum(gsrc)
    """, """
        import torch

        def solve(table, bf16):
            gsrc = table.bfloat16() if bf16 else table
            return torch.sum(gsrc)
    """, MODELS, None, LPR),
    "lpr::test_pragma_suppresses": ("""
        import jax.numpy as jnp

        def gram(table):
            shadow = table.astype(jnp.bfloat16)
            return jnp.sum(shadow)  # ptpu: allow[low-precision-reduction] — short sum, loss bounded
    """, """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            return torch.sum(shadow)  # ptpu: allow[low-precision-reduction] — short sum, loss bounded
    """, MODELS, None, []),
    # TestDequantOutsideFunnel
    "dequant::test_positive_adhoc_data_upcast": ("""
        import jax.numpy as jnp

        def serve(table):
            wide = table.data.astype(jnp.float32)
            return wide
    """, """
        import torch

        def serve(table):
            wide = table.data.float()
            return wide
    """, MODELS, None, ["dequant-outside-funnel"]),
    "dequant::test_negative_inside_blessed_funnel": ("""
        import jax.numpy as jnp

        def dequantize_table(table):
            return table.data.astype(jnp.float32)
    """, """
        import torch

        def dequantize_table(table):
            return table.data.to(torch.float32)
    """, MODELS, None, []),
    "dequant::test_negative_module_level_dequant_lambda": ("""
        import jax
        import jax.numpy as jnp

        _dequant_scaled = jax.jit(
            lambda d, s: d.astype(jnp.float32) * s)
    """, """
        import torch

        _dequant_scaled = torch.jit.script(
            lambda d, s: d.data.float() * s)
    """, MODELS, None, []),
    "dequant::test_negative_upcast_of_unquantized_value": ("""
        import jax.numpy as jnp

        def widen(x):
            return x.astype(jnp.float32)
    """, """
        import torch

        def widen(x):
            return x.type(torch.float32)
    """, MODELS, None, []),
    "dequant::test_pragma_suppresses": ("""
        import jax.numpy as jnp

        def debug_dump(table):
            return table.data.astype(jnp.float32)  # ptpu: allow[dequant-outside-funnel] — offline debug dump
    """, """
        import torch

        def debug_dump(table):
            return table.data.float()  # ptpu: allow[dequant-outside-funnel] — offline debug dump
    """, MODELS, None, []),
    # TestQuantizeWithoutParityGate
    "quantize::test_positive_raw_construction": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def ship(data, scale):
            return QuantizedFactors(data, scale, "int8")
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def ship(data, scale):
            return QuantizedFactors(data, scale, "int8")
    """, MODELS, None, ["quantize-without-parity-gate"]),
    "quantize::test_positive_raw_quantize_rows": ("""
        from predictionio_tpu.models.als import _quantize_rows

        def ship(rows):
            return _quantize_rows(rows, "int8")
    """, """
        from predictionio_tpu_torch.models.als import _quantize_rows

        def ship(rows):
            return _quantize_rows(rows, "int8")
    """, MODELS, None, ["quantize-without-parity-gate"]),
    "quantize::test_negative_inside_parity_funnel": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def quantize_serving_model(model):
            return QuantizedFactors(model.data, model.scale, "int8")
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def quantize_serving_model(model):
            return QuantizedFactors(model.data, model.scale, "int8")
    """, MODELS, None, []),
    "quantize::test_negative_copy_constructor_residency_move": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def pin(t, dev):
            return QuantizedFactors(put(t.data, dev),
                                    put(t.scale, dev), t.quant)
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def pin(t, dev):
            return QuantizedFactors(t.data.to(dev), t.scale.to(dev),
                                    t.quant)
    """, MODELS, None, []),
    "quantize::test_pragma_suppresses": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def fixture(data, scale):
            return QuantizedFactors(data, scale, "int8")  # ptpu: allow[quantize-without-parity-gate] — test fixture
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def fixture(data, scale):
            return QuantizedFactors(data, scale, "int8")  # ptpu: allow[quantize-without-parity-gate] — test fixture
    """, MODELS, None, []),
    # TestUnguardedDomain
    "domain::test_positive_division_no_guard": ("""
        def mean_score(total, count):
            return total / count
    """, """
        def mean_score(total, count):
            return total / count
    """, MODELS, None, ["unguarded-domain"]),
    "domain::test_positive_log_no_guard": ("""
        import jax.numpy as jnp

        def ll(p):
            return jnp.log(p)
    """, """
        import torch

        def ll(p):
            return torch.log(p)
    """, MODELS, None, ["unguarded-domain"]),
    "domain::test_negative_maximum_guard": ("""
        import jax.numpy as jnp

        def ll(p):
            return jnp.log(jnp.maximum(p, 1e-9))
    """, """
        import torch

        def ll(p):
            return torch.log(torch.clamp(p, min=1e-9))
    """, MODELS, None, []),
    "domain::test_negative_eps_shift": ("""
        import jax.numpy as jnp

        def norm(x, eps):
            return x / (jnp.sum(x) + eps)
    """, """
        import torch

        def norm(x, eps):
            return x / (torch.sum(x) + eps)
    """, MODELS, None, []),
    "domain::test_negative_counter_bumped_before_divide": ("""
        def rate(events):
            n = 0
            total = 0.0
            for e in events:
                n += 1
                total += e
            return total / n
    """, """
        def rate(events):
            n = 0
            total = 0.0
            for e in events:
                n += 1
                total += e
            return total / n
    """, MODELS, None, []),
    "domain::test_negative_branch_tested": ("""
        def safe(total, count):
            return total / count if count else 0.0
    """, """
        def safe(total, count):
            return total / count if count else 0.0
    """, MODELS, None, []),
    "domain::test_negative_positive_literal_default": ("""
        import jax.numpy as jnp

        def smooth(counts, lam: float = 1.0):
            return jnp.log(counts + lam)
    """, """
        import torch

        def smooth(counts, lam: float = 1.0):
            return torch.log(counts + lam)
    """, MODELS, None, []),
    "domain::test_pragma_suppresses": ("""
        def mean_score(total, count):
            return total / count  # ptpu: allow[unguarded-domain] — caller validates count
    """, """
        def mean_score(total, count):
            return total / count  # ptpu: allow[unguarded-domain] — caller validates count
    """, MODELS, None, []),
    # TestRequantTornPair
    "torn::test_positive_torn_attribute_write": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows):
            table.data = rows
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows):
            table.data = rows
    """, MODELS, None, ["requant-torn-pair"]),
    "torn::test_negative_paired_write": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows, scales):
            table.data = rows
            table.scale = scales
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows, scales):
            table.data = rows
            table.scale = scales
    """, MODELS, None, []),
    "torn::test_positive_replace_missing_scale": ("""
        import dataclasses
        from predictionio_tpu.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows):
            return dataclasses.replace(table, data=rows)
    """, """
        import dataclasses
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows):
            return dataclasses.replace(table, data=rows)
    """, MODELS, None, ["requant-torn-pair"]),
    "torn::test_negative_replace_with_both": ("""
        import dataclasses
        from predictionio_tpu.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows, scales):
            return dataclasses.replace(table, data=rows,
                                       scale=scales)
    """, """
        import dataclasses
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def hot_swap(table: QuantizedFactors, rows, scales):
            return dataclasses.replace(table, data=rows,
                                       scale=scales)
    """, MODELS, None, []),
    "torn::test_pragma_suppresses": ("""
        from predictionio_tpu.models.als import QuantizedFactors

        def debug_poke(table: QuantizedFactors, rows):
            table.data = rows  # ptpu: allow[requant-torn-pair] — scale updated by caller
    """, """
        from predictionio_tpu_torch.models.als import QuantizedFactors

        def debug_poke(table: QuantizedFactors, rows):
            table.data = rows  # ptpu: allow[requant-torn-pair] — scale updated by caller
    """, MODELS, None, []),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_the_port_finds_what_the_jax_rule_finds(case, tmp_path):
    jsrc, tsrc, where, rules, want = SINGLE_CASES[case]
    jpath = JAX_MODELS if where == MODELS else JAX_UTILS
    jax = numerics(janalysis.check_source(src(jsrc), path=jpath,
                                          rule_names=rules))
    port = numerics(port_findings(tmp_path, {where: tsrc}, rules))
    assert jax == sorted(want), f"the JAX case itself moved: {jax}"
    assert port == jax


# -- interprocedural: the helper chain, JAX package against the port ---------

JAX_LEAF = """
    import jax.numpy as jnp

    def accumulate(x):
        return jnp.sum(x)
"""
TORCH_LEAF = """
    import torch

    def accumulate(x):
        return torch.sum(x)
"""
MID = """
    from pkg.ops.leaf import accumulate

    def shuttle(x):
        return accumulate(x) + 1
"""

CHAIN_CASES = {
    # (JAX caller, torch caller, JAX leaf, torch leaf, numerics findings)
    "test_two_hop_chain_flagged_at_caller": ("""
        import jax.numpy as jnp
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.astype(jnp.bfloat16)
            return shuttle(shadow)
    """, """
        import torch
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.to(dtype=torch.bfloat16)
            return shuttle(shadow)
    """, JAX_LEAF, TORCH_LEAF, LPR),
    "test_negative_upcast_at_call_site": ("""
        import jax.numpy as jnp
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.astype(jnp.bfloat16)
            return shuttle(shadow.astype(jnp.float32))
    """, """
        import torch
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.to(dtype=torch.bfloat16)
            return shuttle(shadow.float())
    """, JAX_LEAF, TORCH_LEAF, ["dequant-outside-funnel"]),
    "test_pragma_at_leaf_blesses_callers": ("""
        import jax.numpy as jnp
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.astype(jnp.bfloat16)
            return shuttle(shadow)
    """, """
        import torch
        from pkg.ops.mid import shuttle

        def fold(table):
            shadow = table.to(dtype=torch.bfloat16)
            return shuttle(shadow)
    """, """
        import jax.numpy as jnp

        def accumulate(x):
            return jnp.sum(x)  # ptpu: allow[low-precision-reduction] — callers bound the length
    """, """
        import torch

        def accumulate(x):
            return torch.sum(x)  # ptpu: allow[low-precision-reduction] — callers bound the length
    """, []),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_the_port_follows_the_chain_the_jax_rule_follows(case, tmp_path):
    jcaller, tcaller, jleaf, tleaf, want = CHAIN_CASES[case]
    jax = janalysis.check_project({
        "pkg/ops/leaf.py": src(jleaf), "pkg/ops/mid.py": src(MID),
        "pkg/models/fold.py": src(jcaller)})
    port = port_findings(tmp_path, {
        "ops/leaf.py": tleaf, "ops/mid.py": MID,
        "models/fold.py": tcaller})
    assert numerics(jax) == sorted(want)
    assert numerics(port) == numerics(jax)
    for jf, pf in zip(jax, port):
        # anchored at the bf16 call site, the helper hops in `related`
        assert pf.path.endswith(jf.path)
        assert [p[-len(j):] for (p, _, _), (j, _, _)
                in zip(pf.related, jf.related)] \
            == [j for j, _, _ in jf.related]


def test_the_chain_message_names_each_helper(tmp_path):
    f, = port_findings(tmp_path, {
        "ops/leaf.py": TORCH_LEAF, "ops/mid.py": MID,
        "models/fold.py": CHAIN_CASES[
            "test_two_hop_chain_flagged_at_caller"][1]})
    assert "shuttle" in f.message and "accumulate" in f.message
    assert "bfloat16" in f.message


# -- torch's own idiom ---------------------------------------------------------

IDIOM_CASES = {
    "matmul of a .to(dtype=) shadow": ("""
        import torch

        def score(u, v):
            lo = u.to(dtype=torch.bfloat16)
            return torch.matmul(lo, v)
    """, ["low-precision-reduction"]),
    "bmm of a bf16 creation": ("""
        import torch

        def score(n):
            a = torch.zeros((n, 4, 4), dtype=torch.bfloat16)
            return torch.bmm(a, a)
    """, ["low-precision-reduction"]),
    ".mean() of a half tensor": ("""
        def avg(x):
            lo = x.half()
            return lo.mean()
    """, ["low-precision-reduction"]),
    "mm after .to(torch.float32)": ("""
        import torch

        def gram(x):
            lo = x.to(torch.bfloat16)
            wide = lo.to(torch.float32)
            return torch.mm(wide.T, wide)
    """, ["dequant-outside-funnel"]),
    ".type(torch.float32) of a .data leaf": ("""
        import torch

        def serve(table):
            return table.data.type(torch.float32)
    """, ["dequant-outside-funnel"]),
    "numpy astype of an int8 array": ("""
        import numpy as np

        def host(rows):
            q = rows.astype(np.int8)
            return q.astype(np.float32)
    """, ["dequant-outside-funnel"]),
    ".to(dev) keeps a table's dtype": ("""
        import torch

        def move(table, dev):
            return table.data.to(dev)
    """, []),
    ".sqrt() method": ("""
        def norm(x):
            return (x * x).sum().sqrt()
    """, ["unguarded-domain"]),
    ".rsqrt() of clamp_min": ("""
        def inv(x, eps):
            return x.clamp_min(eps).rsqrt()
    """, []),
    "a guard holds through .to(dev)": ("""
        def mean(loss, valid, dev):
            n = valid.sum().clamp_min(1)
            return loss / n.to(dev)
    """, []),
    "pathlib joins are no division": ("""
        def target(root, digest, name):
            return root / digest[:16] / f"lib{name}.so"
    """, []),
    "torch.where guard": ("""
        import torch

        def safe_log(x):
            return torch.log(torch.where(x > 0, x, 1.0))
    """, []),
}


@pytest.mark.parametrize("case", sorted(IDIOM_CASES))
def test_the_rules_read_torch(case, tmp_path):
    code, want = IDIOM_CASES[case]
    assert numerics(port_findings(tmp_path, {MODELS: code})) == want


@pytest.mark.parametrize("rule", NUMERICS_RULES)
def test_the_ports_tree_is_clean(rule):
    assert panalysis.run_check([str(PORT)], rule_names=[rule]) == []


@pytest.mark.parametrize("rule", NUMERICS_RULES)
def test_the_rule_is_registered_on_by_default(rule):
    assert rule in panalysis.RULES
    assert panalysis.RULES[rule].description


def test_check_sarif_declares_and_reports_numerics_rules(tmp_path, capsys):
    write_package(tmp_path, {MODELS: """
        import torch

        def gram(table):
            shadow = table.to(torch.bfloat16)
            return torch.sum(shadow)
    """})
    assert main(["check", str(tmp_path), "--format", "sarif"]) == 1
    doc = json.loads(capsys.readouterr().out)
    run = doc["runs"][0]
    declared = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert set(NUMERICS_RULES) <= declared
    assert any(r["ruleId"] == "low-precision-reduction"
               for r in run["results"])


# -- the census ----------------------------------------------------------------

def test_a_bf16_matmul_records_a_bf16_reduction():
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    rec = na.census(lambda: torch.einsum("ij,jk->ik", a, a))
    assert {dt for by in rec["reductions"].values() for dt in by} \
        == {"bfloat16"}


def test_an_upcast_first_records_an_f32_reduction():
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    rec = na.census(lambda: torch.einsum("ij,jk->ik", a.float(),
                                         a.float()))
    assert {dt for by in rec["reductions"].values() for dt in by} \
        == {"float32"}
    assert rec["casts"] == {"bfloat16->float32": 2}


def test_cast_inventory_and_bytes():
    a = torch.ones((8,), dtype=torch.bfloat16)
    rec = na.census(lambda: a.float() * 2.0)
    assert rec["casts"] == {"bfloat16->float32": 1}
    assert rec["bytes"]["float32"] >= 8 * 4
    assert set(rec) == {"ops", "casts", "reductions", "bytes", "kernels"}


def test_a_copy_between_dtypes_is_a_cast():
    dst = torch.zeros(8)
    src_ = torch.ones(8, dtype=torch.int8)
    rec = na.census(lambda: dst.copy_(src_))
    assert rec["casts"] == {"int8->float32": 1}


def test_the_census_counts_kernel_launches(monkeypatch):
    from predictionio_tpu_torch.ops import fused_topk

    def launch():
        fused_topk.LAUNCHES += 2

    rec = na.census(launch)
    assert rec["kernels"]["fused_topk"] == 2
    assert set(rec["kernels"]) == set(na.KERNEL_MODULES)


# -- diff and write: both packages fed the same synthetic manifests -----------

def _synthetic():
    """Two entries of the JAX package's committed manifest: the shape its
    TestRunAuditAndRatchet fixture holds."""
    with open(jna.DEFAULT_BASELINE, encoding="utf-8") as fh:
        doc = json.load(fh)
    return {"version": 1, "devices": 8, "entries": {
        k: doc["entries"][k]
        for k in ("quantize_serving_model", "device_topk_int8")}}


def _new_cast(m):
    base = copy.deepcopy(m)
    del base["entries"]["quantize_serving_model"]["casts"]["int8->float32"]
    return m, base


def _low_growth(m):
    cur = copy.deepcopy(m)
    cur["entries"]["device_topk_int8"]["reductions"]["dot_general"] = {
        "bfloat16": 1}
    return cur, m


def _wide_growth(m):
    cur = copy.deepcopy(m)
    reds = cur["entries"]["device_topk_int8"]["reductions"]
    reds["dot_general"]["float32"] = reds["dot_general"].get(
        "float32", 0) + 3
    return cur, m


def _bytes_blowup(m):
    cur = copy.deepcopy(m)
    b = cur["entries"]["device_topk_int8"]["bytes"]
    b["float32"] = int(b.get("float32", 0) * 4 + 10_000_000)
    return cur, m


def _unrecorded(m):
    base = copy.deepcopy(m)
    del base["entries"]["device_topk_int8"]
    return m, base


def _device_mismatch(m):
    base = copy.deepcopy(m)
    base["devices"] = 4
    return m, base


def _shrink(m):
    base = copy.deepcopy(m)
    base["entries"]["quantize_serving_model"]["casts"]["int8->float32"] += 5
    return m, base


def _itself(m):
    return m, m


DIFF_CASES = {
    "test_diff_against_itself_is_clean": (_itself, 0),
    "test_new_cast_is_a_violation": (_new_cast, 1),
    "test_low_precision_reduction_growth_is_a_violation": (_low_growth, 1),
    "test_wide_reduction_growth_is_not_a_violation": (_wide_growth, 0),
    "test_bytes_blowup_is_a_violation": (_bytes_blowup, 1),
    "test_unrecorded_entry_is_a_violation": (_unrecorded, 1),
    "test_device_count_mismatch_is_a_violation": (_device_mismatch, 1),
    "test_shrink_is_reported_not_fatal": (_shrink, 0),
}


def _head(violation):
    """What a violation names (entry, op or cast, counts), without the
    advice each package words its own way."""
    return violation.split(" — ")[0].split(" (mesh")[0]


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_manifests_agrees_with_the_jax_package(case):
    make, n_violations = DIFF_CASES[case]
    current, baseline = make(_synthetic())
    jv, js = jna.diff_manifests(current, baseline)
    pv, ps = na.diff_manifests(current, baseline)
    assert len(jv) == n_violations
    assert [_head(v) for v in pv] == [_head(v) for v in jv]
    assert ps == js


def _entries(doc):
    return {name: {k: v for k, v in rec.items() if k != "kernels"}
            for name, rec in doc["entries"].items()}


@pytest.mark.parametrize("grow", [False, True],
                         ids=["test_write_ratchets_shrink_only",
                              "test_baseline_grow_writes_as_is"])
def test_write_manifest_agrees_with_the_jax_package(grow, tmp_path):
    m = _synthetic()
    grown = copy.deepcopy(m)
    grown["entries"]["quantize_serving_model"]["casts"]["float32->int8"] = 7
    grown["entries"]["extra_entry"] = copy.deepcopy(
        m["entries"]["device_topk_int8"])
    cap = None if grow else m
    jpath, ppath = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jna.write_manifest(jpath, grown, cap=cap)
    na.write_manifest(ppath, {**grown, "version": na.MANIFEST_VERSION,
                              "platform": "cpu"}, cap=cap)
    jdoc = jna.load_manifest(jpath)
    pdoc = na.section(na.load_manifest(ppath), "cpu")
    assert _entries(pdoc) == _entries(jdoc)
    assert ("extra_entry" in pdoc["entries"]) is grow


def test_write_keeps_the_other_platforms_section(tmp_path):
    path = str(tmp_path / "b.json")
    m = _synthetic()
    na.write_manifest(path, {**m, "platform": "cuda"})
    na.write_manifest(path, {**m, "platform": "cpu", "devices": 4})
    doc = na.load_manifest(path)
    assert na.section(doc, "cuda")["devices"] == 8
    assert na.section(doc, "cpu")["devices"] == 4


@pytest.mark.parametrize("version", [99, 1])
def test_load_rejects_wrong_version(version, tmp_path):
    p = tmp_path / "v.json"
    p.write_text(json.dumps({"version": version, "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        na.load_manifest(str(p))
    if version != jna.MANIFEST_VERSION:
        with pytest.raises(ValueError, match="version"):
            jna.load_manifest(str(p))


def test_a_kernel_no_longer_launched_is_a_violation():
    m = {"version": na.MANIFEST_VERSION, "devices": 8, "entries": {
        "lhs_fused": {"ops": {}, "casts": {}, "reductions": {}, "bytes": {},
                      "kernels": {"fused_gram": 1}}}}
    cur = copy.deepcopy(m)
    cur["entries"]["lhs_fused"]["kernels"]["fused_gram"] = 0
    violations, _ = na.diff_manifests(cur, m)
    assert any("fused_gram" in v and "kernel" in v for v in violations)


# -- the committed baseline against a live run ---------------------------------

@pytest.fixture(scope="module")
def live_cpu(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "numerics.json"
    assert main(["audit-numerics", "--device", "cpu", "--out",
                 str(out)]) == 0
    return json.loads(out.read_text())


def test_the_committed_cpu_section_equals_a_live_run(live_cpu):
    committed = na.section(na.load_manifest(na.DEFAULT_BASELINE), "cpu")
    assert live_cpu["devices"] == committed["devices"] \
        == na.AUDIT_DEVICE_COUNT
    assert live_cpu["entries"] == committed["entries"]


def test_every_jax_entry_is_audited(live_cpu):
    assert list(na.ENTRY_POINTS) == list(jna.ENTRY_POINTS)
    assert set(live_cpu["entries"]) == set(jna.ENTRY_POINTS)


def test_the_cpu_census_holds_the_dequant_funnels(live_cpu):
    casts = live_cpu["entries"]["quantize_serving_model"]["casts"]
    assert casts.get("int8->float32", 0) >= 1
    assert casts.get("bfloat16->float32", 0) >= 1
    # the plain versions launch nothing
    for rec in live_cpu["entries"].values():
        assert set(rec["kernels"].values()) == {0}


@pytest.mark.parametrize("name", sorted(jna.ENTRY_POINTS))
def test_no_entry_accumulates_below_f32(live_cpu, name):
    for by in live_cpu["entries"][name]["reductions"].values():
        assert not any(na.is_low(dt) for dt in by), (name, by)


CUDA_GATES = [
    ("device_topk_off", "fused_topk"), ("device_topk_bf16", "fused_topk"),
    ("device_topk_int8", "fused_topk"), ("lhs_fused", "fused_gram"),
    ("train_update_block", "chol_solve"),
]


@pytest.mark.parametrize("entry,kernel", CUDA_GATES)
def test_the_committed_cuda_section_records_its_kernels(entry, kernel):
    sec = na.section(na.load_manifest(na.DEFAULT_BASELINE), "cuda")
    assert sec is not None and sec["devices"] == na.AUDIT_DEVICE_COUNT
    assert set(sec["entries"]) == set(jna.ENTRY_POINTS)
    assert sec["entries"][entry]["kernels"][kernel] >= 1


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_the_committed_cuda_section_keeps_no_f32_table_copy(quant):
    sec = na.section(na.load_manifest(na.DEFAULT_BASELINE), "cuda")
    rec = sec["entries"][f"device_topk_{quant}"]
    assert rec["bytes"].get("float32", 0) < na.ITEM_ROWS * na.RANK * 4


# -- the CLI -------------------------------------------------------------------

def test_without_cuda_and_without_device_cpu_the_command_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["audit-numerics", "--entry", "device_topk_off"])


def test_list_entries(capsys):
    assert main(["audit-numerics", "--list-entries"]) == 0
    out = capsys.readouterr().out
    assert "foldin_update_bf16" in out and "device_topk_int8" in out


def test_unknown_entry_exits_2():
    assert main(["audit-numerics", "--entry", "nope", "--device",
                 "cpu"]) == 2


def test_subset_json_and_artifact(capsys, tmp_path):
    artifact = tmp_path / "numerics.json"
    assert main(["audit-numerics", "--entry", "quantize_serving_model",
                 "--format", "json", "--out", str(artifact), "--device",
                 "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["entries"]["quantize_serving_model"]["casts"][
        "int8->float32"] >= 1
    assert artifact.exists()


def test_write_and_gate_roundtrip(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    args = ["audit-numerics", "--entry", "device_topk_int8", "--baseline",
            path, "--device", "cpu"]
    assert main(args + ["--write-baseline"]) == 0
    capsys.readouterr()
    assert main(args) == 0
    assert "int8->float32" in capsys.readouterr().out


def test_gate_fails_on_doctored_baseline(tmp_path, capsys):
    path = str(tmp_path / "b.json")
    args = ["audit-numerics", "--entry", "quantize_serving_model",
            "--baseline", path, "--device", "cpu"]
    assert main(args + ["--write-baseline"]) == 0
    doc = na.load_manifest(path)
    del doc["platforms"]["cpu"]["entries"]["quantize_serving_model"][
        "casts"]["int8->float32"]
    Path(path).write_text(json.dumps(doc))
    capsys.readouterr()
    assert main(args) == 1
    assert "int8->float32" in capsys.readouterr().err


# -- a seeded bf16-accumulation regression fails both gates -------------------

SEEDED = """
    import torch

    def gram_weighted(F, w):
        lo = F.to(torch.bfloat16)
        return torch.einsum("lr,ls->rs", lo, lo)
"""


def test_the_seeded_regression_fails_the_static_rule(tmp_path):
    found = port_findings(tmp_path, {"ops/gram.py": SEEDED})
    assert numerics(found) == ["low-precision-reduction"]


def test_the_seeded_regression_fails_the_census_gate():
    F = torch.ones((16, 4))
    lo = F.to(torch.bfloat16)
    rec = na.census(lambda: torch.einsum("lr,ls->rs", lo, lo))
    golden = copy.deepcopy(rec)
    golden["reductions"] = {op: {"float32": sum(by.values())}
                            for op, by in rec["reductions"].items()}
    current = {"version": na.MANIFEST_VERSION, "devices": 8,
               "entries": {"gram": rec}}
    base = {"version": na.MANIFEST_VERSION, "devices": 8,
            "entries": {"gram": golden}}
    violations, _ = na.diff_manifests(current, base)
    assert any("bfloat16" in v and "f32 accumulator" in v
               for v in violations)

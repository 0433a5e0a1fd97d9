"""The port's ``check`` (``predictionio_tpu_torch/analysis``) held to the
JAX package's ``ptpu check``.

Every case of the JAX package's own checker tests for the rules the port
keeps (``tests/test_check.py``: the concurrency and lifecycle families,
``unbounded-retry``, the pragmas, the interprocedural layer's cases that
are not about JAX programs, the formats, the baseline and its ratchet,
the robustness cases) runs here with the JAX package's ``check_source``,
``check_project``, ``run_check`` and CLI ``main`` replaced by twins. A
twin runs the JAX package's function and the port's on the same input
(a JAX spelling put into its torch form by :data:`SPELLINGS`) and
asserts that the findings of the shared rules are identical — rule,
path, line, column, message, call chain — and, for the CLI, the exit
code, the output and the baseline file's bytes. The JAX case's own
assertions then run on the JAX package's result, as in its own tests.

Then the spelling table, ``smem-overbudget`` over planted ``csrc/``
trees and the port's own, the formats byte for byte, the repo-wide
gate, the cross-check of the JAX package's checker over the port's
tree, and a fresh interpreter that runs the checker without torch.
"""

import ast
import contextlib
import importlib.util
import inspect
import io
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import predictionio_tpu.analysis as janalysis
import predictionio_tpu.cli as jcli
import predictionio_tpu_torch.analysis as panalysis
from predictionio_tpu_torch import cli as pcli
from predictionio_tpu_torch.analysis import baseline as pbaseline
from predictionio_tpu_torch.analysis import concurrency as pconc
from predictionio_tpu_torch.analysis import interp as pinterp
from predictionio_tpu_torch.analysis import kernels as pkernels
from predictionio_tpu_torch.analysis import metrics_catalog as pcatalog
from predictionio_tpu_torch.analysis import rules as prules
from predictionio_tpu_torch.ops import fused_topk as ft
from predictionio_tpu_torch.ops import smem
from predictionio_tpu_torch.ops import solve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "predictionio_tpu_torch"

#: the rules both packages run (the JAX package's twelve that are not
#: about JAX programs), and the per-file errors both report
SHARED = {
    "unguarded-shared-state", "lock-order-inversion",
    "blocking-under-lock", "callback-under-lock", "leaked-thread",
    "missing-timeout", "non-atomic-persist", "unbounded-queue",
    "hot-spin-loop", "unbounded-retry", "metric-catalog-drift",
    "host-sync-in-hot-path"}
SHARED_OR_ERRORS = SHARED | {"parse-error", "checker-error"}

#: each JAX sync or blocking spelling beside its torch form, flagged at
#: the same line and column, the JAX reason beside the port's, and the
#: sites where the JAX package flags it (``jax.block_until_ready`` is no
#: host sync to it, ``jnp.sum`` under a lock is a dispatch and
#: ``torch.sum`` none)
SPELLINGS = [
    ("dev.block_until_ready()", "dev.synchronize()", [
        ("blocks on device completion",
         pconc.BLOCKING_METHOD_ATTRS["synchronize"]),
        (".block_until_ready() stalls the caller on device completion",
         prules.HOST_SYNC_METHODS["synchronize"])], ("hot", "under-lock")),
    ("jax.device_get(dev)", "dev.cpu()", [
        ("jax.device_get is a synchronous device→host transfer",
         pconc.BLOCKING_METHOD_ATTRS["cpu"]),
        ("jax.device_get blocks until the transfer completes",
         prules.HOST_SYNC_METHODS["cpu"])], ("hot", "under-lock")),
    ("jax.block_until_ready(dev)", "torch.cuda.synchronize()", [
        ("blocks on device completion",
         pconc.BLOCKING_EXACT["torch.cuda.synchronize"]),
        ("jax.block_until_ready", "torch.cuda.synchronize")],
     ("under-lock",)),
    ("float(jnp.sum(dev))", "float(torch.sum(dev))", [
        ("float() on a jnp result", "float() on a torch result")],
     ("hot",)),
]

#: where each spelling is judged: a hot function, and a held lock in the
#: serving stack (``{form}`` is replaced by the spelling)
SPELLING_SITES = {
    "hot": ("pkg/server/hot.py", """
        import jax
        import jax.numpy as jnp
        import torch

        def handler(dev):
            x = {form}
            return x
    """),
    "under-lock": ("pkg/cache/tier.py", """
        import threading

        import jax
        import jax.numpy as jnp
        import torch

        class Tier:
            def __init__(self):
                self._lock = threading.Lock()

            def read(self, dev):
                with self._lock:
                    x = {form}
                return x
    """),
}


def translate(source: str) -> str:
    for jax_form, torch_form, _, _ in SPELLINGS:
        source = source.replace(jax_form, torch_form)
    return source


def _rows_in(*sources):
    return [row for row in SPELLINGS
            if any(row[0] in s for s in sources)]


def _normalized(f, rows):
    msg = f.message
    for _, _, reasons, _ in rows:
        for jax_reason, torch_reason in reasons:
            msg = msg.replace(jax_reason, torch_reason)
    return (f.rule, f.path, f.line, f.col, msg, f.related)


def _plain(f):
    return (f.rule, f.path, f.line, f.col, f.message, f.related)


def assert_same(jax_findings, port_findings, rows=()):
    want = [_normalized(f, rows) for f in jax_findings
            if f.rule in SHARED_OR_ERRORS]
    got = [_plain(f) for f in port_findings if f.rule in SHARED_OR_ERRORS]
    assert got == want


def _port_rules(rule_names):
    """The port's rules of a JAX selection; None where the selection is
    the whole registry, [] where it names only rules the port lacks."""
    if not rule_names:
        return None
    return [r for r in rule_names if r in panalysis.RULES]


# ---------------------------------------------------------------------------
# the twins
# ---------------------------------------------------------------------------

def twin_check_source(source, path="<string>", rule_names=None, ctx=None):
    found = janalysis.check_source(source, path=path,
                                   rule_names=rule_names, ctx=ctx)
    rules = _port_rules(rule_names)
    port = [] if rules == [] else panalysis.check_source(
        translate(source), path=path, rule_names=rules)
    assert_same(found, port, _rows_in(source))
    return found


def twin_check_project(files, rule_names=None, ctx=None):
    found = janalysis.check_project(files, rule_names=rule_names, ctx=ctx)
    rules = _port_rules(rule_names)
    port = [] if rules == [] else panalysis.check_project(
        {p: translate(s) for p, s in files.items()}, rule_names=rules)
    assert_same(found, port, _rows_in(*files.values()))
    return found


def twin_run_check(paths, rule_names=None):
    found = janalysis.run_check(paths, rule_names=rule_names)
    rules = _port_rules(rule_names)
    port = [] if rules == [] else panalysis.run_check(paths,
                                                      rule_names=rules)
    assert_same(found, port)
    return found


def _flag_value(argv, flag):
    return argv[argv.index(flag) + 1] if flag in argv else None


def _run_cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _sarif_results(text):
    results = json.loads(text)["runs"][0]["results"]
    return [{k: v for k, v in r.items() if k != "ruleIndex"}
            for r in results]


def twin_main(argv):
    """The JAX CLI restricted to the shared rules and the port's CLI, on
    the same arguments from the same baseline file; then the JAX CLI as
    the case ran it (what the case's own assertions read)."""
    argv = list(argv)
    if argv and argv[0] == "check" and "--list-rules" not in argv \
            and "--rule" not in argv:
        baseline = _flag_value(argv, "--baseline")
        before = (Path(baseline).read_bytes()
                  if baseline and os.path.exists(baseline) else None)

        def restore():
            if baseline is None:
                return
            if before is None:
                if os.path.exists(baseline):
                    os.remove(baseline)
            else:
                Path(baseline).write_bytes(before)

        def written():
            return (Path(baseline).read_bytes()
                    if baseline and os.path.exists(baseline) else None)

        restricted = argv + [a for r in sorted(SHARED)
                             for a in ("--rule", r)]
        jrc, jout, jerr = _run_cli(jcli.main, restricted)
        jfile = written()
        restore()
        prc, pout, perr = _run_cli(pcli.main, argv)
        pfile = written()
        restore()
        assert (prc, perr) == (jrc, jerr)
        if "sarif" in argv:
            # the registries differ, and with them each rule's index
            assert _sarif_results(pout) == _sarif_results(jout)
        else:
            assert pout == jout
        assert pfile == jfile
    return jcli.main(argv)


def _load_jax_cases():
    spec = importlib.util.spec_from_file_location(
        "_jax_check_cases", ROOT / "tests" / "test_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CASES = _load_jax_cases()

#: the JAX package's test classes of the rules the port keeps
KEPT_CLASSES = [
    "TestUnguardedSharedState", "TestLockOrderInversion",
    "TestBlockingUnderLock", "TestCallbackUnderLock",
    "TestUnboundedRetry", "TestPragmaGeneral", "TestInterprocedural",
    "TestCheckFormatsAndBaseline", "TestBaselineRatchet",
    "TestCheckerRobustness", "TestLeakedThread", "TestMissingTimeout",
    "TestNonAtomicPersist", "TestUnboundedQueue", "TestHotSpinLoop"]

#: TestInterprocedural's cases about JAX programs (gather sinks under
#: jit): materialized-gather is not ported
JAX_PROGRAM_CASES = {
    ("TestInterprocedural", "test_gather_sink_through_helper"),
    ("TestInterprocedural", "test_gather_sink_two_hops_and_kwarg"),
}


def _cases():
    out = []
    for cls_name in KEPT_CLASSES:
        cls = getattr(JAX_CASES, cls_name)
        for name, fn in sorted(vars(cls).items()):
            if name.startswith("test") and callable(fn) \
                    and (cls_name, name) not in JAX_PROGRAM_CASES:
                out.append((cls_name, name))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}.{c[1]}")
def test_the_ports_findings_are_the_jax_packages(case, tmp_path, capsys,
                                                 monkeypatch):
    cls_name, name = case
    monkeypatch.setattr(JAX_CASES, "check_source", twin_check_source)
    monkeypatch.setattr(JAX_CASES, "check_project", twin_check_project)
    monkeypatch.setattr(JAX_CASES, "run_check", twin_run_check)
    monkeypatch.setattr(JAX_CASES, "main", twin_main)
    method = getattr(getattr(JAX_CASES, cls_name)(), name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys,
                "monkeypatch": monkeypatch}
    params = inspect.signature(method).parameters
    method(**{p: fixtures[p] for p in params})


def test_the_cases_are_all_here():
    # 109 cases in the kept classes, less the two about JAX programs
    assert len(CASES) == 107


# ---------------------------------------------------------------------------
# the spelling table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spelling,site", [
    (row, site) for row in SPELLINGS for site in row[3]],
    ids=lambda x: x if isinstance(x, str) else x[1])
def test_each_jax_spelling_and_its_torch_form_flag_the_same_line(
        spelling, site):
    jax_form, torch_form, _, _ = spelling
    path, template = SPELLING_SITES[site]
    template = textwrap.dedent(template)
    found = janalysis.check_source(template.replace("{form}", jax_form),
                                   path=path)
    port = panalysis.check_source(template.replace("{form}", torch_form),
                                  path=path)
    want = [(f.rule, f.line, f.col) for f in found if f.rule in SHARED]
    assert want, "the JAX spelling must be flagged at all"
    assert [(f.rule, f.line, f.col) for f in port] == want
    assert_same(found, port, [spelling])


@pytest.mark.parametrize("form,rules", [
    ("dev.item()", ["host-sync-in-hot-path"]),
    ("dev.tolist()", ["host-sync-in-hot-path"]),
    ("dev.numpy()", ["host-sync-in-hot-path"]),
    ('dev.to("cpu")', ["host-sync-in-hot-path"]),
    ('dev.to(device="cpu")', ["host-sync-in-hot-path"]),
    ('dev.to(torch.device("cpu"))', ["host-sync-in-hot-path"]),
    ("torch.cuda.synchronize()", ["host-sync-in-hot-path"]),
    ('dev.to("cuda")', []),
    ("dev.cpu(0)", []),
])
def test_torch_sync_forms_in_a_hot_function(form, rules):
    path, template = SPELLING_SITES["hot"]
    src = textwrap.dedent(template).replace("{form}", form)
    assert [f.rule for f in panalysis.check_source(src, path=path)] \
        == rules


@pytest.mark.parametrize("form", [
    "dev.item()", "dev.tolist()", "dev.cpu()", "dev.numpy()",
    "dev.synchronize()", "torch.cuda.synchronize()",
    "fused_topk(dev, dev, dev)", "solve_spd_batch(dev, dev)",
    "fused_gram(dev, dev, dev, dev)"])
def test_torch_blocking_forms_under_a_lock(form):
    src = textwrap.dedent("""
        import threading

        import torch
        from predictionio_tpu_torch.ops.fused_gram import fused_gram
        from predictionio_tpu_torch.ops.fused_topk import fused_topk
        from predictionio_tpu_torch.ops.solve import solve_spd_batch

        class Tier:
            def __init__(self):
                self._lock = threading.Lock()

            def read(self, dev):
                with self._lock:
                    x = {form}
                return x
    """).replace("{form}", form)
    found = panalysis.check_source(src, path="pkg/cache/tier.py",
                                   rule_names=["blocking-under-lock"])
    assert [(f.rule, f.line) for f in found] \
        == [("blocking-under-lock", 15)]
    # outside the serving stack a lock may be held across it
    assert panalysis.check_source(src, path="pkg/models/tier.py",
                                  rule_names=["blocking-under-lock"]) == []


@pytest.mark.parametrize("factory", ["new_lock", "new_rlock"])
def test_the_locks_the_concurrency_factories_build_are_seen(factory):
    src = textwrap.dedent("""
        import time

        from predictionio_tpu_torch.concurrency import {factory}

        class Tier:
            def __init__(self):
                self._lock = {factory}("Tier._lock")
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1
                    time.sleep(0.01)

            def read(self):
                return self._n
    """).replace("{factory}", factory)
    found = panalysis.check_source(src, path="pkg/server/tier.py")
    assert [(f.rule, f.line) for f in found] == [
        ("blocking-under-lock", 14), ("unguarded-shared-state", 17)]


def test_a_kernel_launch_under_a_lock_is_found_through_a_helper():
    found = panalysis.check_project({
        "pkg/models/serve.py": textwrap.dedent("""
            from predictionio_tpu_torch.ops.fused_topk import fused_topk

            def topk(u, i, v):
                return fused_topk(u, i, v, k=10)
        """),
        "pkg/server/srv.py": textwrap.dedent("""
            import threading

            from pkg.models.serve import topk

            class Server:
                def __init__(self):
                    self._lock = threading.Lock()

                def answer(self, u, i, v):
                    with self._lock:
                        return topk(u, i, v)
        """)}, rule_names=["blocking-under-lock"])
    assert [(f.path, f.line) for f in found] == [("pkg/server/srv.py", 12)]
    assert "fused_topk" in found[0].message
    assert [p for p, _, _ in found[0].related] == ["pkg/models/serve.py"]


# ---------------------------------------------------------------------------
# formats and baselines, byte for byte
# ---------------------------------------------------------------------------

FORMAT_PROJECT = {
    "pkg/utils/convert.py": textwrap.dedent("""
        import numpy as np

        def land(x):
            return np.asarray(x)
    """),
    "pkg/server/handler.py": textwrap.dedent("""
        import threading
        import time

        from pkg.utils.convert import land

        class H:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def inc(self):
                with self._lock:
                    self._n += 1
                    time.sleep(0.1)

            def handle(self, q):
                return land(q), self._n
    """),
}


def _findings(pkg):
    return pkg.check_project(FORMAT_PROJECT,
                             rule_names=sorted(SHARED))


def test_the_format_project_has_findings_with_chains():
    found = _findings(panalysis)
    assert {f.rule for f in found} == {
        "host-sync-in-hot-path", "blocking-under-lock",
        "unguarded-shared-state"}
    assert any(f.related for f in found)
    assert [_plain(f) for f in found] \
        == [_plain(f) for f in _findings(janalysis)]


def test_json_is_byte_for_byte_the_jax_packages():
    found = _findings(panalysis)
    assert panalysis.findings_to_json(found) \
        == janalysis.findings_to_json(_findings(janalysis))
    assert panalysis.findings_to_json([]) == janalysis.findings_to_json([])


@pytest.mark.parametrize("registry", ["port", "jax"])
def test_sarif_is_byte_for_byte_the_jax_packages(registry):
    rules = {"port": panalysis.RULES, "jax": janalysis.RULES}[registry]
    found = _findings(panalysis)
    assert panalysis.findings_to_sarif(found, rules) \
        == janalysis.findings_to_sarif(_findings(janalysis), rules)
    shared = {n: panalysis.RULES[n] for n in sorted(SHARED)}
    assert panalysis.findings_to_sarif([], shared) \
        == janalysis.findings_to_sarif([], shared)


def test_baselines_are_byte_equal_and_cross_read(tmp_path):
    found = _findings(panalysis)
    jfound = _findings(janalysis)
    p, j = tmp_path / "port.json", tmp_path / "jax.json"
    assert panalysis.write_baseline(str(p), found) \
        == janalysis.write_baseline(str(j), jfound)
    assert p.read_bytes() == j.read_bytes()
    assert panalysis.load_baseline(str(j)) == janalysis.load_baseline(str(p))
    # the ratchet: each package shrinks a baseline the other wrote
    cap = janalysis.load_baseline(str(j))
    panalysis.write_baseline(str(p), found[:1], cap=cap)
    janalysis.write_baseline(str(j), jfound[:1],
                             cap=panalysis.load_baseline(str(j)))
    assert p.read_bytes() == j.read_bytes()
    base = panalysis.load_baseline(str(p))
    assert [_plain(f) for f in panalysis.new_findings(found, base)] \
        == [_plain(f) for f in janalysis.new_findings(jfound, base)]
    assert panalysis.shrinkable_entries(found[:0], base) \
        == janalysis.shrinkable_entries(jfound[:0], base)


def test_the_atomic_write_funnel_is_shared_in_shape(tmp_path):
    path = tmp_path / "state.json"
    pbaseline.atomic_write_text(str(path), "one\n")
    pbaseline.atomic_write_text(str(path), "two\n")
    assert path.read_text() == "two\n"
    assert [p.name for p in tmp_path.iterdir()] == ["state.json"]


# ---------------------------------------------------------------------------
# smem-overbudget
# ---------------------------------------------------------------------------

SMEM_MODULE = '''
SMEM_LIMIT = 232_448
DEFAULT_LIMIT = 48 * 1024


def tile_bytes(point):
    (r,) = point
    return r * 1024


def grid():
    for r in range(1, 65):
        yield (r,)


def never(point, nbytes):
    return False


KERNELS = {
    "tile": {
        "source": "tile.cu",
        "launch": "tile_kernel",
        "export": "tile_smem_bytes",
        "args": ("r",),
        "bytes": tile_bytes,
        "grid": grid,
        "refuses": never,
    },
}
'''

TILE_CU = '''
__global__ void tile_kernel(float* x) {}

int launch(int r, float* x, cudaStream_t s) {
  const size_t smem = r * 1024;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  tile_kernel<<<1, 256, smem, s>>>(x);
  return 0;
}
'''

PLAIN_CU = '''
__global__ void plain_kernel(float* x) {}

int plain(float* x, cudaStream_t s) {
  const size_t smem = 50 * 1024;
  // a comment: other_kernel<<<1, 1, 99999999, s>>>() is not a launch
  plain_kernel<<<1, 256, smem, s>>>(x);
  plain_kernel<<<1, 256, 0, s>>>(x);
  plain_kernel<<<1, 256, 4096, s>>>(x);
  return 0;
}
'''


def _smem_tree(tmp_path, module=SMEM_MODULE, sources=None):
    pkg = tmp_path / "pkg"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    (pkg / "ops" / "smem.py").write_text(module)
    for name, text in (sources or {"tile.cu": TILE_CU}).items():
        (pkg / "csrc" / name).write_text(text)
    return pkg


def _smem_findings(pkg):
    return panalysis.run_check([str(pkg)], rule_names=["smem-overbudget"])


def test_a_kernel_within_the_budget_is_clean(tmp_path):
    assert _smem_findings(_smem_tree(tmp_path)) == []


def test_a_formula_past_the_limit_at_one_grid_point_is_found(tmp_path):
    module = SMEM_MODULE.replace(
        "return r * 1024",
        "return 232_449 if r == 17 else r * 1024")
    found = _smem_findings(_smem_tree(tmp_path, module))
    assert [(f.rule, Path(f.path).name, f.line) for f in found] \
        == [("smem-overbudget", "tile.cu", 12)]
    assert "232,449 bytes" in found[0].message
    assert "r=17" in found[0].message


def test_a_point_the_launcher_refuses_is_not_a_finding(tmp_path):
    module = SMEM_MODULE.replace(
        "return r * 1024", "return 10 ** 6 if r == 17 else r * 1024"
    ).replace("    return False", "    return nbytes > SMEM_LIMIT")
    assert _smem_findings(_smem_tree(tmp_path, module)) == []


def test_a_50kb_launch_without_the_opt_in_is_found(tmp_path):
    pkg = _smem_tree(tmp_path, sources={"tile.cu": TILE_CU,
                                        "plain.cu": PLAIN_CU})
    found = _smem_findings(pkg)
    assert [(Path(f.path).name, f.line) for f in found] \
        == [("plain.cu", 7)]
    assert "51,200 bytes" in found[0].message
    assert "cudaFuncSetAttribute(plain_kernel" in found[0].message


def test_an_unknown_dynamic_size_needs_the_opt_in(tmp_path):
    cu = PLAIN_CU.replace("const size_t smem = 50 * 1024;",
                          "const size_t smem = bytes_for(x);")
    found = _smem_findings(_smem_tree(tmp_path, sources={"plain.cu": cu}))
    assert [(Path(f.path).name, f.line) for f in found] \
        == [("plain.cu", 7)]
    assert "no formula" in found[0].message


def test_the_opt_in_must_name_the_launched_kernel(tmp_path):
    cu = TILE_CU.replace("        tile_kernel, cudaFuncAttribute",
                         "        other_kernel, cudaFuncAttribute")
    found = _smem_findings(_smem_tree(tmp_path, sources={"tile.cu": cu}))
    assert [(Path(f.path).name, f.line) for f in found] == [("tile.cu", 12)]


def test_a_c_pragma_suppresses(tmp_path):
    cu = PLAIN_CU.replace(
        "  plain_kernel<<<1, 256, smem, s>>>(x);",
        "  // ptpu: allow[smem-overbudget] — the card of this test opts in\n"
        "  // elsewhere\n"
        "  plain_kernel<<<1, 256, smem, s>>>(x);")
    assert _smem_findings(_smem_tree(
        tmp_path, sources={"plain.cu": cu})) == []
    module = SMEM_MODULE.replace(
        "return r * 1024", "return 232_449 if r == 17 else r * 1024")
    cu = TILE_CU.replace("  tile_kernel<<<",
                         "  // ptpu: allow[smem-overbudget] — test\n"
                         "  tile_kernel<<<")
    assert _smem_findings(_smem_tree(
        tmp_path / "b", module, {"tile.cu": cu})) == []


def test_a_formula_module_that_imports_is_refused(tmp_path):
    found = _smem_findings(_smem_tree(tmp_path, "import os\n"
                                      + SMEM_MODULE))
    assert len(found) == 1 and "imports" in found[0].message


@pytest.mark.parametrize("body", [
    'open({marker!r}, "w").write("ran")',
    '__import__("os").system("touch " + {marker!r})',
    'exec("open({marker!r}, \'w\')")',
    '().__class__.__base__.__subclasses__()',
    'getattr(1, "real")',
    '(lambda: 0).__globals__',
])
def test_the_formula_module_is_never_executed(tmp_path, body):
    marker = str(tmp_path / "ran")
    module = SMEM_MODULE.replace(
        "    (r,) = point\n",
        "    (r,) = point\n    " + body.format(marker=marker) + "\n")
    found = _smem_findings(_smem_tree(tmp_path, module))
    assert len(found) == 1 and "formula subset" in found[0].message, found
    assert not Path(marker).exists()


@pytest.mark.parametrize("source,why", [
    ("x = 0\nwhile True:\n    x += 1\n", "steps"),
    ("x = 1\nfor _ in range(100):\n    x = x * x + 1\n", "bits"),
    ("x = 2 ** 100000\n", "exponent"),
    ("x = sum(range(10 ** 9))\n", "steps"),
    ("def f():\n    return f()\nx = f()\n", "RecursionError"),
    ("x = 1.5\n", "float constant"),
])
def test_the_interpreter_bounds_a_runaway_formula(source, why):
    with pytest.raises(pinterp.FormulaError, match=why):
        pinterp.interpret(ast.parse(source), max_steps=100_000)


def test_the_interpreter_gives_the_modules_own_numbers():
    """Every formula and grid of ``ops/smem.py``, interpreted, equals the
    module run by Python."""
    tree = ast.parse((PORT / "ops" / "smem.py").read_text())
    it, ns = pinterp.interpret(tree)
    for name, spec in smem.KERNELS.items():
        grid = it.call(ns["KERNELS"][name]["grid"])
        assert grid == list(spec["grid"]()), name
        for point in grid[::7]:
            nbytes = spec["bytes"](point)
            assert it.call(ns["KERNELS"][name]["bytes"], point) == nbytes
            assert it.call(ns["KERNELS"][name]["refuses"], point, nbytes) \
                == spec["refuses"](point, nbytes)
    with pytest.raises(pinterp.FormulaError, match="raised ValueError"):
        it.call(ns["topk_fit"], 10 ** 6, 8, 128)


def test_the_ports_csrc_is_clean():
    assert panalysis.run_check([str(PORT)],
                               rule_names=["smem-overbudget"]) == []


def test_every_launch_in_the_ports_csrc_is_read():
    kernels = {}
    for path in sorted((PORT / "csrc").iterdir()):
        for launch in pkernels._launches(str(path), path.read_text()):
            kernels[launch.kernel] = (path.name, launch.smem,
                                      launch.opted_in)
    assert kernels == {
        "kernel": ("chol_solve.cu", "smem", True),
        "fused_topk_kernel<T>": ("fused_topk.cu", "smem", True),
        "merge_topk_kernel": ("fused_topk.cu", "0", False),
        "kern": ("gram_table.cu", "smem", True),
        "gram_tile::sum_partials": ("gram_table.cu", "0", False),
        "gram_rows_kernel<T>": ("gram_tile.cuh", "smem", True),
        "sum_partials": ("gram_tile.cuh", "0", False),
    }


def test_the_largest_points_fit_the_h100():
    report = pkernels.smem_report(str(PORT / "ops" / "smem.py"))
    assert set(report) == {"fused_topk", "chol_solve", "fused_gram",
                           "gram_table"}
    for entry in report.values():
        assert 0 < entry["bytes"] <= smem.SMEM_LIMIT
    assert report["fused_gram"] == {"point": {"r": 128, "itemsize": 4},
                                    "bytes": 66_560}
    assert report["chol_solve"]["point"] == {"rp": 128, "warps": 1}


def _topk_c_bytes(row_bytes, qb, chunk, k):
    """csrc/fused_topk.cu smem_bytes, transcribed."""
    sw = (row_bytes + 31) // 32 * 8 + 4
    lst = 32 if k <= 32 else 128
    return 4 * (2 * chunk * sw + qb * sw + 4 * qb + 2 * qb * lst
                + 2 * qb * chunk)


def _chol_c_bytes(R, warps):
    """csrc/chol_solve.cu reg_smem_bytes / shm_smem_bytes, transcribed."""
    if R <= 64:
        gw = 1
        while gw < R // 2:
            gw *= 2
        tri = 4 * (R // 4 + 1) * (2 * (R // 4) + R % 4)  # tri_offset(R)
        return warps * (32 // gw) * (2 * (R + 8) + tri) * 4
    return warps * (R * (R + 4) + 2 * R) * 4


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_smem_gives_the_numbers_topk_plan_gives(itemsize):
    grid = set(smem._topk_grid())
    for r in range(1, smem.TOPK_MAX_RANK + 1):
        for k in (1, 16, 32, 33, 100, 128):
            for B in (1, 7, 8, 9, 63, 64, 65, 2048):
                plan = ft.topk_plan(B, 26_744, r, itemsize, k)
                want = _topk_c_bytes(r * itemsize, plan.qb, plan.chunk, k)
                assert plan.smem_bytes == want
                assert smem.topk_smem_bytes(r * itemsize, plan.qb,
                                            plan.chunk, k) == want
                kclass = 32 if k <= 32 else 128
                assert (r * itemsize, plan.qb, plan.chunk, kclass) in grid
                assert plan.smem_bytes <= smem.SMEM_LIMIT


def test_smem_gives_the_numbers_solve_plan_gives():
    grid = set(smem._chol_grid())
    for r in range(1, solve.CHOL_MAX_RANK + 1):
        for n in (1, 39, 1000, 4096, 138_493):
            p = solve.solve_plan(r, n)
            assert p.smem_bytes == _chol_c_bytes(p.rank, p.warps_per_block)
            assert (p.rank, p.warps_per_block) in grid


def _table_c_words(r, itemsize):
    """csrc/gram_table.cu row_words, transcribed."""
    w = (r + 15) // 16 * 16 * itemsize // 4
    return w + {0: 8, 4: 4, 8: 0, 12: 12, 16: 8, 20: 4, 24: 0, 28: 12}[w % 32]


def test_smem_gram_formulas_are_the_tiles():
    """fused_gram's tile (gram_tile.cuh stage_bytes) and gram_table's
    two paths (gram_table.cu table_smem), transcribed."""
    for r in range(1, 129):
        for itemsize in (4, 2):
            staging = 2 * 32 * ((r + 7) // 8 * 8) * itemsize + 3 * 32 * 12
            want = max(staging, (r * (r + 1) + r) * 4)
            assert smem.gram_stage_bytes(r, itemsize) == want
            words = _table_c_words(r, itemsize)
            assert words % 32 in (8, 24)
            assert words * 4 >= (r + 15) // 16 * 16 * itemsize
            assert smem.gram_resident_bytes(3, r, itemsize) == 4 * words * 4
            assert smem.gram_table_bytes(1, 3, r, itemsize, 7) \
                == 4 * words * 4
            assert smem.gram_table_bytes(2, 3, r, itemsize, 7) \
                == 7 * 2 * 32 * words * 4


def test_smem_module_imports_nothing():
    tree = ast.parse((PORT / "ops" / "smem.py").read_text())
    assert not [n for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))]


# ---------------------------------------------------------------------------
# the registry, the repo-wide gate and the cross-check
# ---------------------------------------------------------------------------

#: the port's rules over csrc/ and the ops/ wrappers: smem-overbudget
#: (for vmem-overbudget) and the JAX package's three Pallas safety rules
KERNEL_RULES = {"smem-overbudget", "dma-unwaited",
                "low-precision-accumulator", "missing-interpret-fallback"}
#: the numerics family, read in torch's idiom (its descriptions name
#: torch's spellings; tests/test_torch_numerics.py holds it to the JAX
#: package's cases)
NUMERICS_RULES = {"low-precision-reduction", "dequant-outside-funnel",
                  "quantize-without-parity-gate", "unguarded-domain",
                  "requant-torn-pair"}


def test_rule_catalogue():
    assert set(panalysis.RULES) == SHARED | KERNEL_RULES | NUMERICS_RULES
    for name in KERNEL_RULES:
        assert panalysis.RULES[name].project, name
    for name in NUMERICS_RULES:
        assert panalysis.RULES[name].project \
            == janalysis.RULES[name].project, name
    for name in SHARED - {"host-sync-in-hot-path"}:
        assert panalysis.RULES[name].description \
            == janalysis.RULES[name].description, name
        assert panalysis.RULES[name].project \
            == janalysis.RULES[name].project, name


def test_the_exports_are_the_jax_packages_less_the_jax_program_rules():
    left_out = {"NUMERICS_RULES", "SHARDING_RULES",
                "count_sharding_pragmas"}
    assert set(panalysis.__all__) == set(janalysis.__all__) - left_out


def test_the_not_ported_rules_are_named_in_the_registry():
    doc = prules.__doc__
    for name in set(janalysis.RULES) - SHARED:
        if name != "vmem-overbudget":
            assert f"``{name}``" in doc, name


def test_the_catalogs_left_out_map_is_the_telemetry_tests():
    """One map: the telemetry test reads the catalog's and keeps no copy
    of its own."""
    tree = ast.parse((ROOT / "tests" / "test_torch_telemetry.py")
                     .read_text())
    imported = [n for n in tree.body if isinstance(n, ast.ImportFrom)
                and n.module == "predictionio_tpu_torch.analysis."
                "metrics_catalog"
                and any(a.name == "LEFT_OUT" and a.asname is None
                        for a in n.names)]
    assigned = [n for n in ast.walk(tree)
                if isinstance(n, (ast.Assign, ast.AnnAssign))
                and "LEFT_OUT" in {t.id for t in ast.walk(n)
                                   if isinstance(t, ast.Name)
                                   and isinstance(t.ctx, ast.Store)}]
    assert imported and not assigned


def test_a_documented_family_the_port_lacks_is_a_finding(monkeypatch,
                                                          tmp_path):
    doc = tmp_path / "observability.md"
    doc.write_text("| `pio_queries_total` | counter |\n"
                   "| `pio_compiles_since_warm` | gauge |\n"
                   "| `pio_never_emitted_total` | counter |\n")
    monkeypatch.setattr(pcatalog, "CATALOG_PATH", str(doc))
    src = ('def mount(reg):\n'
           '    reg.counter("pio_queries_total", "q")\n'
           '    reg.counter("pio_undocumented_total", "u")\n')
    found = panalysis.check_source(src, path="pkg/server/m.py",
                                   rule_names=["metric-catalog-drift"])
    assert sorted((f.path, f.line) for f in found) == [
        (os.path.join("docs", "observability.md"), 3),
        ("pkg/server/m.py", 3)]


def test_the_ports_package_is_clean():
    t0 = time.time()
    findings = panalysis.run_check([str(PORT)])
    assert findings == [], "\n".join(f.format() for f in findings)
    assert time.time() - t0 < 30


def test_the_jax_checker_over_the_port_finds_only_the_lane_families():
    """The JAX package's checker, its shared rules over the port: the
    only findings it had were the replicated lanes' catalog families the
    port left out; with the lanes ported it finds none."""
    findings = janalysis.run_check([str(PORT)], rule_names=sorted(SHARED))
    assert [(f.rule, f.path, f.message) for f in findings] == []


def test_the_cli_check_runs_without_torch_or_jax():
    code = textwrap.dedent("""
        import sys
        from predictionio_tpu_torch import cli
        rc = cli.main(["check"])
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                            "predictionio_tpu"))
        print("RC", rc, "LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ptpu check: clean." in out.stdout
    assert "RC 0 LOADED []" in out.stdout


def test_the_cli_check_flags_and_exit_codes(tmp_path, capsys):
    bad = tmp_path / "server" / "bad.py"
    bad.parent.mkdir()
    bad.write_text("import torch\n\ndef handler(t):\n"
                   "    return t.cpu()\n")
    assert pcli.main(["check", str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert "host-sync-in-hot-path" in out.out and "1 finding(s)" in out.err
    assert pcli.main(["check", str(tmp_path), "--rule",
                      "hot-spin-loop"]) == 0
    assert pcli.main(["check", str(tmp_path), "--rule", "nope"]) == 2
    assert pcli.main(["check", "--list-rules"]) == 0
    assert "smem-overbudget" in capsys.readouterr().out

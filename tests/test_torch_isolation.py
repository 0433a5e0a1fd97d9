"""The port stands alone: no JAX, no ml_dtypes, nothing of the JAX
package, and no silent CPU default."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import predictionio_tpu_torch
from predictionio_tpu_torch.utils.device import card_info, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "predictionio_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "predictionio_tpu"}


def port_files():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = sorted(set(imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("sub", ["streaming", "faults", "rollout", "cache",
                                 "obs", "workflow", "e2", "concurrency",
                                 "slo", "router", "fleet"])
def test_the_copied_subpackages_are_scanned(sub):
    """The stream and pipeline slices' subpackages are the port's own
    copies: each is in the scan above, and none reaches the JAX
    package's copy."""
    scanned = {p.relative_to(PACKAGE).parts[0] for p in port_files()
               if p.is_relative_to(PACKAGE)}
    assert sub in scanned
    files = sorted((PACKAGE / sub).rglob("*.py"))
    assert files
    for path in files:
        assert not set(imported_roots(path)) & FORBIDDEN, path


def test_the_pipeline_modules_are_scanned():
    scanned = set(port_files())
    for rel in ("obs/overlap.py", "workflow/batch_predict.py",
                "server/engineserver.py"):
        assert PACKAGE / rel in scanned, rel


@pytest.mark.parametrize("rel", [
    "utils/memo.py", "controller/metric.py", "controller/evaluation.py",
    "controller/fast_eval.py", "controller/__init__.py",
    "examples/recommendation_evaluation.py", "ops/launches.py",
    "workflow/core.py", "templates/recommendation.py", "models/data.py"])
def test_the_eval_modules_are_scanned(rel):
    """The eval slice's modules, the port's own copies of JAX-package
    modules that load no JAX among them, are in the scan above."""
    assert PACKAGE / rel in set(port_files()), rel
    assert not set(imported_roots(PACKAGE / rel)) & FORBIDDEN, rel


@pytest.mark.parametrize("rel", [
    "data/aggregation.py", "data/store.py", "data/storage/base.py",
    "data/storage/sqlite.py", "controller/base.py",
    "templates/__init__.py", "templates/_common.py",
    "templates/ecommerce.py", "templates/similarproduct.py",
    "models/cooccurrence.py", "workflow/persistence.py", "cli.py",
    "templates/classification.py", "templates/sequential.py",
    "models/classify.py", "models/seqrec.py", "models/convert.py",
    "ops/ring_attention.py", "e2/__init__.py", "e2/naive_bayes.py",
    "e2/markov_chain.py", "e2/vectorizer.py", "e2/cross_validation.py",
    "examples/sequential_evaluation.py"])
def test_the_template_modules_are_scanned(rel):
    """The template slices' modules (e-commerce and similar-product;
    classification, sequential and ``e2/``), the port's own copies of
    JAX-package modules, are in the scan above."""
    assert PACKAGE / rel in set(port_files()), rel
    assert not set(imported_roots(PACKAGE / rel)) & FORBIDDEN, rel


@pytest.mark.parametrize("rel", [
    "obs/histogram.py", "obs/registry.py", "utils/tracing.py",
    "obs/runtime.py", "obs/trace.py", "obs/hotkeys.py", "obs/numerics.py",
    "obs/__init__.py", "server/http.py", "server/plugins.py",
    "server/stats.py", "data/webhooks/__init__.py",
    "data/webhooks/segmentio.py", "data/webhooks/mailchimp.py",
    "server/eventserver.py", "server/engineserver.py",
    "streaming/trainer.py", "server/adminserver.py",
    "server/dashboard.py", "cli.py"])
def test_the_observability_modules_are_scanned(rel):
    """The observability slice's modules, the port's own copies of
    JAX-package modules that load no JAX among them, are in the scan
    above."""
    assert PACKAGE / rel in set(port_files()), rel
    assert not set(imported_roots(PACKAGE / rel)) & FORBIDDEN, rel


@pytest.mark.parametrize("rel", [
    "cache/__init__.py", "cache/bus.py", "cache/lru.py",
    "cache/singleflight.py", "cache/hot.py", "cache/hierarchy.py"])
def test_the_cache_modules_are_scanned(rel):
    """The serving caches, the port's own copies of the JAX package's
    ``cache/`` modules, are in the scan above."""
    assert PACKAGE / rel in set(port_files()), rel
    assert not set(imported_roots(PACKAGE / rel)) & FORBIDDEN, rel


@pytest.mark.parametrize("rel", [
    "data/storage/localfs.py", "data/storage/segmentfs.py",
    "data/storage/objectstore.py", "data/storage/remote.py",
    "data/storage/wire.py", "data/storage/registry.py",
    "data/storage/sqlite.py", "data/columnar.py",
    "server/storageserver.py", "native/__init__.py",
    "data/entitymap.py", "data/view.py", "controller/cleaning.py"])
def test_the_storage_backend_modules_are_scanned(rel):
    """The storage backends' modules, the port's own copies of the JAX
    package's, are in the scan above and import no pandas (the card's
    machine has none)."""
    assert PACKAGE / rel in set(port_files()), rel
    assert not set(imported_roots(PACKAGE / rel)) & (FORBIDDEN | {"pandas"})


def test_every_module_imports():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        name = ".".join(p for p in rel.parts if p != "__init__")
        importlib.import_module(name)
    assert predictionio_tpu_torch.__version__


def test_server_import_loads_no_jax():
    code = ("import sys, predictionio_tpu_torch.server.engineserver, "
            "predictionio_tpu_torch.cli, predictionio_tpu_torch.models.als, "
            "predictionio_tpu_torch.ops.fused_gram, "
            "predictionio_tpu_torch.ops.solve, "
            "predictionio_tpu_torch.controller.engine, "
            "predictionio_tpu_torch.server.eventserver, "
            "predictionio_tpu_torch.workflow.core, "
            "predictionio_tpu_torch.data.storage.registry, "
            "predictionio_tpu_torch.ops.gram, "
            "predictionio_tpu_torch.streaming, "
            "predictionio_tpu_torch.faults, "
            "predictionio_tpu_torch.rollout.policy, "
            "predictionio_tpu_torch.cache.bus, "
            "predictionio_tpu_torch.cache, "
            "predictionio_tpu_torch.cache.lru, "
            "predictionio_tpu_torch.cache.singleflight, "
            "predictionio_tpu_torch.cache.hot, "
            "predictionio_tpu_torch.cache.hierarchy, "
            "predictionio_tpu_torch.controller, "
            "predictionio_tpu_torch.controller.evaluation, "
            "predictionio_tpu_torch.controller.fast_eval, "
            "predictionio_tpu_torch.utils.memo, "
            "predictionio_tpu_torch.examples.recommendation_evaluation, "
            "predictionio_tpu_torch.examples.sequential_evaluation, "
            "predictionio_tpu_torch.templates, "
            "predictionio_tpu_torch.obs, "
            "predictionio_tpu_torch.obs.numerics, "
            "predictionio_tpu_torch.server.plugins, "
            "predictionio_tpu_torch.server.stats, "
            "predictionio_tpu_torch.data.webhooks, "
            "predictionio_tpu_torch.utils.tracing, "
            "predictionio_tpu_torch.e2, "
            "predictionio_tpu_torch.data.storage.localfs, "
            "predictionio_tpu_torch.data.storage.segmentfs, "
            "predictionio_tpu_torch.data.storage.objectstore, "
            "predictionio_tpu_torch.data.storage.remote, "
            "predictionio_tpu_torch.server.storageserver, "
            "predictionio_tpu_torch.native, "
            "predictionio_tpu_torch.data.entitymap, "
            "predictionio_tpu_torch.data.view, "
            "predictionio_tpu_torch.controller.cleaning; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'predictionio_tpu', "
            "'pandas')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_surrogate_generator_imports_numpy_and_stdlib_only():
    """``chip_smoke.py`` loads ``benchmarks/ml20m_surrogate.py`` by path,
    so it must need nothing past numpy and the standard library."""
    path = ROOT / "benchmarks" / "ml20m_surrogate.py"
    roots = set(imported_roots(path))
    extra = {m for m in roots - {"numpy"}
             if m not in sys.stdlib_module_names}
    assert not extra, f"ml20m_surrogate.py imports {sorted(extra)}"
    code = ("import importlib.util, sys; spec = importlib.util."
            f"spec_from_file_location('s', {str(path)!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'torch', 'predictionio_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        card_info()
    assert resolve_device("cpu") == torch.device("cpu")
    assert card_info("cpu")["name"] == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_chip_smoke_needs_the_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; alone
    in a directory (no package beside it) it fails too."""
    for cwd in (ROOT, tmp_path):
        script = ROOT / "chip_smoke.py"
        if cwd == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True,
            text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_a_jax_package_factory_resolves_to_the_port():
    """The shipped variants name ``predictionio_tpu...:factory``; the
    port's CLI reads that as its own module and never imports the JAX
    package, not even by name through ``importlib``."""
    code = ("import sys, json; from predictionio_tpu_torch import cli; "
            "spec = json.load(open('examples/recommendation/engine.json'))"
            "['engineFactory']; "
            "assert spec.startswith('predictionio_tpu.'), spec; "
            "engine, ep = cli.engine_from_variant("
            "json.load(open('examples/recommendation/engine.json'))); "
            "assert type(engine).__module__.startswith("
            "'predictionio_tpu_torch.'), type(engine).__module__; "
            "assert ep.datasource[1].app_name == 'MyApp1'; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'predictionio_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

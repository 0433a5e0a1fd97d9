"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``<root>/<hash>/``. The hash covers the source and the flags, so an
edited kernel rebuilds and an unchanged one loads from disk. Nothing is
built at import: ``pio build`` builds every source ahead
(:func:`build_all`), a deploy loads what it serves with at bind
(:func:`load_all`), and otherwise the first call that needs a kernel
builds it. A missing ``nvcc`` or a failed build raises.

The root is resolved once a process: ``--artifact-dir D`` through
:func:`set_root` gives ``D/torch_kernels``, else
``$PTPU_ARTIFACT_DIR/torch_kernels``, else ``build/torch_kernels``
beside the package (:data:`BUILD_ROOT`). Libraries are cached by name
once loaded, so moving the root after a load raises: one process never
mixes two builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the kernel root where neither ``--artifact-dir`` nor
#: ``$PTPU_ARTIFACT_DIR`` names one
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: flags of one source on top of :data:`NVCC_FLAGS`: ``gram_table.cu``'s
#: 32 kernels are optimized on every core, or its build alone would set
#: the wall time of every cold build (phase ``console`` of
#: ``chip_smoke.py`` times each source's ``nvcc``)
SOURCE_FLAGS: Dict[str, Tuple[str, ...]] = {
    "gram_table": ("--split-compile=0",)}

#: held while a library builds or loads: a kernel call that needs a
#: library being built waits here, never half-built
_lock = threading.RLock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: the libraries this process compiled: when each build ended
#: (``time.monotonic``) and the seconds its nvcc ran
_compiled: Dict[str, Tuple[float, float]] = {}
#: this process's kernel root, None until :func:`set_root` or first use
_root: Optional[Path] = None


def artifact_root(artifact_dir: str = "") -> Path:
    """The kernel root an ``--artifact-dir`` names: the flag, then
    ``$PTPU_ARTIFACT_DIR`` (the JAX package's flag and variable), each
    with ``torch_kernels`` below it, then :data:`BUILD_ROOT`."""
    base = artifact_dir or os.environ.get("PTPU_ARTIFACT_DIR", "")
    return Path(base).expanduser().resolve() / "torch_kernels" if base \
        else BUILD_ROOT


def set_root(artifact_dir: str = "") -> Path:
    """Fix this process's kernel root (:func:`artifact_root`); raises if
    a library was already loaded from another root."""
    global _root
    new = artifact_root(artifact_dir)
    with _lock:
        current = _root if _root is not None else artifact_root()
        if _loaded and new != current:
            raise RuntimeError(
                f"kernel root is {current}, where {sorted(_loaded)} are "
                f"loaded from; cannot move it to {new} in this process")
        _root = new
    return new


def root() -> Path:
    """This process's kernel root, resolved on first use."""
    global _root
    with _lock:
        if _root is None:
            _root = artifact_root()
        return _root


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor /usr/local/cuda/bin): the "
            "CUDA kernels of predictionio_tpu_torch build only where the "
            "CUDA toolkit is installed")
    return nvcc


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ())).encode())
    return root() / digest.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, nvcc: str) -> "subprocess.Popen[str] | None":
    """Start ``nvcc`` for one source unless its library is already built;
    the compiler's log goes to a file beside the library."""
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    with open(tmp.with_suffix(".log"), "w") as log_f:
        return subprocess.Popen(cmd, stdout=log_f,
                                stderr=subprocess.STDOUT, text=True)


def build_timed(names: Iterable[str], timeout: float = 600.0
                ) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Returns, for each name, ``compiled``
    (False: it was on disk), the seconds its ``nvcc`` ran and its log.
    Raises on any failed build."""
    names = list(names)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = {n: _start(n, nvcc) for n in names}
    out = {n: {"compiled": False, "seconds": 0.0, "log": ""}
           for n, p in procs.items() if p is None}
    running = {n: p for n, p in procs.items() if p is not None}
    deadline = t0 + timeout
    timed_out = set()
    while running:
        for name, proc in list(running.items()):
            if proc.poll() is None:
                if time.perf_counter() < deadline:
                    continue
                proc.kill()
                proc.wait()
                timed_out.add(name)
            out[name] = {"compiled": True,
                         "seconds": time.perf_counter() - t0}
            del running[name]
        if running:
            time.sleep(0.01)
    failed: List[str] = []
    for name, proc in procs.items():
        if proc is None:
            continue
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        log_path = tmp.with_suffix(".log")
        log = log_path.read_text()
        log_path.unlink()
        if name in timed_out:
            log += f"\nnvcc timed out after {timeout:.0f}s"
        out[name]["log"] = log
        if proc.returncode != 0 or not tmp.exists():
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, _target(name))  # atomic: readers never see half a file
        _compiled[name] = (time.monotonic(), out[name]["seconds"])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return out


def build(names: Iterable[str], timeout: float = 600.0) -> Dict[str, str]:
    """:func:`build_timed`'s compiler logs alone (empty for a library
    that was already on disk)."""
    return {n: r["log"] for n, r in build_timed(names, timeout).items()}


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def built(names: Optional[Iterable[str]] = None) -> List[str]:
    """The libraries of ``names`` (default: every source) already on
    disk under the root for this tree's sources and flags."""
    return [n for n in (all_sources() if names is None else names)
            if _target(n).exists()]


def build_all(timeout: float = 600.0) -> dict:
    """Build every source into the root (``pio build``): ``{"root",
    "libraries": {name: {"compiled", "seconds", "log"}}, "seconds"}``."""
    t0 = time.perf_counter()
    libs = build_timed(all_sources(), timeout)
    return {"root": str(root()), "libraries": libs,
            "seconds": time.perf_counter() - t0}


def load_all(names: Iterable[str], since: Optional[float] = None,
             timeout: float = 600.0) -> dict:
    """Build what is missing of ``names`` and load every one (a deploy's
    bind), under the lock a kernel call takes to load its library:
    ``{"libraries": {name: {"compiled", "seconds"}}, "compileSeconds":
    wall seconds nvcc ran (0 when all were on disk), "seconds"}``. A
    library counts as compiled when its build in this process ended at
    or after ``since`` (``time.monotonic``; default: this call's start),
    so one a kernel call built first, after the bind, counts too."""
    names = list(dict.fromkeys(names))
    t0 = time.perf_counter()
    since = time.monotonic() if since is None else since
    with _lock:
        todo = [n for n in names if n not in _loaded]
        if todo:
            build_timed(todo, timeout)
        for n in todo:
            _loaded[n] = ctypes.CDLL(str(_target(n)))
        report = {}
        for n in names:
            ended, seconds = _compiled.get(n, (-1.0, 0.0))
            report[n] = ({"compiled": True, "seconds": seconds}
                         if ended >= since
                         else {"compiled": False, "seconds": 0.0})
    return {"libraries": report,
            "compileSeconds": max((r["seconds"] for r in report.values()
                                   if r["compiled"]), default=0.0),
            "seconds": time.perf_counter() - t0}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib

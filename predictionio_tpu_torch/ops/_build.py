"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/torch_kernels/<hash>/`` beside the package. The hash covers the
source and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. Nothing is built at import: the first call that needs a
kernel builds it. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

#: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


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
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, nvcc: str) -> "subprocess.Popen[str] | None":
    """Start ``nvcc`` for one source unless its library is already built."""
    so = _target(name)
    if so.exists():
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(names: Iterable[str], timeout: float = 600.0) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns each compiler log (empty for a
    library that was already on disk). Raises on any failed build."""
    names = list(names)
    nvcc = find_nvcc()
    procs = {n: _start(n, nvcc) for n in names}
    logs: Dict[str, str] = {}
    failed: List[str] = []
    for name, proc in procs.items():
        if proc is None:
            logs[name] = ""
            continue
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {timeout:.0f}s"
        logs[name] = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0 or not tmp.exists():
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, _target(name))  # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return logs


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib

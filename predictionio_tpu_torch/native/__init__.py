"""The host's native codec (``_codec.cpp``), the port's own copy of
``predictionio_tpu/native``: the JSON-lines to columnar segment codec
behind the SEGMENTFS bulk import and sidecar encode. It runs on the host,
never on the card.

The extension is compiled with ``g++`` (one ``-O2 -shared -fPIC``
invocation against this interpreter's headers) into the port's kernel
root (``ops/_build.py::root()``), under a name that carries the source's
digest, the Python version and the platform, so the two packages never
share a library and an edited source rebuilds. ``pio build`` builds it
beside the CUDA libraries; otherwise the first call that needs it does.

As in the JAX package, native code is an accelerator, never a
dependency: ``PTPU_NO_NATIVE=1`` selects the Python lane, and a missing
compiler or a failed build falls back to it. The fallback is visible: a
failed build logs at warning, and :func:`lane_counts` counts which lane
each block of work took.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
import uuid
from pathlib import Path
from typing import Dict, Optional

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "_codec.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
#: the loaded module (None: the Python lane), once tried
_state: dict = {}
#: blocks of work by operation and lane ("native" or "python")
_lanes: Dict[str, Dict[str, int]] = {}


def count_lane(op: str, lane: str, n: int = 1) -> None:
    """Count ``n`` blocks of ``op`` carried by ``lane``."""
    with _lock:
        d = _lanes.setdefault(op, {"native": 0, "python": 0})
        d[lane] += n


def lane_counts() -> Dict[str, Dict[str, int]]:
    """``{op: {"native": n, "python": n}}`` since the last reset."""
    with _lock:
        return {op: dict(d) for op, d in _lanes.items()}


def reset_lane_counts() -> None:
    with _lock:
        _lanes.clear()


def target() -> Path:
    """Where this source's library goes under the kernel root."""
    from ..ops import _build

    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    plat = sysconfig.get_platform().replace("-", "_")
    return (_build.root() / "native" /
            f"_codec-{digest.hexdigest()[:16]}-cp{sys.version_info.major}"
            f"{sys.version_info.minor}-{plat}.so")


def build(timeout: float = 120.0) -> dict:
    """Compile the codec unless it is built: ``{"path", "compiled",
    "seconds"}``. Raises on a failed build (``pio build`` reports it)."""
    import time

    out = target()
    if out.exists():
        return {"path": str(out), "compiled": False, "seconds": 0.0}
    out.parent.mkdir(parents=True, exist_ok=True)
    # a unique temporary name: builds racing on a shared root must not
    # interleave into one file
    tmp = out.with_name(f"{out.name}.tmp.{uuid.uuid4().hex}")
    cmd = ["g++", *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
           str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return {"path": str(out), "compiled": True,
            "seconds": time.perf_counter() - t0}


def _load() -> Optional[object]:
    try:
        path = build()["path"]
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("native codec build failed (%s); the Python lane "
                    "carries the codec's work", e)
        return None
    spec = importlib.util.spec_from_file_location(
        "predictionio_tpu_torch.native._codec", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception as e:  # noqa: BLE001 — an ABI mismatch and the like
        log.warning("native codec load failed (%s); the Python lane "
                    "carries the codec's work", e)
        return None
    return mod


def codec() -> Optional[object]:
    """The ``_codec`` extension module, or None (the Python lane). Tried
    once a process; ``PTPU_NO_NATIVE=1`` disables it."""
    with _lock:
        if "codec" not in _state:
            _state["codec"] = (None if os.environ.get("PTPU_NO_NATIVE")
                               == "1" else _load())
        return _state["codec"]

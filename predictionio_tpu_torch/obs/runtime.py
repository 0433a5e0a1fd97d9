"""Process-level runtime gauges: build info, the card's memory, host
resources (the port's copy of ``predictionio_tpu/obs/runtime.py``).

These helpers register the process-level series on any
:class:`.registry.MetricsRegistry`. A scrape NEVER initializes CUDA: an
event server scraping ``/metrics`` must not take the card just to report
on it, and ``torch.cuda.memory_stats`` would create a context where none
exists, so every device read is behind ``torch.cuda.is_initialized()``.

Left out (``ROADMAP.md``, "decided not to port"): the JAX package's
``pio_xla_compiles_total`` and ``pio_transfer_guard_violations_total``,
which count XLA compiles and XLA transfer-guard hits.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional

from .registry import MetricsRegistry, escape_label_value, format_value


def _live_torch():
    """The imported ``torch`` module once CUDA is initialized in this
    process, else None (a scrape must not be what initializes it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch if torch.cuda.is_initialized() else None
    except Exception:  # noqa: BLE001 — observability never requires CUDA
        return None


def hbm_stats() -> List[Dict[str, object]]:
    """Per-card memory, once CUDA is initialized in this process; empty
    otherwise (and on a CPU-only torch). ``bytesInUse`` is the caching
    allocator's ``allocated_bytes.all.current`` (the bytes tensors hold;
    the allocator's reserved but free blocks are not in use),
    ``peakBytesInUse`` its ``allocated_bytes.all.peak``, and
    ``bytesLimit`` the card's ``total_memory``. ``device`` is
    ``cuda:<index>`` and ``kind`` the card's name (on the H100 its memory
    is HBM3)."""
    torch = _live_torch()
    if torch is None:
        return []
    out: List[Dict[str, object]] = []
    try:
        n = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — a scrape never fails on the card
        return []
    for i in range(n):
        try:
            stats = torch.cuda.memory_stats(i)
            props = torch.cuda.get_device_properties(i)
        except Exception:  # noqa: BLE001 — per-device degrade
            continue
        out.append({
            "device": f"cuda:{i}",
            "kind": props.name,
            "bytesInUse": int(stats.get("allocated_bytes.all.current", 0)),
            "bytesLimit": int(props.total_memory),
            "peakBytesInUse": int(stats.get("allocated_bytes.all.peak", 0)),
        })
    return out


def build_info(server: str, version: Optional[str] = None
               ) -> Dict[str, object]:
    """The ``pio_build_info`` label set: the package and torch versions,
    the CUDA toolkit torch was built for (``none`` on a CPU-only torch),
    the process count and the cards this process uses. ``process_count``
    and ``devices`` read 0 until CUDA is initialized (the :func:`hbm_stats`
    rule)."""
    if version is None:
        from .. import __version__ as version
    torch = sys.modules.get("torch")
    info: Dict[str, object] = {
        "server": server, "version": version,
        "torch": getattr(torch, "__version__", "none"),
        "cuda": (getattr(getattr(torch, "version", None), "cuda", None)
                 or "none"),
        "process_count": 0, "devices": 0}
    live = _live_torch()
    if live is None:
        return info
    try:
        dist = live.distributed
        info["process_count"] = (dist.get_world_size()
                                 if dist.is_available()
                                 and dist.is_initialized() else 1)
        info["devices"] = int(live.cuda.device_count())
    except Exception:  # noqa: BLE001 — build info never fails a scrape
        pass
    return info


def process_stats() -> Dict[str, float]:
    """Host resources read from ``/proc`` (Linux only, no psutil): RSS
    bytes, cumulative CPU seconds (user + system), open fds, threads.
    Empty where ``/proc`` is absent."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        out["rss_bytes"] = float(int(fields[1]) * os.sysconf("SC_PAGESIZE"))
    except (OSError, ValueError, IndexError):
        return {}
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # the command name may hold spaces and parens: split after the
        # LAST ")"; rest[0] is field 3 (state), utime/stime are 14/15
        rest = stat.rsplit(")", 1)[1].split()
        out["cpu_seconds_total"] = ((int(rest[11]) + int(rest[12]))
                                    / float(os.sysconf("SC_CLK_TCK")))
        out["threads"] = float(int(rest[17]))
    except (OSError, ValueError, IndexError):
        pass
    try:
        out["open_fds"] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    return out


def register_process_metrics(reg: MetricsRegistry) -> None:
    """The ``pio_process_{rss_bytes,cpu_seconds_total,open_fds,threads}``
    gauges, each read from ``/proc`` at every scrape; nothing where
    ``/proc`` is absent."""
    if not process_stats():
        return

    def _read(key: str):
        return lambda: process_stats().get(key, 0.0)

    reg.gauge("pio_process_rss_bytes",
              "Resident set size of this server process "
              "(/proc/self/statm)", fn=_read("rss_bytes"))
    reg.gauge("pio_process_cpu_seconds_total",
              "Cumulative user+system CPU seconds of this process "
              "(/proc/self/stat)", fn=_read("cpu_seconds_total"))
    reg.gauge("pio_process_open_fds",
              "Open file descriptors (/proc/self/fd)",
              fn=_read("open_fds"))
    reg.gauge("pio_process_threads",
              "OS threads in this process (/proc/self/stat)",
              fn=_read("threads"))


def register_runtime_metrics(reg: MetricsRegistry, server: str,
                             version: Optional[str] = None) -> None:
    """Mount the process-level series on ``reg`` (once a registry):

    - ``pio_build_info{server,version,torch,cuda,process_count,devices}``,
      a constant-1 info gauge rendered at scrape time, so its device
      labels describe what is live then;
    - ``pio_process_start_time_seconds``;
    - ``pio_device_hbm_bytes{device,kind,stat=used|limit|peak}``, each
      card's memory (:func:`hbm_stats`), absent until CUDA is initialized;
    - ``pio_process_{rss_bytes,cpu_seconds_total,open_fds,threads}``
      (:func:`register_process_metrics`).
    """
    if getattr(reg, "_runtime_mounted", False):
        return
    reg._runtime_mounted = True  # type: ignore[attr-defined]
    if version is None:
        from .. import __version__ as version

    def _build_info_lines() -> List[str]:
        info = build_info(server, str(version))
        labels = ",".join(f'{k}="{escape_label_value(str(v))}"'
                          for k, v in sorted(info.items()))
        return ["# HELP pio_build_info Constant 1; identifies the "
                "build and runtime being scraped",
                "# TYPE pio_build_info gauge",
                "pio_build_info{%s} 1" % labels]

    reg.register_collector(_build_info_lines)
    reg.gauge("pio_process_start_time_seconds",
              "Unix time this server process started"
              ).set(reg.start_time)

    def _hbm_lines() -> List[str]:
        stats = hbm_stats()
        if not stats:
            return []
        lines = ["# HELP pio_device_hbm_bytes Per-card memory from "
                 "torch.cuda.memory_stats (used, peak: allocated bytes) "
                 "and the card's total memory (limit); absent until CUDA "
                 "is initialized",
                 "# TYPE pio_device_hbm_bytes gauge"]
        for e in stats:
            for key, stat in (("bytesInUse", "used"),
                              ("bytesLimit", "limit"),
                              ("peakBytesInUse", "peak")):
                lines.append(
                    'pio_device_hbm_bytes{device="%s",kind="%s",stat="%s"}'
                    ' %s' % (escape_label_value(str(e["device"])),
                             escape_label_value(str(e["kind"])), stat,
                             format_value(float(e[key]))))
        return lines

    reg.register_collector(_hbm_lines)
    register_process_metrics(reg)

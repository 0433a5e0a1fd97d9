"""Plugin hooks of the event and engine servers (the port's copy of
``predictionio_tpu/server/plugins.py``).

Input and output *blockers* run synchronously (raising aborts the
request); *sniffers* observe asynchronously on a bounded pump thread that
drops under overload and is joined on ``close()``. Plugins are registered
with an explicit ``register`` call. The engine server runs
``process_output`` on every served result; the event server runs
``process_input`` on every event it accepts through the JSON routes.
"""

from __future__ import annotations

import abc
import logging
import queue
import threading
from typing import Any, Dict, List, Optional

from ..data.event import Event

log = logging.getLogger(__name__)


class EventServerPlugin(abc.ABC):
    """Event-side hook (``data/api/EventServerPlugin.scala:21-34``)."""

    plugin_name: str = ""
    plugin_description: str = ""

    @abc.abstractmethod
    def process(self, app_id: int, channel_id: Optional[int],
                event: Event) -> None:
        ...

    def handle_rest(self, app_id: int, channel_id: Optional[int],
                    args: List[str]) -> Any:
        return {}


class EngineServerPlugin(abc.ABC):
    """Engine-side hook (``workflow/EngineServerPlugin.scala:24-41``):
    ``process`` sees (query, prediction) and may transform the prediction
    (blockers) or merely observe (sniffers)."""

    plugin_name: str = ""
    plugin_description: str = ""

    @abc.abstractmethod
    def process(self, query: Any, prediction: Any) -> Any:
        ...

    def handle_rest(self, args: List[str]) -> Any:
        return {}


class _SnifferPump:
    """Async fan-out to sniffers (the reference's plugin actors).

    Sniffers observe; they must never apply backpressure to the ingest
    or serve path — so the queue is bounded and overload DROPS the
    oldest-unserved observation (counted) instead of growing without
    limit or blocking the caller. ``close()`` drains to a sentinel and
    joins the pump thread, so a server stop→start cycle leaks nothing."""

    _STOP = object()

    def __init__(self, maxsize: int = 1024):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.dropped = 0

    def _ensure(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="plugin-sniffers")
                self._thread.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is self._STOP:
                return
            try:
                fn()
            except Exception:
                log.exception("sniffer plugin failed")

    def submit(self, fn) -> None:
        self._ensure()
        try:
            self._q.put_nowait(fn)
        except queue.Full:
            # observers lose a sample under overload; the hot path
            # never blocks on them
            self.dropped += 1

    def close(self, timeout: float = 5.0) -> None:
        """Stop the pump thread after the queued work drains."""
        with self._lock:
            t = self._thread
            self._thread = None
        if t is None or not t.is_alive():
            return
        self._q.put(self._STOP)
        t.join(timeout=timeout)


class EventServerPlugins:
    def __init__(self):
        self.input_blockers: Dict[str, EventServerPlugin] = {}
        self.input_sniffers: Dict[str, EventServerPlugin] = {}
        self._pump = _SnifferPump()

    def register(self, plugin: EventServerPlugin, *, blocker: bool) -> None:
        target = self.input_blockers if blocker else self.input_sniffers
        target[plugin.plugin_name or type(plugin).__name__] = plugin

    def process_input(self, app_id: int, channel_id: Optional[int],
                      event: Event) -> None:
        for p in self.input_blockers.values():
            p.process(app_id, channel_id, event)
        for p in self.input_sniffers.values():
            self._pump.submit(
                lambda p=p: p.process(app_id, channel_id, event))

    def describe(self) -> dict:
        def one(plugins: Dict[str, EventServerPlugin]) -> dict:
            return {name: {"name": p.plugin_name,
                           "description": p.plugin_description,
                           "class": type(p).__qualname__}
                    for name, p in plugins.items()}
        return {"inputblockers": one(self.input_blockers),
                "inputsniffers": one(self.input_sniffers)}

    def close(self) -> None:
        self._pump.close()


class EngineServerPlugins:
    def __init__(self):
        self.output_blockers: Dict[str, EngineServerPlugin] = {}
        self.output_sniffers: Dict[str, EngineServerPlugin] = {}
        self._pump = _SnifferPump()

    def register(self, plugin: EngineServerPlugin, *, blocker: bool) -> None:
        target = self.output_blockers if blocker else self.output_sniffers
        target[plugin.plugin_name or type(plugin).__name__] = plugin

    def process_output(self, query: Any, prediction: Any) -> Any:
        for p in self.output_blockers.values():
            prediction = p.process(query, prediction)
        for p in self.output_sniffers.values():
            self._pump.submit(lambda p=p: p.process(query, prediction))
        return prediction

    def describe(self) -> dict:
        def one(plugins: Dict[str, EngineServerPlugin]) -> dict:
            return {name: {"name": p.plugin_name,
                           "description": p.plugin_description,
                           "class": type(p).__qualname__}
                    for name, p in plugins.items()}
        return {"outputblockers": one(self.output_blockers),
                "outputsniffers": one(self.output_sniffers)}

    def close(self) -> None:
        self._pump.close()


def resolve_plugin(registry_map, ptype: str, pname: str, rest: str):
    """Shared ``/plugins/<type>/<name>/<args…>`` dispatch for the engine
    and event servers: returns (plugin, args) or raises the appropriate
    404 ``HTTPError``."""
    from .http import HTTPError

    plugins = registry_map.get(ptype)
    if plugins is None:
        raise HTTPError(404, f"unknown plugin type {ptype!r}")
    plugin = plugins.get(pname)
    if plugin is None:
        raise HTTPError(404, f"plugin {pname!r} not registered")
    return plugin, [seg for seg in rest.split("/") if seg]

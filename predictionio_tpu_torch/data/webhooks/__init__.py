"""Webhook connectors: third-party payloads -> events (the port's copy of
``predictionio_tpu/data/webhooks/``). A connector turns one provider's
payload into the event-JSON wire format; the event server routes
``/webhooks/<name>.json`` and ``.form`` through :data:`json_connectors`
and :data:`form_connectors`.
"""

from __future__ import annotations

import abc
from typing import Dict, Mapping

from ..event import Event

__all__ = ["ConnectorException", "JsonConnector", "FormConnector",
           "json_connectors", "form_connectors", "to_event"]


class ConnectorException(Exception):
    """Payload could not be converted (``ConnectorException.scala``)."""


class JsonConnector(abc.ABC):
    """JSON-body webhook converter (``JsonConnector.scala``)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping) -> dict:
        """Return the event-JSON dict for one provider payload."""


class FormConnector(abc.ABC):
    """Form-encoded webhook converter (``FormConnector.scala``)."""

    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict:
        ...


def to_event(connector, data: Mapping) -> Event:
    """Convert and parse in one step (``ConnectorUtil.toEvent``)."""
    return Event.from_json(connector.to_event_json(data))


def _builtin_json() -> Dict[str, JsonConnector]:
    from .segmentio import SegmentIOConnector
    return {"segmentio": SegmentIOConnector()}


def _builtin_form() -> Dict[str, FormConnector]:
    from .mailchimp import MailChimpConnector
    return {"mailchimp": MailChimpConnector()}


#: name → connector registries (``WebhooksConnectors.scala:30-34``).
json_connectors: Dict[str, JsonConnector] = _builtin_json()
form_connectors: Dict[str, FormConnector] = _builtin_form()

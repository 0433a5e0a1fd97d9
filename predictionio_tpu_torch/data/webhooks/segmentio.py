"""Segment.io webhook connector (the port's copy of
``predictionio_tpu/data/webhooks/segmentio.py``): Segment v2 payloads
(``type``, ``user_id``/``anonymous_id``, ``timestamp``, ``version``) of
the six message types ``identify``, ``track``, ``alias``, ``page``,
``screen`` and ``group`` become events named by the message type, with
``entityType="user"``, the user (or anonymous) id as the entity id, and
the type's fields and ``context`` folded into ``properties``.
"""

from __future__ import annotations

from typing import Mapping

from . import ConnectorException, JsonConnector


def _require(data: Mapping, key: str) -> object:
    if key not in data:
        raise ConnectorException(
            f"Cannot extract {key!r} from segment.io payload.")
    return data[key]


#: type → payload fields folded into event properties.
_TYPE_FIELDS = {
    "identify": ("traits",),
    "track": ("properties", "event"),
    "alias": ("previous_id",),
    "screen": ("name", "properties"),
    "page": ("name", "properties"),
    "group": ("group_id", "traits"),
}


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: Mapping) -> dict:
        if "version" not in data:
            raise ConnectorException("Failed to get segment.io API version.")
        msg_type = str(_require(data, "type"))
        if msg_type not in _TYPE_FIELDS:
            raise ConnectorException(
                f"Cannot convert unknown type {msg_type} to event JSON.")
        user_id = data.get("user_id") or data.get("anonymous_id")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields.")

        properties = {}
        for field in _TYPE_FIELDS[msg_type]:
            if data.get(field) is not None:
                properties[field] = data[field]
        if data.get("context") is not None:
            properties["context"] = data["context"]

        out = {
            "event": msg_type,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": properties,
        }
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out

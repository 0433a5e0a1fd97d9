"""MailChimp form-webhook connector (the port's copy of
``predictionio_tpu/data/webhooks/mailchimp.py``): form-encoded payloads
(``type`` one of subscribe, unsubscribe, profile, upemail, cleaned,
campaign; bracketed ``data[...]`` keys; ``fired_at`` as ``YYYY-MM-DD
HH:MM:SS`` UTC) become events with the same entity and target mappings
(user -> list for member events, list for cleaned, campaign -> list for
campaign sends).
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Mapping, Optional

from . import ConnectorException, FormConnector
from ..event import isoformat_millis


def _parse_fired_at(s: str) -> str:
    try:
        t = datetime.strptime(s, "%Y-%m-%d %H:%M:%S")
    except ValueError:
        raise ConnectorException(f"invalid fired_at time: {s!r}")
    return isoformat_millis(t.replace(tzinfo=timezone.utc))


def _merges(data: Mapping[str, str]) -> dict:
    out = {}
    for k in ("EMAIL", "FNAME", "LNAME"):
        key = f"data[merges][{k}]"
        if key in data:
            out[k] = data[key]
    if "data[merges][INTERESTS]" in data:
        out["INTERESTS"] = data["data[merges][INTERESTS]"]
    return out


def _get(data: Mapping[str, str], key: str) -> str:
    if key not in data:
        raise ConnectorException(f"missing MailChimp field {key!r}")
    return data[key]


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: Mapping[str, str]) -> dict:
        msg_type: Optional[str] = data.get("type")
        handlers = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }
        if msg_type not in handlers:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp type {msg_type} to event JSON.")
        return handlers[msg_type](data)

    def _subscribe(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "subscribe",
            "entityType": "user", "entityId": _get(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "email": _get(d, "data[email]"),
                "email_type": _get(d, "data[email_type]"),
                "merges": _merges(d),
                "ip_opt": _get(d, "data[ip_opt]"),
                "ip_signup": _get(d, "data[ip_signup]"),
            },
        }

    def _unsubscribe(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "unsubscribe",
            "entityType": "user", "entityId": _get(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "action": _get(d, "data[action]"),
                "reason": _get(d, "data[reason]"),
                "email": _get(d, "data[email]"),
                "email_type": _get(d, "data[email_type]"),
                "merges": _merges(d),
                "ip_opt": _get(d, "data[ip_opt]"),
                "campaign_id": _get(d, "data[campaign_id]"),
            },
        }

    def _profile(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "profile",
            "entityType": "user", "entityId": _get(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "email": _get(d, "data[email]"),
                "email_type": _get(d, "data[email_type]"),
                "merges": _merges(d),
                "ip_opt": _get(d, "data[ip_opt]"),
            },
        }

    def _upemail(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "upemail",
            "entityType": "user", "entityId": _get(d, "data[new_id]"),
            "targetEntityType": "list",
            "targetEntityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "new_email": _get(d, "data[new_email]"),
                "old_email": _get(d, "data[old_email]"),
            },
        }

    def _cleaned(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "cleaned",
            "entityType": "list", "entityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "campaignId": _get(d, "data[campaign_id]"),
                "reason": _get(d, "data[reason]"),
                "email": _get(d, "data[email]"),
            },
        }

    def _campaign(self, d: Mapping[str, str]) -> dict:
        return {
            "event": "campaign",
            "entityType": "campaign", "entityId": _get(d, "data[id]"),
            "targetEntityType": "list",
            "targetEntityId": _get(d, "data[list_id]"),
            "eventTime": _parse_fired_at(_get(d, "fired_at")),
            "properties": {
                "subject": _get(d, "data[subject]"),
                "status": _get(d, "data[status]"),
                "reason": _get(d, "data[reason]"),
            },
        }

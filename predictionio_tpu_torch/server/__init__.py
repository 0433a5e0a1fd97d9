"""HTTP servers: event ingestion, engine serving, admin, dashboard and the
storage server."""

from .http import AppServer, HTTPApp, HTTPError, Request, Response  # noqa: F401

"""Host-side utilities."""

from .jsonutil import from_jsonable, to_jsonable  # noqa: F401

"""Shipped engine variants and evaluations of the port, importable by
module path from the CLI."""

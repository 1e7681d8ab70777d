"""Observability of the port (the metric registry)."""

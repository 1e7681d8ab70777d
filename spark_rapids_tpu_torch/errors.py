"""Engine error types (the subset of ``spark_rapids_tpu/errors.py`` that
the ported path raises)."""

from __future__ import annotations


class RapidsTpuError(Exception):
    """Base for all engine errors."""


class ColumnarProcessingError(RapidsTpuError):
    """An operator failed on device in a way that is not an OOM."""

"""External source provider SPI (port of ``spark_rapids_tpu/sources.py``;
reference: ``ExternalSource.scala``): connectors are not wired into the
override rules; each ships a provider, found through this registry, that
probes its availability and creates scans by capability. ``TorchSession.
read`` / ``read_format`` and ``CREATE TEMP VIEW ... USING`` route every
lookup through it.

The port's providers: ``parquet`` (its own codec, io/parquet.py),
``orc``, ``avro`` (io/avro.py), ``csv``, ``json`` and ``hive`` (also
``hive-text``, ``hivetext``) over its text codec (io/csv.py, io/json.py,
io/hive_text.py), ``delta`` (delta/: time travel and the ``DeltaTable``
API) and ``iceberg`` (iceberg/: snapshot selection), as the reference's."""

from __future__ import annotations

import importlib.util
from typing import Dict, Optional, Sequence

from spark_rapids_tpu_torch.errors import ColumnarProcessingError


class ExternalSourceProvider:
    """One connector's contract. Subclasses override ``create_scan_node``
    and declare their formats and capabilities."""

    #: provider name for diagnostics
    name: str = "?"
    #: format strings this provider serves (session.read.format(...))
    formats: Sequence[str] = ()
    #: subset of {"read", "write", "time-travel", "snapshot-id",
    #: "table-api"}
    capabilities: frozenset = frozenset({"read"})
    #: Python modules that must import for the provider to load
    required_modules: Sequence[str] = ()

    def is_available(self) -> bool:
        try:
            return all(importlib.util.find_spec(m) is not None
                       for m in self.required_modules)
        except (ImportError, ValueError):
            return False

    def create_scan_node(self, paths, conf, **options):
        raise NotImplementedError


_PROVIDERS: Dict[str, ExternalSourceProvider] = {}


def register_provider(provider: ExternalSourceProvider) -> None:
    """Make a connector discoverable."""
    for fmt in provider.formats:
        _PROVIDERS[fmt.lower()] = provider


def provider_for(fmt: str) -> Optional[ExternalSourceProvider]:
    """The available provider serving ``fmt``, or None (absent, or its
    required modules are missing)."""
    p = _PROVIDERS.get(fmt.lower())
    if p is not None and not p.is_available():
        return None
    return p


def supported_formats() -> Sequence[str]:
    return sorted(f for f, p in _PROVIDERS.items() if p.is_available())


def create_scan(fmt: str, paths, conf, **options):
    p = provider_for(fmt)
    if p is None:
        raise ColumnarProcessingError(
            f"no available source provider for format {fmt!r} "
            f"(available: {list(supported_formats())})")
    if "read" not in p.capabilities:
        raise ColumnarProcessingError(
            f"source provider {p.name} does not support reads")
    return p.create_scan_node(paths, conf, **options)


class _ParquetProvider(ExternalSourceProvider):
    name = "parquet"
    formats = ("parquet",)
    capabilities = frozenset({"read", "write"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.parquet import ParquetScanNode
        return ParquetScanNode(list(paths), conf, **options)


class _OrcProvider(ExternalSourceProvider):
    name = "orc"
    formats = ("orc",)
    capabilities = frozenset({"read", "write"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.orc import OrcScanNode
        return OrcScanNode(list(paths), conf, **options)


class _AvroProvider(ExternalSourceProvider):
    """The reference probes for the spark-avro jar; the reader here is
    self-contained, so the probe is trivially true."""

    name = "avro"
    formats = ("avro",)
    capabilities = frozenset({"read"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.avro import AvroScanNode
        return AvroScanNode(list(paths), conf, **options)


class _CsvProvider(ExternalSourceProvider):
    name = "csv"
    formats = ("csv",)
    capabilities = frozenset({"read", "write"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.csv import CsvScanNode
        return CsvScanNode(list(paths), conf, **options)


class _JsonProvider(ExternalSourceProvider):
    name = "json"
    formats = ("json",)
    capabilities = frozenset({"read", "write"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.json import JsonScanNode
        return JsonScanNode(list(paths), conf, **options)


class _HiveTextProvider(ExternalSourceProvider):
    name = "hive-text"
    formats = ("hive", "hive-text", "hivetext")
    capabilities = frozenset({"read", "write"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.io.hive_text import HiveTextScanNode
        return HiveTextScanNode(list(paths), conf, **options)


def _single_path(paths, fmt: str) -> str:
    if len(paths) != 1:
        raise ColumnarProcessingError(
            f"{fmt} source takes exactly one table path, got {list(paths)}")
    return paths[0]


class _DeltaProvider(ExternalSourceProvider):
    name = "delta"
    formats = ("delta",)
    capabilities = frozenset({"read", "write", "time-travel", "table-api"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.delta import DeltaScanNode
        return DeltaScanNode(_single_path(paths, "delta"), conf, **options)

    def create_table_api(self, session, path):
        from spark_rapids_tpu_torch.delta import DeltaTable
        return DeltaTable(session, path)


class _IcebergProvider(ExternalSourceProvider):
    name = "iceberg"
    formats = ("iceberg",)
    capabilities = frozenset({"read", "snapshot-id"})

    def create_scan_node(self, paths, conf, **options):
        from spark_rapids_tpu_torch.iceberg import IcebergScanNode
        return IcebergScanNode(_single_path(paths, "iceberg"), conf,
                               **options)


for _p in [_ParquetProvider(), _OrcProvider(), _AvroProvider(), _CsvProvider(),
           _JsonProvider(), _HiveTextProvider(), _DeltaProvider(),
           _IcebergProvider()]:
    register_provider(_p)
del _p


class DataFrameReader:
    """``session.read.format("parquet").option(...).load(path)``: the
    pyspark reader surface, routed through the provider SPI."""

    def __init__(self, session):
        self._session = session
        self._format = "parquet"
        self._options: Dict[str, object] = {}

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = fmt
        return self

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameReader":
        self._options.update(opts)
        return self

    def load(self, *paths):
        from spark_rapids_tpu_torch.plan import DataFrame
        node = create_scan(self._format, list(paths), self._session.conf,
                           **self._options)
        return DataFrame(node, self._session)

    def parquet(self, *paths):
        return self.format("parquet").load(*paths)

    def csv(self, *paths, **opts):
        return self.format("csv").options(**opts).load(*paths)

    def json(self, *paths, **opts):
        return self.format("json").options(**opts).load(*paths)

    def orc(self, *paths):
        return self.format("orc").load(*paths)

"""Shared harness of the port's Delta, Iceberg and streaming tests: one
scenario runs against the reference (``TpuSession`` under
``JAX_PLATFORMS=cpu``) and against the port (``TorchSession(device=
"cpu")``) through an adapter (:class:`Api`) that gives both the same
surface, on the same numpy inputs; the tests compare what the two runs
return.

Comparators: ``scale_test.tables_differ`` (bitwise, in order) and
``scale_test.tables_differ_unordered`` (bitwise row multisets: a Delta
scan reads its files in path order, and the paths hold random uuids), with
the port's tables converted by ``as_reference``. Logs and checkpoints
compare with the fields that hold times, uuids and writer-dependent file
sizes masked (:func:`masked_log`)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from scale_test import tables_differ, tables_differ_unordered
from tests.torch_service_util import as_reference, reference_table

#: log fields that differ between two runs of one history: times, uuids,
#: the engine's name and the Parquet writer's file sizes
MASKED = {"timestamp", "modificationTime", "deletionTimestamp",
          "createdTime", "lastUpdated", "engineInfo", "size"}


def spec(data: Dict[str, object]):
    """(names, types, arrays) of a dict of numpy arrays (a value may be
    ``(array, validity)``); object arrays are strings, None is null."""
    names, types, arrays = [], [], []
    for k, v in data.items():
        if isinstance(v, tuple):
            arr, valid = np.asarray(v[0]), np.asarray(v[1], dtype=bool)
        else:
            arr = np.asarray(v)
            valid = (np.array([x is not None for x in arr], dtype=bool)
                     if arr.dtype == object else np.ones(len(arr), bool))
        ty = {"i": {8: "bigint", 4: "int"}.get(arr.dtype.itemsize),
              "f": "double", "b": "boolean", "O": "string",
              "U": "string"}[arr.dtype.kind]
        if arr.dtype.kind == "U":
            arr = arr.astype(object)
        names.append(k)
        types.append(ty)
        arrays.append((arr, valid))
    return names, types, arrays


class Api:
    """One package's surface for a scenario: ``port`` True for the port,
    else the reference."""

    def __init__(self, port: bool, conf: Optional[dict] = None):
        self.port = port
        conf = dict(conf or {})
        if port:
            from spark_rapids_tpu_torch import functions as F
            from spark_rapids_tpu_torch.delta import commands, log, table
            from spark_rapids_tpu_torch.errors import ColumnarProcessingError
            from spark_rapids_tpu_torch.ops.expr import col, lit
            from spark_rapids_tpu_torch.session import TorchSession
            self.session = TorchSession(conf, device="cpu")
        else:
            from spark_rapids_tpu import functions as F
            from spark_rapids_tpu.delta import commands, log, table
            from spark_rapids_tpu.errors import ColumnarProcessingError
            from spark_rapids_tpu.ops.expr import col, lit
            from spark_rapids_tpu.session import TpuSession
            self.session = TpuSession(conf)
        self.F, self.col, self.lit = F, col, lit
        self.log, self.table, self.commands = log, table, commands
        self.CPE = ColumnarProcessingError

    def host(self, data):
        s = spec(data)
        if self.port:
            from spark_rapids_tpu_torch.interop import host_table_from_arrays
            return host_table_from_arrays(*s)
        return reference_table(s)

    def df(self, data):
        if self.port:
            from spark_rapids_tpu_torch.plan import from_host_table
        else:
            from spark_rapids_tpu.plan.dataframe import from_host_table
        return from_host_table(self.host(data), self.session)

    def read(self, path, **kw):
        return self.session.read_delta(path, **kw)

    def dt(self, path):
        return self.session.delta_table(path)

    def snap(self, path, version=None):
        return self.log.DeltaLog(path).snapshot(version)


def pair(conf: Optional[dict] = None):
    """(reference Api, port Api) over sessions of ``conf``."""
    return Api(False, conf), Api(True, conf)


def ref_form(t):
    """A collected table in the reference's form (for the comparators)."""
    return t if t.__class__.__module__.startswith("spark_rapids_tpu.") \
        else as_reference(t)


def same_rows(jt, tt) -> None:
    got = tables_differ_unordered(ref_form(jt), ref_form(tt))
    assert got is None, got


def same_table(jt, tt) -> None:
    got = tables_differ(ref_form(jt), ref_form(tt))
    assert got is None, got


def _mask(obj, key=None):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in MASKED else _mask(v, k))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    if isinstance(obj, str) and key in ("path", "pathOrInlineDv", "id",
                                        "delta.columnMapping.physicalName"):
        return "<masked>"
    if isinstance(obj, str) and key == "schemaString":
        return json.dumps(_mask(json.loads(obj)), sort_keys=True)
    return obj


def masked_log(path: str) -> list:
    """Every commit's actions, time, uuid and size fields masked."""
    d = os.path.join(path, "_delta_log")
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json") and len(f) == 25:
            with open(os.path.join(d, f)) as fh:
                out.append([_mask(json.loads(line)) for line in fh
                            if line.strip()])
    return out


def masked_snapshot(snap) -> tuple:
    """A snapshot's version, metadata and files, uuids masked, the files
    in log order."""
    m = snap.metadata
    files = [_mask({"path": a.path, "partitionValues": a.partition_values,
                    "dataChange": a.data_change, "stats": a.stats,
                    "deletionVector": a.deletion_vector})
             for a in snap.files]
    return (snap.version, _mask({"schemaString": m.schema_json}),
            m.partition_columns, _mask(m.configuration, "configuration"),
            files)

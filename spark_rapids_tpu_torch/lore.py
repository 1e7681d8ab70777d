"""LORE, local operator replay (port of ``spark_rapids_tpu/lore.py``;
reference: GpuLore.scala, GpuLoreDumpExec / GpuLoreReplayExec).

Every converted exec has a ``_lore_id``: its plan position, pre-order
from 1 over the exec tree (:func:`assign_lore_ids`, which
``overrides/rules.py::convert`` runs). Speculation sites key on these
ids (``execs/join.py``, ``execs/aggregate.py``), so a repeated query gets
the same ids.

``spark.rapids.sql.lore.idsToDump`` (comma-separated ids) with
``spark.rapids.sql.lore.dumpPath`` tees each tagged exec's input batches
to ``<path>/lore-<id>/input-<child>/batch-<n>.parquet`` through the
port's own Parquet writer, and pickles the exec (its children dropped,
its per-run state stripped) beside a ``meta.json``. :func:`replay`
reloads the exec, puts scans of the dumped batches under it, runs it on
a device and returns its HostTable, in a fresh process if need be.

:func:`install_dumpers` is not idempotent (nor is the reference's): the
session installs it on freshly converted trees only."""

from __future__ import annotations

import json
import os
import pickle
from typing import List

#: per-run state stripped before an exec is pickled
_STRIP_ATTRS = ("_metrics", "_cached", "_dynamic_prunes")
#: instance-attribute wrappers of the fault, observation and dump
#: boundaries (closures, unpicklable): deleted so the class methods
#: resurface in the replayed exec
_WRAPPER_ATTRS = ("execute", "execute_masked", "_fault_guarded",
                  "_obs_installed", "_obs_depth", "_obs_pending_rows")


def assign_lore_ids(executable) -> None:
    """Number every exec of the tree, pre-order from 1."""
    for i, e in enumerate(_iter_tree(executable), start=1):
        e._lore_id = i


def _iter_tree(e):
    """The exec tree in pre-order (the port's execs link only through
    ``children``)."""
    stack = [e]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(reversed(tuple(getattr(node, "children", ()))))


class _TeeChild:
    """Wraps a child exec: passes its batches through, each written to the
    lore directory as it goes."""

    def __init__(self, inner, outdir: str):
        self.inner = inner
        self.outdir = outdir
        self.children = (inner,)
        self._lore_id = None

    @property
    def metrics(self):
        return {}

    def output_schema(self):
        return self.inner.output_schema()

    def execute(self):
        from spark_rapids_tpu_torch.io.parquet_format import write_table
        os.makedirs(self.outdir, exist_ok=True)
        for i, batch in enumerate(self.inner.execute()):
            write_table(batch.to_host(),
                        os.path.join(self.outdir, f"batch-{i}.parquet"))
            out = [batch]
            del batch
            yield out.pop()

    def execute_masked(self):
        # the dump records the batch as a consumer sees it: compacted
        return self.execute()

    def spillable_batches(self):
        from spark_rapids_tpu_torch.execs.base import TpuExec
        return TpuExec.spillable_batches(self)


def _strip_for_pickle(exec_obj):
    import copy
    clone = copy.copy(exec_obj)
    for a in _STRIP_ATTRS + _WRAPPER_ATTRS:
        clone.__dict__.pop(a, None)
    clone.children = ()
    return clone


def install_dumpers(executable, conf) -> List[int]:
    """Tee the children of every exec whose lore id is in
    ``spark.rapids.sql.lore.idsToDump``; returns the ids armed."""
    from spark_rapids_tpu_torch.conf import LORE_DUMP_IDS, LORE_DUMP_PATH
    raw = str(conf.get_entry(LORE_DUMP_IDS) or "").strip()
    if not raw:
        return []
    path = str(conf.get_entry(LORE_DUMP_PATH) or "").strip()
    if not path:
        raise ValueError(
            "spark.rapids.sql.lore.idsToDump is set but "
            "spark.rapids.sql.lore.dumpPath is empty")
    want = {int(x) for x in raw.split(",") if x.strip()}
    armed = []
    # snapshot BEFORE arming: wrapping children mid-walk would hide a
    # tagged exec nested under another tagged exec
    for e in list(_iter_tree(executable)):
        lid = getattr(e, "_lore_id", None)
        if lid not in want:
            continue
        outdir = os.path.join(path, f"lore-{lid}")
        os.makedirs(outdir, exist_ok=True)
        kids = list(e.children)
        meta = {
            "lore_id": lid,
            "exec_class": type(e).__name__,
            "num_children": len(kids),
            "output_schema": [(n, str(dt)) for n, dt in e.output_schema()],
        }
        with open(os.path.join(outdir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        with open(os.path.join(outdir, "exec.pkl"), "wb") as f:
            pickle.dump({"exec": _strip_for_pickle(e),
                         "schema": list(e.output_schema()),
                         "child_schemas": [list(c.output_schema())
                                           for c in kids]}, f)
        e.children = tuple(
            _TeeChild(c, os.path.join(outdir, f"input-{ci}"))
            for ci, c in enumerate(kids))
        armed.append(lid)
    return armed


def replay(dump_dir: str, device=None):
    """Re-execute ONE dumped operator from its lore directory: its
    children become scans of the dumped batches; returns the HostTable.
    ``device`` as ``TorchSession``'s (None: the current CUDA device)."""
    from spark_rapids_tpu_torch import resolve_device
    from spark_rapids_tpu_torch.columnar.column import BucketPolicy
    from spark_rapids_tpu_torch.columnar.table import (
        concat_host,
        empty_host_table,
    )
    from spark_rapids_tpu_torch.execs.basic import TpuScanExec
    from spark_rapids_tpu_torch.io.parquet_format import read_table
    dev = resolve_device(device)
    with open(os.path.join(dump_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(dump_dir, "exec.pkl"), "rb") as f:
        payload = pickle.load(f)
    exec_obj = payload["exec"]
    kids = []
    for ci in range(meta["num_children"]):
        indir = os.path.join(dump_dir, f"input-{ci}")
        batches = []
        i = 0
        while os.path.exists(os.path.join(indir, f"batch-{i}.parquet")):
            batches.append(read_table(
                os.path.join(indir, f"batch-{i}.parquet")))
            i += 1
        if not batches:
            batches = [empty_host_table(payload["child_schemas"][ci])]
        kids.append(TpuScanExec(batches, dev, BucketPolicy()))
    exec_obj.children = tuple(kids)
    out = [b.to_host() for b in exec_obj.execute()]
    if not out:
        return empty_host_table(payload["schema"])
    return concat_host(out)

"""Parquet as Python records, on the host: nested structs, maps and lists
with string, integer and boolean leaves, for files whose rows are few and
whose schema is fixed (the Delta checkpoint, delta/log.py).

The reference reads and writes its checkpoints through pyarrow's
``to_pylist``/``from_pylist``; the port's columnar codec
(io/parquet_format.py) reads and writes nested columns of fixed-width
leaves only (ROADMAP item [9-ext], which stays open for data files). This
module shreds records into each leaf's repetition and definition levels
(Dremel) and back, over the codec's page decoder and its Thrift and RLE
writers:

* writing: one uncompressed version-1 data page per leaf, RLE levels and
  PLAIN values (strings as BYTE_ARRAY), the schema annotated as pyarrow
  annotates it (a LIST's ``list``/``element``, a MAP's ``key_value``), so
  pyarrow reads the file back;
* reading: any file of such a schema, pyarrow's dictionary-encoded and
  compressed pages included, nested at most one repeated level deep.

A schema is a list of fields: ``(name, "string"|"int32"|"int64"|"bool")``,
``(name, "struct", [fields])``, ``(name, "map")`` (string to string) or
``(name, "list")`` (of strings). Every field is optional; a map's key is
required, as pyarrow writes it."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import ColumnarProcessingError
from spark_rapids_tpu_torch.io import parquet_format as PF

_PRIMS = {"string": T.STRING, "int32": T.INT, "int64": T.LONG,
          "bool": T.BOOLEAN}
#: the type an all-null column (logical type NULL) decodes as
_NULL_PHYSICAL = {PF.INT32: T.INT, PF.INT64: T.LONG, PF.BOOLEAN: T.BOOLEAN,
                  PF.BYTE_ARRAY: T.STRING}


# -- the schema tree ---------------------------------------------------------

class _Field:
    """One node of the schema: its levels, children and leaves."""

    def __init__(self, name: str, kind: str, children=(), rep=PF.OPTIONAL,
                 prim: Optional[str] = None):
        self.name = name
        self.kind = kind            # "prim", "struct", "list", "map"
        self.children: List["_Field"] = list(children)
        self.rep = rep
        self.prim = prim
        self.def_level = 0
        self.rep_level = 0
        self.leaves: List["_Field"] = []
        #: a leaf's index into the file's leaf list
        self.index = -1


def _from_spec(spec) -> _Field:
    name, kind = spec[0], spec[1]
    if kind in _PRIMS:
        return _Field(name, "prim", prim=kind)
    if kind == "struct":
        return _Field(name, "struct", [_from_spec(s) for s in spec[2]])
    if kind == "list":
        elem = _Field("element", "prim", prim="string")
        return _Field(name, "list", [_Field("list", "struct", [elem],
                                            rep=PF.REPEATED)])
    if kind == "map":
        kv = _Field("key_value", "struct",
                    [_Field("key", "prim", rep=PF.REQUIRED, prim="string"),
                     _Field("value", "prim", prim="string")],
                    rep=PF.REPEATED)
        return _Field(name, "map", [kv])
    raise ValueError(f"unknown record schema kind {kind!r}")


def _resolve(fields: Sequence[_Field]) -> List[_Field]:
    """Set every node's levels; returns the leaves in file order."""
    leaves: List[_Field] = []

    def walk(f: _Field, d: int, r: int) -> List[_Field]:
        f.def_level = d + (f.rep != PF.REQUIRED)
        f.rep_level = r + (f.rep == PF.REPEATED)
        if f.kind == "prim":
            f.index = len(leaves)
            leaves.append(f)
            f.leaves = [f]
        else:
            f.leaves = [lf for c in f.children
                        for lf in walk(c, f.def_level, f.rep_level)]
        return f.leaves

    for f in fields:
        walk(f, 0, 0)
    if any(lf.rep_level > 1 for lf in leaves):
        raise NotImplementedError(
            "Parquet records nested more than one repeated level deep")
    return leaves


def _repeated_child(f: _Field) -> _Field:
    rc = f.children[0] if len(f.children) == 1 else None
    if rc is None or rc.rep != PF.REPEATED:
        raise ColumnarProcessingError(
            f"Parquet {f.kind} {f.name!r} without one repeated child")
    return rc


# -- writing -----------------------------------------------------------------

def _schema_elements(f: _Field) -> list:
    if f.kind == "prim":
        _, el = PF._schema_element(f.name, _PRIMS[f.prim])
        return [PF._set_repetition(el, f.rep)]
    head = [(3, PF._I32, f.rep), (4, PF._BINARY, f.name),
            (5, PF._I32, len(f.children))]
    if f.kind == "list":
        head += [(6, PF._I32, 3), (10, PF._STRUCT, [(3, PF._STRUCT, [])])]
    elif f.kind == "map":
        head += [(6, PF._I32, 1), (10, PF._STRUCT, [(2, PF._STRUCT, [])])]
    return [head] + [el for c in f.children for el in _schema_elements(c)]


def _shred(f: _Field, value, r: int, d: int, out: List[list]) -> None:
    """Append (repetition, definition, value) of ``value`` at field ``f``
    to each leaf's list; ``d`` is the definition its parents reached."""
    if value is None:
        if f.rep == PF.REQUIRED:
            raise ColumnarProcessingError(
                f"null value for required Parquet field {f.name!r}")
        for lf in f.leaves:
            out[lf.index].append((r, d, None))
        return
    d = f.def_level
    if f.kind == "prim":
        out[f.index].append((r, d, value))
    elif f.kind == "struct":
        for c in f.children:
            _shred(c, value.get(c.name), r, d, out)
    else:
        rc = _repeated_child(f)
        items = list(value.items()) if f.kind == "map" else list(value)
        if not items:
            for lf in f.leaves:
                out[lf.index].append((r, d, None))
            return
        for k, item in enumerate(items):
            rk = r if k == 0 else rc.rep_level
            if f.kind == "map":
                _shred(rc.children[0], item[0], rk, rc.def_level, out)
                _shred(rc.children[1], item[1], rk, rc.def_level, out)
            else:
                _shred(rc.children[0], item, rk, rc.def_level, out)


def _plain(prim: str, values: list) -> bytes:
    if prim == "string":
        parts = []
        for v in values:
            b = v.encode("utf-8")
            parts.append(struct.pack("<I", len(b)) + b)
        return b"".join(parts)
    if prim == "bool":
        return np.packbits(np.asarray(values, dtype=np.bool_),
                           bitorder="little").tobytes()
    return np.asarray(values, dtype="<i4" if prim == "int32"
                      else "<i8").tobytes()


def _leaf_chunk(f, lf: _Field, path: List[str], entries: list) -> list:
    """One leaf as one column chunk of one data page at f's position;
    returns its ColumnChunk fields."""
    rep = np.fromiter((e[0] for e in entries), dtype=np.int32,
                      count=len(entries))
    deff = np.fromiter((e[1] for e in entries), dtype=np.int32,
                       count=len(entries))
    body = bytearray()
    if lf.rep_level:
        lv = N.rle_encode(rep, max(1, lf.rep_level.bit_length()))
        body += struct.pack("<I", len(lv)) + lv
    if lf.def_level:
        lv = N.rle_encode(deff, max(1, lf.def_level.bit_length()))
        body += struct.pack("<I", len(lv)) + lv
    body += _plain(lf.prim, [e[2] for e in entries
                             if e[1] == lf.def_level])
    body = bytes(body)
    head = PF.thrift_bytes([
        (1, PF._I32, PF.DATA_PAGE), (2, PF._I32, len(body)),
        (3, PF._I32, len(body)),
        (5, PF._STRUCT, [(1, PF._I32, len(entries)),
                         (2, PF._I32, PF.PLAIN), (3, PF._I32, PF.RLE),
                         (4, PF._I32, PF.RLE)])])
    start = f.tell()
    f.write(head)
    f.write(body)
    size = len(head) + len(body)
    phys, _ = PF._schema_element(lf.name, _PRIMS[lf.prim])
    meta = [(1, PF._I32, phys), (2, PF._LIST, (PF._I32, [PF.PLAIN, PF.RLE])),
            (3, PF._LIST, (PF._BINARY, path)),
            (4, PF._I32, PF.UNCOMPRESSED), (5, PF._I64, len(entries)),
            (6, PF._I64, size), (7, PF._I64, size), (9, PF._I64, start)]
    return [(2, PF._I64, start), (3, PF._STRUCT, meta)], size


def _leaf_paths(fields: Sequence[_Field]) -> List[List[str]]:
    out: List[List[str]] = []

    def walk(f: _Field, prefix: List[str]):
        p = prefix + [f.name]
        if f.kind == "prim":
            out.append(p)
        for c in f.children:
            walk(c, p)

    for f in fields:
        walk(f, [])
    return out


def write_records(path: str, schema, records: Sequence[dict]) -> None:
    """Write ``records`` (dicts keyed by the schema's top-level names; a
    missing key is null) to the Parquet file ``path``."""
    fields = [_from_spec(s) for s in schema]
    leaves = _resolve(fields)
    out: List[list] = [[] for _ in leaves]
    for rec in records:
        for f in fields:
            _shred(f, rec.get(f.name), 0, 0, out)
    elements = [[(4, PF._BINARY, "schema"), (5, PF._I32, len(fields))]]
    for f in fields:
        elements.extend(_schema_elements(f))
    with open(path, "wb") as fh:
        fh.write(PF.MAGIC)
        chunks, total = [], 0
        for lf, p, entries in zip(leaves, _leaf_paths(fields), out):
            cc, size = _leaf_chunk(fh, lf, p, entries)
            chunks.append(cc)
            total += size
        row_groups = [[(1, PF._LIST, (PF._STRUCT, chunks)),
                       (2, PF._I64, total), (3, PF._I64, len(records)),
                       (5, PF._I64, 4), (6, PF._I64, total),
                       (7, PF._I16, 0)]] if records else []
        footer = PF.thrift_bytes([
            (1, PF._I32, 2), (2, PF._LIST, (PF._STRUCT, elements)),
            (3, PF._I64, len(records)),
            (4, PF._LIST, (PF._STRUCT, row_groups)),
            (6, PF._BINARY, "spark_rapids_tpu_torch")])
        fh.write(footer)
        fh.write(struct.pack("<I", len(footer)))
        fh.write(PF.MAGIC)


# -- reading -----------------------------------------------------------------

def _from_node(node) -> _Field:
    """A _Field from a footer schema node (any annotation pyarrow writes)."""
    if not node.children:
        f = _Field(node.name, "prim", rep=node.rep)
        f.prim = node  # the footer node, read by _leaf_of
        return f
    ct = node.el.get(6)
    lt = node.el.get(10) or {}
    kids = [_from_node(c) for c in node.children]
    if ct == 3 or 3 in lt:
        kind = "list"
    elif ct in (1, 2) or 2 in lt:
        kind = "map"
    else:
        kind = "struct"
    return _Field(node.name, kind, kids, rep=node.rep)


def _footer(path: str):
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        if size < 12:
            raise ColumnarProcessingError(f"{path}: not a Parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != PF.MAGIC:
            raise ColumnarProcessingError(f"{path}: not a Parquet file")
        n = struct.unpack("<I", tail[:4])[0]
        f.seek(size - 8 - n)
        return PF.ThriftReader(f.read(n)).struct()


def _assemble(f: _Field, rng: Dict[int, tuple], cols) -> object:
    """The value of field ``f`` over each leaf's entry range ``rng``."""
    first = f.leaves[0]
    a, b = rng[first.index]
    deff, vals = cols[first.index]
    if deff[a] < f.def_level:
        return None
    if f.kind == "prim":
        return vals[a]
    if f.kind == "struct":
        return {c.name: _assemble(c, rng, cols) for c in f.children}
    rc = _repeated_child(f)
    if deff[a] < rc.def_level:
        return {} if f.kind == "map" else []
    items = []
    for k in range(b - a):
        sub = {lf.index: (rng[lf.index][0] + k, rng[lf.index][0] + k + 1)
               for lf in rc.leaves}
        if f.kind == "map":
            items.append((_assemble(rc.children[0], sub, cols),
                          _assemble(rc.children[1], sub, cols)))
        elif rc.kind == "prim":  # a 2-level list: the repeated element
            items.append(_assemble(rc, sub, cols))
        else:
            items.append(_assemble(rc.children[0], sub, cols))
    return dict(items) if f.kind == "map" else items


def read_records(path: str) -> List[dict]:
    """Every row of the Parquet file ``path`` as a dict keyed by its
    top-level column names (a map as a dict, a list as a list)."""
    fm = _footer(path)
    fields = [_from_node(n) for n in PF._schema_tree(fm[2])]
    leaves = _resolve(fields)
    paths = [".".join(p) for p in _leaf_paths(fields)]
    rgs = [PF.RowGroupMeta(rg, paths) for rg in fm.get(4, [])]
    cols, starts = [], None
    with open(path, "rb") as fh:
        for lf, p in zip(leaves, paths):
            leaf = PF.Leaf(lf.prim.el)
            leaf.max_def, leaf.max_rep = lf.def_level, lf.rep_level
            if leaf.spark is None and 11 in (lf.prim.el.get(10) or {}):
                # logical type NULL (pyarrow's all-null column): its
                # values never appear, its levels say null
                leaf.spark = _NULL_PHYSICAL.get(leaf.physical)
            raws = []
            for rg in rgs:
                cm = rg.chunks[p]
                fh.seek(cm.start)
                raws.append(fh.read(cm.length))
            levels: list = []
            slots = PF.decode_column(raws, [rg.chunks[p] for rg in rgs],
                                     leaf, levels)
            rep = (np.concatenate([x for x, _ in levels]) if levels
                   else np.zeros(0, np.int32))
            deff = (np.concatenate([y for _, y in levels]) if levels
                    else np.zeros(0, np.int32))
            vals = slots.to_pylist()
            cols.append((deff.tolist(), vals))
            s = np.flatnonzero(rep == 0)
            starts = (starts if starts is not None else []) + [
                (s.tolist(), len(rep))]
    n = sum(rg.num_rows for rg in rgs)
    out = []
    for i in range(n):
        rng = {j: (s[i], s[i + 1] if i + 1 < len(s) else total)
               for j, (s, total) in enumerate(starts)}
        out.append({f.name: _assemble(f, rng, cols) for f in fields})
    return out

"""String expressions (port of ``spark_rapids_tpu/ops/strings.py``).

Device strings are dictionary codes over a sorted dictionary that stays on
the host (columnar/column.py), so every single-column string function
runs as the reference's dictionary transform: the host transforms each
DICTIONARY ENTRY once (O(cardinality), not O(rows)) and the device remaps
the codes with one gather. A string -> string function yields a new
sorted-unique dictionary and an int32 remap (-1 where the result is
null); a string -> value function (length, ascii, instr, the predicates
LIKE, RLIKE, contains, startswith, endswith) a lookup table of values and
a validity table.

The host work and the upload of its tables are cached per (expression,
input dictionary): a warm run of a query over the same dictionary gathers
with the tables its first run made (the reference interns its aux arrays
the same way).

What the reference sends to its CPU route runs on the port's (the
expression's ``device_supported`` is False, overrides/rules.py tags its
operator there): a multi-column ``Concat``, a parameter that is not a
literal (``_LiteralParams``: row by row over the parameters' values),
and a regex (RLIKE, ``regexp_replace``, ``regexp_extract``) that
``regex_transpiler.try_transpile`` rejects (Python's ``re`` over the
pattern as written, as the reference's route). Like is Spark-exact (the
pattern translated to an anchored Python regex, compiled once per
pattern)."""

from __future__ import annotations

import collections
import functools
import re
from typing import Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.ops.common import (
    UnaryExpression,
    dev_remap_codes,
)
from spark_rapids_tpu_torch.ops.expr import (
    DevVal,
    EvalCtx,
    Expression,
    Literal,
    NodePrep,
    PrepCtx,
)

_EMPTY = np.array([], dtype=object)

#: (expression key, id(dictionary), device) -> (dictionary, prep): the
#: host transform of a dictionary and its uploaded tables, kept while the
#: dictionary lives (the entry holds it, so its id cannot be reused)
_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_CACHE_SIZE = 256


def cached_prep(expr: Expression, d: np.ndarray, device, build):
    """``build()``'s NodePrep for ``expr`` over dictionary ``d``, made once
    per (expression, dictionary, device)."""
    key = (expr.key(), id(d), str(device))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is d:
        _CACHE.move_to_end(key)
        return hit[1]
    prep = build()
    _CACHE[key] = (d, prep)
    while len(_CACHE) > _CACHE_SIZE:
        _CACHE.popitem(last=False)
    return prep


def _require_string(expr: Expression, child: Expression) -> None:
    if not isinstance(child.data_type, (T.StringType, T.NullType)):
        raise NotImplementedError(
            f"{expr.name} of {child.data_type.simple_string()} (an implicit "
            "cast to string) is not ported")


def transform_dictionary(d: np.ndarray, fn):
    """(sorted-unique dictionary, int32 remap) of ``fn`` over each entry of
    ``d``; a None result remaps to -1 (null)."""
    transformed = [fn(s) for s in d]
    non_null = [t for t in transformed if t is not None]
    out = np.unique(np.array(non_null, dtype=object)) if non_null \
        else _EMPTY
    pos = {s: i for i, s in enumerate(out)}
    remap = np.array([pos[t] if t is not None else -1 for t in transformed],
                     dtype=np.int32)
    return out, remap


# ---------------------------------------------------------------------------
# Dictionary-transform machinery
# ---------------------------------------------------------------------------

class DictStringToString(Expression):
    """str -> str via the host dictionary transform and one device gather.
    Subclasses implement ``transform(s) -> Optional[str]`` (None = null);
    ``_dict_index`` names the child whose dictionary is transformed."""

    _dict_index = 0

    @property
    def data_type(self):
        return T.STRING

    def transform(self, s: str) -> Optional[str]:
        raise NotImplementedError

    def resolve(self, bound):
        out = self.with_children(bound)
        _require_string(out, out.children[out._dict_index])
        return out

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        d = child_preps[self._dict_index].out_dict
        d = _EMPTY if d is None else d
        dev = pctx.table.device

        def build():
            out, remap = transform_dictionary(d, self.transform)
            if not len(remap):
                remap = np.zeros(1, dtype=np.int32)
            return NodePrep(out_dict=out, aux={
                "remap": torch.from_numpy(remap).to(dev)})
        return cached_prep(self, d, dev, build)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        cv = child_vals[self._dict_index]
        codes = dev_remap_codes(prep.aux["remap"], cv.data)
        return DevVal(codes.clamp_min(0), cv.validity & (codes >= 0))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[self._dict_index].eval_cpu(table)
        n = len(c)
        out = np.empty(n, dtype=object)
        validity = c.validity.copy()
        for i in range(n):
            if validity[i]:
                r = self.transform(c.data[i])
                if r is None:
                    validity[i] = False
                    out[i] = None
                else:
                    out[i] = r
            else:
                out[i] = None
        return HostColumn(T.STRING, out, validity)


class DictStringToValue(Expression):
    """str -> fixed-width value via a host lookup table and a device
    gather. Subclasses implement ``value_of(s)`` (None = null) and set
    ``out_type``."""

    out_type: T.DataType = T.INT

    @property
    def data_type(self):
        return self.out_type

    def value_of(self, s: str):
        raise NotImplementedError

    def resolve(self, bound):
        out = self.with_children(bound)
        _require_string(out, out.children[0])
        return out

    def prep(self, pctx: PrepCtx, child_preps) -> NodePrep:
        d = child_preps[0].out_dict
        d = _EMPTY if d is None else d
        dev = pctx.table.device

        def build():
            vals = np.zeros(max(len(d), 1), dtype=self.out_type.np_dtype)
            ok = np.ones(max(len(d), 1), dtype=np.bool_)
            for i, s in enumerate(d):
                v = self.value_of(s)
                if v is None:
                    ok[i] = False
                else:
                    vals[i] = v
            return NodePrep(aux={"vals": torch.from_numpy(vals).to(dev),
                                 "ok": torch.from_numpy(ok).to(dev)})
        return cached_prep(self, d, dev, build)

    def eval_dev(self, ctx: EvalCtx, child_vals, prep: NodePrep) -> DevVal:
        cv = child_vals[0]
        return DevVal(dev_remap_codes(prep.aux["vals"], cv.data),
                      cv.validity & dev_remap_codes(prep.aux["ok"], cv.data))

    def eval_cpu(self, table: HostTable) -> HostColumn:
        c = self.children[0].eval_cpu(table)
        n = len(c)
        np_dt = self.out_type.np_dtype
        out = np.zeros(n, dtype=np_dt)
        validity = c.validity.copy()
        for i in range(n):
            if validity[i]:
                v = self.value_of(c.data[i])
                if v is None:
                    validity[i] = False
                else:
                    out[i] = v
        return HostColumn(self.out_type, out, validity)


class _LiteralParams:
    """Mixin: every child after the first is a parameter. The dictionary
    transform folds literal parameters on the host; with a parameter that
    is not a literal the expression runs on the CPU route (the
    reference's), row by row over the parameters' values."""

    @property
    def device_supported(self):
        return all(isinstance(c, Literal) for c in self.children[1:])

    def eval_cpu(self, table: HostTable) -> HostColumn:
        if self.device_supported:
            return super().eval_cpu(table)
        kids = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        string_out = isinstance(self.data_type, T.StringType)
        out = (np.empty(n, dtype=object) if string_out
               else np.zeros(n, dtype=self.data_type.np_dtype))
        validity = np.zeros(n, dtype=np.bool_)
        bound = {}
        for i in range(n):
            if not all(k.validity[i] for k in kids):
                continue  # a null string or parameter: null
            params = tuple(k.data[i].item() if isinstance(k.data[i],
                                                          np.generic)
                           else k.data[i] for k in kids[1:])
            e = bound.get(params)
            if e is None:
                e = bound[params] = self.with_children(
                    [self.children[0]] + [Literal(v, c.data_type) for v, c in
                                          zip(params, self.children[1:])])
            r = (e.transform if string_out else e.value_of)(kids[0].data[i])
            if r is not None:
                out[i] = r
                validity[i] = True
        return HostColumn(self.data_type, out, validity)


# ---------------------------------------------------------------------------
# str -> str
# ---------------------------------------------------------------------------

class Upper(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s.upper()


class Lower(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s.lower()


class Reverse(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s[::-1]


class InitCap(DictStringToString, UnaryExpression):
    def transform(self, s):
        # Spark initcap: first letter of each space-separated word
        return " ".join(w.capitalize() for w in s.split(" "))


class StringTrim(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s.strip(" ")


class StringTrimLeft(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s.lstrip(" ")


class StringTrimRight(DictStringToString, UnaryExpression):
    def transform(self, s):
        return s.rstrip(" ")


class _Params(DictStringToString):
    """A string function of one column and literal parameters."""

    def __init__(self, child: Expression, *params: Expression):
        self.children = (child,) + tuple(params)

    def with_children(self, children):
        return type(self)(*children)


class Substring(_LiteralParams, _Params):
    """Spark substring: 1-based pos; pos 0 treated as 1; negative from
    the end."""

    def transform(self, s):
        pos, ln = self.children[1].value, self.children[2].value
        if ln < 0:
            return ""
        # Spark substringSQL: the end is computed BEFORE a negative start
        # is clamped, so substring('abcd', -5, 3) = 'ab'
        if pos > 0:
            start = pos - 1
        elif pos == 0:
            start = 0
        else:
            start = len(s) + pos
        end = start + ln
        return s[max(start, 0):max(end, 0)]


class StringRepeat(_LiteralParams, _Params):
    def transform(self, s):
        return s * max(int(self.children[1].value), 0)


class StringReplace(_LiteralParams, _Params):
    def transform(self, s):
        search = self.children[1].value
        if search == "":
            return s
        return s.replace(search, self.children[2].value or "")


class StringLPad(_LiteralParams, _Params):
    _left = True

    def transform(self, s):
        ln = int(self.children[1].value)
        if ln <= 0:
            return ""  # Spark: a non-positive target length yields ''
        pad = self.children[2].value
        if len(s) >= ln:
            return s[:ln]
        if not pad:
            return s
        fill = (pad * ln)[: ln - len(s)]
        return fill + s if self._left else s + fill


class StringRPad(StringLPad):
    _left = False


class SubstringIndex(_LiteralParams, _Params):
    def transform(self, s):
        delim, cnt = self.children[1].value, int(self.children[2].value)
        if not delim or cnt == 0:
            return ""
        parts = s.split(delim)
        if cnt > 0:
            return delim.join(parts[:cnt])
        return delim.join(parts[cnt:])


class StringTranslate(_LiteralParams, _Params):
    def transform(self, s):
        matching = self.children[1].value
        replace = self.children[2].value or ""
        table = {}
        for i, ch in enumerate(matching):
            if ord(ch) not in table:  # Spark: the FIRST mapping wins
                table[ord(ch)] = replace[i] if i < len(replace) else None
        return s.translate(table)


@functools.lru_cache(maxsize=1024)
def transpiled_regex(pattern: str):
    """(compiled regex, reason): a Java regex the transpiler accepts
    compiles in its Python form with re.ASCII (Java's default classes),
    reason None; one it rejects compiles as it is (the reference's CPU
    route, whose results may differ from Spark's) with the transpiler's
    reason."""
    from spark_rapids_tpu_torch.ops.regex_transpiler import try_transpile
    transpiled, reason = try_transpile(pattern)
    if transpiled is None:
        return re.compile(pattern), reason
    return re.compile(transpiled, re.ASCII), None


def guarded_regex(pattern: str):
    return transpiled_regex(pattern)[0]


class _Regex(_LiteralParams):
    """A pattern (child 1) outside the transpilable subset runs on the
    CPU route."""

    @property
    def device_supported(self):
        if not super().device_supported:
            return False
        pattern = self.children[1].value
        return pattern is None or transpiled_regex(pattern)[1] is None


class RegExpReplace(_Regex, _Params):
    @staticmethod
    def _java_replacement_to_python(rep: str) -> str:
        """Java replacement semantics: $N is a group reference ($0 the
        whole match), a backslash escapes the next character; everything
        else is literal."""
        out = []
        i = 0
        while i < len(rep):
            ch = rep[i]
            if ch == "\\" and i + 1 < len(rep):
                nxt = rep[i + 1]
                out.append("\\\\" if nxt == "\\" else nxt)
                i += 2
                continue
            if ch == "$" and i + 1 < len(rep) and rep[i + 1].isdigit():
                j = i + 1
                while j < len(rep) and rep[j].isdigit():
                    j += 1
                out.append(f"\\g<{rep[i + 1:j]}>")
                i = j
                continue
            out.append("\\\\" if ch == "\\" else ch)
            i += 1
        return "".join(out)

    def transform(self, s):
        rx = guarded_regex(self.children[1].value)
        rep = self._java_replacement_to_python(self.children[2].value or "")
        return rx.sub(rep, s)


class RegExpExtract(_Regex, _Params):
    def transform(self, s):
        m = guarded_regex(self.children[1].value).search(s)
        if m is None:
            return ""
        return m.group(int(self.children[2].value)) or ""


class Concat(DictStringToString):
    """concat: a dictionary transform when at most ONE child is not a
    literal; a multi-column concat runs on the CPU route (the
    reference's)."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def with_children(self, children):
        return Concat(*children)

    @property
    def _dict_index(self):
        for i, c in enumerate(self.children):
            if not isinstance(c, Literal):
                return i
        return 0

    def resolve(self, bound):
        out = Concat(*bound)
        non_lit = [c for c in out.children if not isinstance(c, Literal)]
        for c in non_lit:
            _require_string(out, c)
        return out

    @property
    def device_supported(self):
        # a multi-column concat: the reference's CPU route
        return sum(not isinstance(c, Literal) for c in self.children) <= 1

    def transform(self, s):
        parts = []
        for i, c in enumerate(self.children):
            if i != self._dict_index:
                if c.value is None:
                    return None  # concat with null -> null
                parts.append(str(c.value))
            else:
                parts.append(s)
        return "".join(parts)

    def eval_cpu(self, table: HostTable) -> HostColumn:
        cols = [c.eval_cpu(table) for c in self.children]
        n = table.num_rows
        out = np.empty(n, dtype=object)
        validity = np.ones(n, dtype=np.bool_)
        for i in range(n):
            parts = []
            for c in cols:
                if not c.validity[i]:
                    validity[i] = False
                    break
                parts.append(str(c.data[i]))
            out[i] = "".join(parts) if validity[i] else None
        return HostColumn(T.STRING, out, validity)


# ---------------------------------------------------------------------------
# str -> int / bool
# ---------------------------------------------------------------------------

class Length(DictStringToValue, UnaryExpression):
    out_type = T.INT

    def value_of(self, s):
        return len(s)


class BitLength(DictStringToValue, UnaryExpression):
    out_type = T.INT

    def value_of(self, s):
        return len(s.encode("utf-8")) * 8


class OctetLength(DictStringToValue, UnaryExpression):
    out_type = T.INT

    def value_of(self, s):
        return len(s.encode("utf-8"))


class Ascii(DictStringToValue, UnaryExpression):
    out_type = T.INT

    def value_of(self, s):
        return ord(s[0]) if s else 0


class _StringPredicate(_LiteralParams, DictStringToValue):
    out_type = T.BOOLEAN

    def __init__(self, child: Expression, param: Expression):
        self.children = (child, param)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def param(self) -> str:
        return self.children[1].value


class Contains(_StringPredicate):
    def value_of(self, s):
        return self.param in s


class StartsWith(_StringPredicate):
    def value_of(self, s):
        return s.startswith(self.param)


class EndsWith(_StringPredicate):
    def value_of(self, s):
        return s.endswith(self.param)


def like_to_regex(pattern: str, escape: str = "\\") -> str:
    """Spark-exact LIKE -> regex translation (% = .*, _ = ., the escape
    character quotes the next one)."""
    out = ["^"]
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    out.append("$")
    return "".join(out)


@functools.lru_cache(maxsize=1024)
def _like_regex(pattern: str):
    return re.compile(like_to_regex(pattern), re.DOTALL)


class Like(_StringPredicate):
    def value_of(self, s):
        return _like_regex(self.param).match(s) is not None


class RLike(_Regex, _StringPredicate):
    def value_of(self, s):
        return guarded_regex(self.param).search(s) is not None


class StringInstr(_LiteralParams, DictStringToValue):
    """instr: the 1-based position of the first occurrence, 0 if absent."""

    out_type = T.INT

    def __init__(self, child: Expression, substr: Expression):
        self.children = (child, substr)

    def with_children(self, children):
        return StringInstr(*children)

    def value_of(self, s):
        return s.find(self.children[1].value) + 1


class StringLocate(_LiteralParams, DictStringToValue):
    """locate(substr, str, start): 1-based, start 1-based. The string is
    child 0 (the dictionary transform's input)."""

    out_type = T.INT

    def __init__(self, substr: Expression, child: Expression,
                 start: Expression):
        self.children = (child, substr, start)

    def with_children(self, children):
        return StringLocate(children[1], children[0], children[2])

    def value_of(self, s):
        start = int(self.children[2].value)
        if start <= 0:
            return 0
        return s.find(self.children[1].value, start - 1) + 1


class Conv(_LiteralParams, _Params):
    """conv(numStr, fromBase, toBase): base conversion with Spark/Hive
    semantics (bases 2..36, literal bases; the digits stop at the first
    invalid character; '' -> null; toBase < 0 -> signed output)."""

    @staticmethod
    def _convert(s: str, from_base: int, to_base: int):
        """Hive NumberConverter: '' -> null; an optional '-'; digits stop
        at the FIRST invalid char; unsigned-64 accumulation saturates at
        2^64-1; a positive toBase prints unsigned, a negative one signed."""
        if not (2 <= from_base <= 36 and 2 <= abs(to_base) <= 36):
            return None
        if not s:
            return None
        neg = s.startswith("-")
        t = s[1:] if neg else s
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:from_base]
        u64_max = (1 << 64) - 1
        v = 0
        for ch in t.lower():
            d = digits.find(ch)
            if d < 0:
                break
            v = min(v * from_base + d, u64_max)
        if neg:
            v = (-v) & u64_max  # two's-complement wrap of the negation
        if to_base < 0 and v > (1 << 63) - 1:
            out_neg, v, base = True, (1 << 64) - v, -to_base
        else:
            out_neg, base = False, abs(to_base)
        alphabet = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        out = ""
        while True:
            out = alphabet[v % base] + out
            v //= base
            if v == 0:
                break
        return ("-" if out_neg else "") + out

    def transform(self, s):
        fb, tb = self.children[1].value, self.children[2].value
        if fb is None or tb is None:
            return None
        return self._convert(s, int(fb), int(tb))

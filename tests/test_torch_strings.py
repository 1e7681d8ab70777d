"""The port's string expressions (``ops/strings.py``: the dictionary
transforms, LIKE, RLIKE and the regex functions over the copied
``ops/regex_transpiler.py``; ``ops/misc.py``'s md5 and concat_ws) against
the JAX package's ``TpuSession`` on the same numpy inputs: a string
column of edge values (empty, spaces, digits, '%', '_', a backslash,
non-ASCII letters, long values, nulls) and a second column for the
multi-column cases.

Comparator: ``scale_test.tables_differ`` (bitwise, in order) for every
case. What the reference sends to its CPU route raises NotImplementedError
naming itself in the port: a multi-column concat, a non-literal
parameter, a regex the transpiler rejects. ``concat_ws`` builds a sorted
dictionary in the port (the reference's is unsorted and orders by code):
the deviation is pinned against Python's string order."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.ops import strings as JS
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import types as TT
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.ops import strings as TS
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from spark_rapids_tpu_torch.session import TorchSession

VALUES = ["", " ", "  a b  ", "abc", "ABC", "Hello World", "hello_world",
          "a%b", "50% off", "x_y_z", "back\\slash", "tab\tsep",
          "12345", "007 bond", "ab" * 20, "müller", "straße", "Ärger",
          "a.b.c.d", "aaa", "www.example.com", "PROMO box",
          "line\nbreak", "the quick brown fox jumps over the lazy dog"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _table():
    """s: VALUES and nulls; t: VALUES reversed (the second column)."""
    n = 2 * len(VALUES)
    s = np.array(VALUES + VALUES[::-1], dtype=object)
    t = np.array(VALUES[::-1] + VALUES, dtype=object)
    vs, vt = np.ones(n, bool), np.ones(n, bool)
    vs[5::9] = False
    vt[3::7] = False
    return (["s", "t"], ["string", "string"], [(s, vs), (t, vt)])


def _as_reference(names, types, arrays) -> JHostTable:
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, np.asarray(v, dtype=bool))
        for ty, (d, v) in zip(types, arrays)])


class _Api:
    def __init__(self, F, S, col, lit, T):
        self.F, self.S, self.col, self.lit = F, S, col, lit
        self.null_string = lit(None, T.STRING)


PORT = _Api(TF, TS, tcol, tlit, TT)
REF = _Api(JF, JS, jcol, jlit, JT)


def _select_both(exprs, table=None):
    table = table or _table()
    ref = jfrom(_as_reference(*table), TpuSession()).select(
        *[e.alias(n) for n, e in exprs(REF)]).collect_table()
    got = tfrom(host_table_from_arrays(*table),
                TorchSession(device="cpu")).select(
        *[e.alias(n) for n, e in exprs(PORT)]).collect_table()
    return _as_reference(*got.to_arrays()), ref


#: the cases, each a list of (name, expression) over the api
CASES = {
    "unary": lambda a: [
        ("up", a.F.upper("s")), ("low", a.F.lower("s")),
        ("rev", a.F.reverse("s")), ("cap", a.F.initcap("s")),
        ("tr", a.F.trim("s")), ("ltr", a.F.ltrim("s")),
        ("rtr", a.F.rtrim("s")), ("md5", a.F.md5("s"))],
    "values": lambda a: [
        ("len", a.F.length("s")), ("bits", a.F.bit_length("s")),
        ("octets", a.F.octet_length("s")), ("asc", a.F.ascii("s")),
        ("instr", a.F.instr("s", "b")), ("loc0", a.F.locate("o", "s", 0)),
        ("loc1", a.F.locate("o", "s")), ("loc5", a.F.locate("o", "s", 5))],
    "substring": lambda a: [
        ("p1", a.F.substring("s", 1, 3)), ("p0", a.F.substring("s", 0, 2)),
        ("neg", a.F.substring("s", -3, 2)),
        ("before", a.F.substring("s", -30, 28)),
        ("long", a.F.substring("s", 2, 100)),
        ("negl", a.F.substring("s", 2, -1))],
    "padding": lambda a: [
        ("lp", a.F.lpad("s", 8, "*")), ("rp", a.F.rpad("s", 8, "-=")),
        ("lcut", a.F.lpad("s", 2, "*")), ("empty", a.F.rpad("s", 6, "")),
        ("zero", a.F.lpad("s", 0, "*")), ("rep", a.F.repeat("s", 2)),
        ("rep0", a.F.repeat("s", -1))],
    "replace": lambda a: [
        ("rpl", a.F.replace("s", "a", "AA")), ("del", a.F.replace("s", "o")),
        ("none", a.F.replace("s", "", "x")),
        ("si", a.F.substring_index("s", ".", 2)),
        ("sineg", a.F.substring_index("s", ".", -1)),
        ("si0", a.F.substring_index("s", ".", 0)),
        ("trn", a.F.translate("s", "abca", "xyz")),
        ("cat", a.F.concat(a.lit("<"), a.col("s"), a.lit(">"))),
        ("catnull", a.F.concat(a.col("s"), a.null_string)),
        ("catone", a.F.concat(a.col("s")))],
    "predicates": lambda a: [
        ("has", a.F.contains("s", "o")), ("sw", a.F.startswith("s", "a")),
        ("ew", a.F.endswith("s", "d")), ("like", a.F.like("s", "a%")),
        ("like_", a.F.like("s", "_b%")), ("pct", a.F.like("s", "%\\%%")),
        ("under", a.F.like("s", "%\\_%")), ("dotall", a.F.like("s", "line%")),
        ("any", a.F.like("s", "%")), ("rl", a.F.rlike("s", "^[0-9]+")),
        ("rlw", a.F.rlike("s", "o\\s+[a-z]")), ("rld", a.F.rlike("s", "b.$"))],
    "regex": lambda a: [
        ("rr", a.F.regexp_replace("s", "[aeiou]", "#")),
        ("rg", a.F.regexp_replace("s", "(\\w+)\\.(\\w+)", "$2-$1")),
        ("re1", a.F.regexp_extract("s", "([a-z]+)(\\d*)", 1)),
        ("re0", a.F.regexp_extract("s", "([0-9]+)", 0)),
        ("re2", a.F.regexp_extract("s", "([a-z]+)_([a-z]+)", 2))],
    "conv": lambda a: [
        ("hex", a.S.Conv(a.col("s"), a.lit(10), a.lit(16))),
        ("bin", a.S.Conv(a.col("s"), a.lit(16), a.lit(-2))),
        ("b36", a.S.Conv(a.col("s"), a.lit(36), a.lit(10)))],
}


@pytest.mark.parametrize("case", list(CASES))
def test_string_functions_match_the_reference(case):
    got, ref = _select_both(CASES[case])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_sql_like_rlike_and_concat_operator_match_the_reference():
    """LIKE, NOT LIKE, RLIKE and || lowered from SQL text by both
    analyzers, as filter and projection."""
    table = _table()
    text = ("SELECT s || '#' AS tagged, t LIKE '%o%' AS has_o, "
            "s RLIKE '^[a-z]+$' AS lower_only FROM x "
            "WHERE s NOT LIKE 'a%' OR t LIKE '_b%'")
    js, ts = TpuSession(), TorchSession(device="cpu")
    jfrom(_as_reference(*table), js).create_or_replace_temp_view("x")
    tfrom(host_table_from_arrays(*table), ts).create_or_replace_temp_view("x")
    got = ts.sql(text).collect_table()
    want = js.sql(text).collect_table()
    diff = tables_differ(_as_reference(*got.to_arrays()), want)
    assert diff is None, diff
    assert 0 < got.num_rows < len(table[2][0][0])


def test_what_the_reference_sends_to_its_cpu_route_raises():
    """What the reference sends to its CPU route runs on the port's,
    reported: a multi-column concat, a regex outside the transpilable
    subset and a multi-column concat_ws equal the reference's
    (``tables_differ``); a string function with a column parameter (the
    reference's route reads a literal's value there and fails) equals
    Python's per row. An implicit cast of a number to a string still
    raises, as it binds."""
    from spark_rapids_tpu_torch.obs.events import collect_fallbacks
    got, ref = _select_both(lambda a: [
        ("cc", a.F.concat("s", "t")),
        ("rl", a.F.rlike("s", "\\bword")),
        ("cw", a.F.concat_ws("|", "s", "t"))])
    assert tables_differ(got, ref) is None
    ts = TorchSession(device="cpu")
    df = tfrom(host_table_from_arrays(*_table()), ts)
    out = df.select(TS.Substring(tcol("s"), TF.length("t"),
                                 tlit(2)).alias("x")).collect_table()
    assert collect_fallbacks(ts.last_meta) == [{"op": "Project", "reasons": [
        "expression Substring configuration is not supported on GPU"]}]
    (s, vs), (t, vt) = _table()[2]
    for i in range(len(s)):
        if not (vs[i] and vt[i]):
            assert not out.columns[0].validity[i]
            continue
        pos = len(t[i])
        start = pos - 1 if pos > 0 else 0
        assert out.columns[0].data[i] == s[i][max(start, 0):start + 2]
    with pytest.raises(NotImplementedError, match="implicit cast"):
        df.select(TF.upper(tlit(3)).alias("x"))


def test_concat_ws_matches_the_reference_where_codes_order_as_strings():
    """concat_ws with literals and one column, nulls skipped (a null
    child's row is the literals alone), and a null separator."""
    got, ref = _select_both(lambda a: [
        ("cw", a.F.concat_ws("|", a.lit("k"), a.col("s"), a.lit(None))),
        ("solo", a.F.concat_ws("-", a.col("s"))),
        ("lits", a.F.concat_ws(",", a.lit("a"), a.lit("b"))),
        ("nul", a.F.concat_ws(a.null_string, a.col("s")))])
    assert tables_differ(got, ref) is None, tables_differ(got, ref)


def test_concat_ws_sorts_as_strings_unlike_the_reference():
    """The pinned deviation: the reference's concat_ws dictionary stays in
    source order (and its null-child entry last), and ORDER BY orders by
    code; the port ranks the dictionary, so the sort follows Python's
    (Spark's) string order. 'a' < 'ab' in the source, but 'ab|x' <
    'a|x'; the null row ('x') sorts first in the port, last in the
    reference."""
    table = (["s"], ["string"], [(np.array(["a", "ab", "b", "zz"],
                                           dtype=object),
                                  np.array([True, True, True, False]))])

    def build(api, frm, session):
        return frm(table_of(api), session).select(
            api.F.concat_ws("|", api.col("s"), api.lit("x")).alias(
                "k")).sort("k")

    def table_of(api):
        return (_as_reference(*table) if api is REF
                else host_table_from_arrays(*table))

    got = build(PORT, tfrom, TorchSession(device="cpu")).collect()
    want = build(REF, jfrom, TpuSession()).collect()
    keys = ["a|x", "ab|x", "b|x", "x"]
    assert [r[0] for r in got] == sorted(keys)
    assert [r[0] for r in want] == keys  # the reference's code order
    # group-by over it agrees (one group a distinct string)
    got = tfrom(host_table_from_arrays(*table), TorchSession(
        device="cpu")).group_by(TF.concat_ws("|", "s").alias("k")).agg(
        TF.count("*").alias("n")).collect()
    assert sorted(got) == [("", 1), ("a", 1), ("ab", 1), ("b", 1)]


def test_dictionary_transforms_are_cached_per_dictionary():
    """A warm run of a string function over the same uploaded dictionary
    transforms no entry again (the host work of phase 12's cold runs)."""
    calls = []

    class Counting(TS.Upper):
        def transform(self, s):
            calls.append(s)
            return super().transform(s)

    df = tfrom(host_table_from_arrays(*_table()), TorchSession(device="cpu"))
    q = df.select(Counting(tcol("s")).alias("u"))
    first = q.collect()
    n = len(calls)
    assert n == len(set(VALUES))
    assert q.collect() == first
    assert len(calls) == n

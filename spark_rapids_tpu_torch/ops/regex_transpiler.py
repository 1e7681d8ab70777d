"""Java-regex -> Python-re transpiler with a strict reject guard (a copy
of ``spark_rapids_tpu/ops/regex_transpiler.py``, which imports only ``re``:
the port keeps its own copy so that it imports nothing of the reference).

Reference: RegexParser.scala (2,186 LoC) — spark-rapids treats regex
compatibility as a first-class problem: patterns are parsed and either
TRANSPILED to a semantically exact cudf pattern or REJECTED so the plan
falls back, never silently evaluated with divergent semantics. This module
is the same guard for Python `re`:

Java/Python divergences handled by transpilation (always compiled with
re.ASCII so remaining classes are ASCII like Java's default):

  \\d \\w \\s (and negations)  Java is ASCII-only; Python str patterns are
                            unicode -> expanded to explicit ASCII classes
  .                         Java excludes \\n \\r \\u0085 \\u2028 \\u2029;
                            Python excludes only \\n -> expanded class
  $                         Java matches before a FINAL line terminator
                            (incl. \\r, \\r\\n); Python only before \\n ->
                            lookahead expansion
  \\z / \\Z                   Java \\z == Python \\Z (absolute end); Java \\Z ->
                            the $ lookahead
  (?<name>...)              Java named group -> (?P<name>...)
  \\Q...\\E                   literal quoting -> re.escape'd text

REJECTED (raise RegexUnsupported; the port's expression then runs on the
CPU route over the pattern as written, the reason in its tag):
possessive quantifiers (a*+), character-class intersection ([a-z&&[b]]),
POSIX classes ([:alpha:]), \\p{...} properties, word boundaries \\b \\B
(Java's ASCII \\w definition cannot be expressed), \\G \\R \\h \\H \\v
\\V \\X, octal \\0nn, \\x{...}, inline flags (other than a single leading
(?s)), and anything Python's compiler itself refuses.
"""

from __future__ import annotations

import re

#: Java line terminators (Pattern: \n \r \u0085 \u2028 \u2029; . excludes
#: them all, $ matches before a final one)
_LINE_TERM = "\\n\\r\\u0085\\u2028\\u2029"

_DOT = f"[^{_LINE_TERM}]"
_DOLLAR = f"(?=(?:\\r\\n|[{_LINE_TERM}])?\\Z)"

_CLASS_EXPANSIONS = {
    "d": "[0-9]",
    "D": "[^0-9]",
    "w": "[a-zA-Z0-9_]",
    "W": "[^a-zA-Z0-9_]",
    "s": "[ \\t\\n\\x0b\\f\\r]",
    "S": "[^ \\t\\n\\x0b\\f\\r]",
}

_IN_CLASS_EXPANSIONS = {
    "d": "0-9",
    "w": "a-zA-Z0-9_",
    "s": " \\t\\n\\x0b\\f\\r",
}

#: escapes with identical semantics in both engines (passthrough)
_SAFE_ESCAPES = set("\\.[]{}()*+?^$|/-tnrfae" "0123456789" "xu")


class RegexUnsupported(Exception):
    """Pattern uses a construct whose Java semantics cannot be reproduced
    exactly with Python re — the expression must fall back."""


def transpile_java_regex(pattern: str) -> str:
    """Return a Python-re pattern (compile with re.ASCII) matching exactly
    like Java's Pattern (default flags), or raise RegexUnsupported."""
    out = []
    i = 0
    n = len(pattern)
    dotall = False
    if pattern.startswith("(?s)"):
        dotall = True
        out.append("(?s)")
        i = 4

    def reject(why):
        raise RegexUnsupported(f"regex {pattern!r}: {why}")

    while i < n:
        ch = pattern[i]
        if ch == "\\":
            if i + 1 >= n:
                reject("dangling backslash")
            nxt = pattern[i + 1]
            if nxt in _CLASS_EXPANSIONS:
                out.append(_CLASS_EXPANSIONS[nxt])
                i += 2
            elif nxt == "Q":
                end = pattern.find("\\E", i + 2)
                if end < 0:
                    reject("\\Q without \\E")
                out.append(re.escape(pattern[i + 2:end]))
                i = end + 2
            elif nxt == "z":
                out.append("\\Z")
                i += 2
            elif nxt == "Z":
                out.append(_DOLLAR)
                i += 2
            elif nxt == "A":
                out.append("\\A")
                i += 2
            elif nxt in ("b", "B", "G", "R", "h", "H", "v", "V", "X",
                         "p", "P", "k", "c"):
                reject(f"\\{nxt} has no exact Python equivalent")
            elif nxt == "0":
                reject("octal escapes differ between engines")
            elif nxt == "x" and i + 2 < n and pattern[i + 2] == "{":
                reject("\\x{...} is Java-only syntax")
            elif nxt in _SAFE_ESCAPES or not nxt.isalnum():
                out.append(pattern[i:i + 2])
                i += 2
            else:
                reject(f"escape \\{nxt} is not in the verified subset")
        elif ch == "[":
            cls, i = _transpile_class(pattern, i, reject)
            out.append(cls)
        elif ch == ".":
            out.append("." if dotall else _DOT)
            i += 1
        elif ch == "$":
            out.append(_DOLLAR)
            i += 1
        elif ch == "(":
            if pattern.startswith("(?", i) and not pattern.startswith("(?:", i):
                if pattern.startswith("(?<", i) and not (
                        pattern.startswith("(?<=", i)
                        or pattern.startswith("(?<!", i)):
                    out.append("(?P<")
                    i += 3
                elif (pattern.startswith("(?=", i)
                      or pattern.startswith("(?!", i)
                      or pattern.startswith("(?<=", i)
                      or pattern.startswith("(?<!", i)):
                    j = 4 if pattern.startswith("(?<", i) else 3
                    out.append(pattern[i:i + j])
                    i += j
                else:
                    reject("inline groups/flags beyond (?:...) "
                           "(?=/?!/?<=/?<!) and (?<name>) are unsupported")
            else:
                out.append(ch)
                i += 1
        elif ch in "*+?" and out and out[-1] and i + 1 < n \
                and pattern[i + 1] == "+":
            reject("possessive quantifiers are Java-only")
        else:
            out.append(ch)
            i += 1

    result = "".join(out)
    try:
        re.compile(result, re.ASCII)
    except re.error as e:
        reject(f"python re rejected the transpilation: {e}")
    return result


def _transpile_class(pattern: str, start: int, reject):
    """Transpile one [...] character class; returns (text, next_index)."""
    i = start + 1
    n = len(pattern)
    body = ["["]
    if i < n and pattern[i] == "^":
        body.append("^")
        i += 1
    if i < n and pattern[i] == "]":
        # Java allows a literal ] first; Python needs it escaped
        body.append("\\]")
        i += 1
    while i < n:
        ch = pattern[i]
        if ch == "]":
            body.append("]")
            return "".join(body), i + 1
        if ch == "&" and pattern.startswith("&&", i):
            reject("character-class intersection [..&&..] is Java-only")
        if ch == "[":
            if pattern.startswith("[:", i):
                reject("POSIX classes [:...:] are unsupported")
            reject("nested character classes are Java-only")
        if ch == "\\":
            if i + 1 >= n:
                reject("dangling backslash in class")
            nxt = pattern[i + 1]
            if nxt in _IN_CLASS_EXPANSIONS:
                body.append(_IN_CLASS_EXPANSIONS[nxt])
                i += 2
                continue
            if nxt in ("D", "W", "S"):
                reject(f"negated \\{nxt} inside a class cannot be expanded")
            if nxt in ("p", "P"):
                reject("\\p{...} properties are unsupported")
            if nxt == "0":
                reject("octal escapes differ between engines")
            body.append(pattern[i:i + 2])
            i += 2
            continue
        body.append(ch)
        i += 1
    reject("unterminated character class")


import functools


@functools.lru_cache(maxsize=1024)
def try_transpile(pattern: str):
    """(python_pattern, None) on success; (None, reason) on rejection.
    Cached: callers invoke this per dictionary entry / per row."""
    try:
        return transpile_java_regex(pattern), None
    except RegexUnsupported as e:
        return None, str(e)

"""The port's concurrency contract (spark_rapids_tpu_torch/lockorder.py and
lint/concurrency.py) against the reference's (spark_rapids_tpu/lockorder.py,
spark_rapids_tpu/lint/concurrency.py) on the same inputs:

* every synthetic case of the reference's lock tests (raw construction,
  the factory contract, unbound constructions, nesting, try-acquire, the
  call graph, a cycle that defeats the allowlist, effects, condition
  waits), re-pathed into each package, through both packages'
  ``check_concurrency`` with the same synthetic registry. Comparator: the
  multiset of (rule id, path) of the diagnostics, exactly (so the sets of
  rule ids agree), and each case's expected rule ids;
* the reference's witness sequences (rank inversion, self-deadlock, the
  condition wait's release, the construction-time election, the
  semaphore, the violation counter) on both ``lockorder`` modules.
  Comparator: the same trace of raises, held snapshots and counter
  deltas, exactly;
* the reference's witnessed chaos scenario on ``QueryService`` over
  ``TorchSession(device="cpu")`` (a 256 KiB device budget, three workers,
  eight submissions). Comparator: ``scale_test.tables_differ_unordered``
  against the reference's serial results, and a witness violation delta
  of 0;
* the port's table: every name shared with the reference keeps its rank
  and kind unless ``DEVIATIONS`` lists it (and every listed name does
  deviate), every factory call of the port names a declared lock;
* pins for the two rank inversions this table found: the topology
  snapshot acquires in ascending rank under an armed witness, and a
  witnessed spill -> disk -> unspill round trip under a tight budget and
  host limit is clean.

A raised LockOrderViolation can be swallowed (a weakref callback prints
"Exception ignored"), so every witnessed run is also held to
``witness_violations()``, with ``witness_violation_records()`` in the
failure message. Every test that arms the witness disarms it and resets
both counters in ``finally``.
"""

import ast
import collections
import re

import numpy as np
import pytest
import torch

from scale_test import tables_differ_unordered
from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import lockorder as jlo
from spark_rapids_tpu.conf import RapidsConf as JRapidsConf
from spark_rapids_tpu.lint import concurrency as jconc
from spark_rapids_tpu.ops.expr import col as jcol
from spark_rapids_tpu.ops.expr import lit as jlit
from spark_rapids_tpu.plan import from_host_table as jfrom
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import functions as TF
from spark_rapids_tpu_torch import lockorder as tlo
from spark_rapids_tpu_torch.conf import RapidsConf as TRapidsConf
from spark_rapids_tpu_torch.lint import concurrency as tconc
from spark_rapids_tpu_torch.ops.expr import col as tcol
from spark_rapids_tpu_torch.ops.expr import lit as tlit
from spark_rapids_tpu_torch.plan import from_host_table as tfrom
from tests.torch_service_util import (
    WAIT_S,
    as_reference,
    per_test_timeout,
    port_table,
    reference_table,
    reset_process_state,
)

REF, PORT = "spark_rapids_tpu", "spark_rapids_tpu_torch"
#: (package name, its lockorder module, its concurrency module, its conf)
PACKAGES = {REF: (jlo, jconc, JRapidsConf), PORT: (tlo, tconc, TRapidsConf)}


@pytest.fixture(autouse=True)
def _witness_off():
    """No test leaves a package's witness armed or its counter dirty."""
    yield
    for lo in (jlo, tlo):
        lo.disarm_witness()
        lo.reset_witness_violations()


# ---------------------------------------------------------------------------
# the static pass: the reference's synthetic cases in both packages
# ---------------------------------------------------------------------------

_REL = "{P}/runtime/cc_mod.py"
_TWO = (("t.a", 10, _REL + ":A", "Lock"), ("t.b", 20, _REL + ":B", "Lock"))
_HDR = ("from {P}.lockorder import ordered_lock\n"
        'A = ordered_lock("t.a")\n'
        'B = ordered_lock("t.b")\n')
_ONE = (("t.a", 10, _REL + ":A", "Lock"),)
_FHEAD = "from {P}.lockorder import ordered_lock\n"
_CV = (("t.a", 10, _REL + ":A", "Lock"), ("t.cv", 20, _REL + ":CV",
                                          "Condition"))
_CVHDR = ("from {P}.lockorder import ordered_lock, ordered_condition\n"
          'A = ordered_lock("t.a")\n'
          'CV = ordered_condition("t.cv")\n')
_NEST_UP = "def f():\n    with A:\n        with B:\n            pass\n"
_NEST_DOWN = "def f():\n    with B:\n        with A:\n            pass\n"
_ALLOW_F = {_REL + ":f": "test justification"}

#: id -> (files {rel: source}, registry decls, order allowlist, effect
#: allowlist, the rule ids the case must give); "{P}" is the package
CASES = {
    "raw_lock": ({"{P}/runtime/bad.py":
                  "import threading\nL = threading.Lock()\n"},
                 (), None, None, {"RL-LOCK-DECL"}),
    "raw_alias": ({"{P}/obs/bad.py":
                   "from threading import RLock as RL\nx = RL()\n"},
                  (), None, None, {"RL-LOCK-DECL"}),
    "raw_condition_semaphore": (
        {"{P}/service/bad.py": "import threading\nC = threading.Condition()"
                               "\nS = threading.BoundedSemaphore(2)\n"},
        (), None, None, {"RL-LOCK-DECL"}),
    "raw_out_of_scope": ({"{P}/plan/fine.py":
                          "import threading\nL = threading.Lock()\n"},
                         (), None, None, set()),
    "factory_undeclared": ({_REL: _FHEAD + 'X = ordered_lock("nope")\n'},
                           _ONE, None, None, {"RL-LOCK-DECL"}),
    "factory_non_literal": ({_REL: _FHEAD + "X = ordered_lock(name)\n"},
                            _ONE, None, None, {"RL-LOCK-DECL"}),
    "factory_wrong_site": ({_REL: _FHEAD + 'WRONG = ordered_lock("t.a")\n'},
                           _ONE, None, None, {"RL-LOCK-DECL"}),
    "factory_kind_mismatch": (
        {_REL: "from {P}.lockorder import ordered_rlock\n"
               'A = ordered_rlock("t.a")\n'},
        _ONE, None, None, {"RL-LOCK-DECL"}),
    "stale_entry": ({_REL: "x = 1\n"}, _ONE, None, None, {"RL-LOCK-DECL"}),
    "factory_clean": ({_REL: _FHEAD + 'A = ordered_lock("t.a")\n'},
                      _ONE, None, None, set()),
    # the shape the port's mesh gate had: a conditional expression binds
    # nothing the pass can pin to the declared site
    "unbound_conditional": (
        {_REL: _FHEAD + "class Svc:\n    def __init__(self, on):\n"
               '        self.g = (ordered_lock("t.a") if on else None)\n'},
        (("t.a", 10, _REL + ":Svc.g", "Lock"),), None, None,
        {"RL-LOCK-DECL"}),
    "bound_in_own_assignment": (
        {_REL: _FHEAD + "class Svc:\n    def __init__(self, on):\n"
               "        self.g = None\n        if on:\n"
               '            self.g = ordered_lock("t.a")\n'},
        (("t.a", 10, _REL + ":Svc.g", "Lock"),), None, None, set()),
    "nest_ascending": ({_REL: _HDR + _NEST_UP}, _TWO, None, None, set()),
    "nest_descending": ({_REL: _HDR + _NEST_DOWN}, _TWO, None, None,
                        {"RL-LOCK-ORDER"}),
    "try_acquire": ({_REL: _HDR + "def f():\n    with B:\n"
                     "        if A.acquire(blocking=False):\n"
                     "            A.release()\n"}, _TWO, None, None, set()),
    "nest_allowlisted": ({_REL: _HDR + _NEST_DOWN}, _TWO, _ALLOW_F, None,
                         set()),
    "call_graph": ({_REL: _HDR + "def g():\n    with A:\n        pass\n"
                    "def f():\n    with B:\n        g()\n"},
                   _TWO, None, None, {"RL-LOCK-ORDER"}),
    "method_via_self": (
        {_REL: _FHEAD + "class K:\n    def __init__(self):\n"
               '        self._a = ordered_lock("t.a")\n'
               '        self._b = ordered_lock("t.b")\n'
               "    def f(self):\n        with self._b:\n"
               "            self.g()\n"
               "    def g(self):\n        with self._a:\n"
               "            pass\n"},
        (("t.a", 10, _REL + ":K._a", "Lock"),
         ("t.b", 20, _REL + ":K._b", "Lock")), None, None,
        {"RL-LOCK-ORDER"}),
    "singleton_across_modules": (
        {"{P}/runtime/arb.py": _FHEAD + "class Arb:\n"
                               "    def __init__(self):\n"
                               '        self._lock = ordered_lock("t.a")\n'
                               "    def take(self):\n"
                               "        with self._lock:\n"
                               "            pass\n"
                               "ARB = Arb()\n",
         "{P}/service/user.py": "from {P}.lockorder import ordered_lock\n"
                                "from {P}.runtime.arb import ARB\n"
                                'B = ordered_lock("t.b")\n'
                                "def f():\n    with B:\n"
                                "        ARB.take()\n"},
        (("t.a", 10, "{P}/runtime/arb.py:Arb._lock", "Lock"),
         ("t.b", 20, "{P}/service/user.py:B", "Lock")), None, None,
        {"RL-LOCK-ORDER"}),
    "cycle_defeats_allowlist": (
        {_REL: _HDR + _NEST_UP.replace("def f", "def g2")
         + _NEST_DOWN.replace("def f", "def g")},
        _TWO, {_REL + ":g": "test justification"}, None,
        {"RL-LOCK-ORDER"}),
    "effects": ({_REL: _HDR + "import subprocess\n"
                 "from {P}.runtime.faults import fault_point\n"
                 "def f():\n    with A:\n"
                 "        subprocess.run(['x'])\n"
                 "        fault_point('t.point')\n"},
                _TWO, None, None, {"RL-LOCK-EFFECT"}),
    "effects_allowlisted": ({_REL: _HDR + "import subprocess\n"
                             "def f():\n    with A:\n"
                             "        subprocess.run(['x'])\n"},
                            _TWO, None, _ALLOW_F, set()),
    "socket_and_incident": ({_REL: _HDR + "def f(sock):\n    with A:\n"
                             "        sock.sendall(b'x')\n"
                             "        record_incident('k')\n"},
                            _TWO, None, None, {"RL-LOCK-EFFECT"}),
    "effect_through_call": ({_REL: _HDR + "import subprocess\n"
                             "def g():\n    subprocess.run(['x'])\n"
                             "def f():\n    with A:\n        g()\n"},
                            _TWO, None, None, {"RL-LOCK-EFFECT"}),
    "wait_other_condition": ({_REL: _CVHDR + "def f():\n    with A:\n"
                              "        with CV:\n            CV.wait()\n"},
                             _CV, None, None, {"RL-LOCK-EFFECT"}),
    "wait_own_condition": ({_REL: _CVHDR + "def f():\n    with CV:\n"
                            "        CV.wait()\n"}, _CV, None, None, set()),
}


def _run_case(pkg: str, case):
    files, decls, order_allow, effect_allow, _ = case
    lo, conc, _conf = PACKAGES[pkg]

    def fill(s):
        return s.replace("{P}", pkg)

    registry = {name: lo.LockDecl(name, rank, fill(site), kind, "test lock")
                for name, rank, site, kind in decls}
    diags = []
    conc.check_concurrency(
        {fill(rel): ast.parse(fill(src)) for rel, src in files.items()},
        diags, registry=registry,
        order_allow={fill(k): v for k, v in (order_allow or {}).items()},
        effect_allow={fill(k): v for k, v in (effect_allow or {}).items()})
    return diags


def _shape(pkg: str, diags):
    """(rule id, path with the package name taken out) of each
    diagnostic, as a multiset."""
    return collections.Counter(
        (d.rule_id, d.path.replace(pkg + "/", "{P}/")) for d in diags)


@pytest.mark.parametrize("case_id", sorted(CASES))
def test_synthetic_cases_match_the_reference(case_id):
    case = CASES[case_id]
    got = _run_case(PORT, case)
    want = _run_case(REF, case)
    assert _shape(PORT, got) == _shape(REF, want), (
        [str(d) for d in got], [str(d) for d in want])
    assert {d.rule_id for d in got} == case[4], [str(d) for d in got]


def test_synthetic_messages_match_the_reference():
    """The messages a reader acts on agree too (the cycle's path, the
    via evidence, the held and acquired names and ranks)."""
    for case_id in ("nest_descending", "call_graph",
                    "cycle_defeats_allowlist", "wait_other_condition",
                    "unbound_conditional"):
        got = sorted(d.message.replace(PORT + "/", "{P}/")
                     for d in _run_case(PORT, CASES[case_id]))
        want = sorted(d.message.replace(REF + "/", "{P}/")
                      for d in _run_case(REF, CASES[case_id]))
        assert got == want, case_id


def test_host_sync_under_a_lock_is_an_effect():
    """The effect classifier reads the port's torch spellings of a host
    sync (``.cpu()``, ``.item()`` of a torch value, ``host_fetch``), where
    the reference's reads its jax ones."""
    src = (_HDR + "import torch\n"
           "def f(t):\n    with A:\n"
           "        t.cpu()\n"
           "        torch.ones(2).sum().item()\n"
           "        host_fetch(t)\n"
           "def ok(x):\n    with A:\n        x.item()\n")
    diags = _run_case(PORT, ({_REL: src}, _TWO, None, None, None))
    msgs = sorted(d.message.split(" while")[0] for d in diags)
    assert {d.rule_id for d in diags} == {"RL-LOCK-EFFECT"}
    assert msgs == ["host sync .cpu()", "host sync .item()",
                    "host sync host_fetch()"], msgs
    assert sorted(d.path.rsplit(":", 1)[1] for d in diags) == [
        "7", "8", "9"]


# ---------------------------------------------------------------------------
# the witness: the reference's sequences on both modules
# ---------------------------------------------------------------------------

#: a pair whose kinds agree in both tables (the reference's own tests pair
#: streaming.query with memory.arbiter, an RLock in the port)
LOW, HIGH = "streaming.query", "faults.registry"


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the trace compares the type
        return type(e).__name__
    return "ok"


def _seq_inversion(lo, _conf):
    out = []
    lo.arm_witness()
    low, high = lo.ordered_lock(LOW), lo.ordered_lock(HIGH)
    v0 = lo.witness_violations()
    with low:
        with high:
            out.append(lo.held_snapshot())
    out.append(lo.held_snapshot())
    with high:
        out.append(_outcome(low.acquire))
        out.append(low.acquire(blocking=False))
        low.release()
        out.append(lo.held_snapshot())
    out.append(lo.held_snapshot())
    out.append(lo.witness_violations() - v0)
    rec = lo.witness_violation_records()
    out.append([(r["lock"], r["heldChain"]) for r in rec])
    return out


def _seq_self_deadlock(lo, _conf):
    out = []
    lo.arm_witness()
    low = lo.ordered_lock(LOW)
    v0 = lo.witness_violations()
    with low:
        out.append(_outcome(low.acquire))
    rl = lo.ordered_rlock("spill.batch")
    with rl:
        with rl:  # reentrant: no violation
            out.append(lo.held_snapshot())
    out.append(lo.witness_violations() - v0)
    return out


def _seq_condition_wait(lo, _conf):
    out = []
    lo.arm_witness()
    cv = lo.ordered_condition("service.scheduler.cond")
    handle = lo.ordered_lock("service.handle")
    with cv:
        out.append(lo.held_snapshot())
        out.append(cv.wait(timeout=0.01))
        out.append(lo.held_snapshot())
        out.append(cv.wait_for(lambda: True, timeout=0.01))
        with handle:  # 200 -> 220 ascends
            out.append(lo.held_snapshot())
        cv.notify()
        cv.notify_all()
    out.append(lo.held_snapshot())
    return out


def _seq_election(lo, conf):
    out = []
    lo.configure(conf({"spark.rapids.lint.lockWitness": "true"}))
    out.append(lo.witness_armed())
    out.append("witnessed" in repr(lo.ordered_lock(LOW)))
    lo.configure(conf())
    out.append(lo.witness_armed())
    raw = lo.ordered_lock(LOW)
    out.append((hasattr(raw, "_decl"), type(raw).__name__))
    out.append(type(lo.ordered_rlock("spill.batch")).__name__)
    out.append(type(lo.ordered_condition("semaphore.cond")).__name__)
    lo.arm_witness()
    with raw:  # built before arming: stays raw, untracked
        out.append(lo.held_snapshot())
    out.append(_outcome(lambda: lo.ordered_lock("no.such.lock")))
    out.append(_outcome(lambda: lo.ordered_rlock(LOW)))
    out.append(_outcome(lambda: lo.ordered_semaphore(LOW)))
    return out


def _seq_semaphore(lo, _conf, monkeypatch):
    """A declared Semaphore (neither table has one: a synthetic entry)."""
    monkeypatch.setitem(lo.LOCK_ORDER, "t.sem",
                        lo.LockDecl("t.sem", 5, "x.py:S", "Semaphore", ""))
    out = []
    lo.arm_witness()
    sem = lo.ordered_semaphore("t.sem", 2)
    low = lo.ordered_lock(LOW)
    with sem:
        with sem:  # two permits, one thread: allowed
            out.append(lo.held_snapshot())
    out.append(_outcome(sem.locked))
    with low:
        out.append(_outcome(sem.acquire))  # 100 held -> 5: inversion
    lo.disarm_witness()
    out.append(type(lo.ordered_semaphore("t.sem", 1)).__name__)
    return out


def _seq_counter(lo, _conf):
    """The violation counter of the reference's fleet test."""
    out = []
    lo.arm_witness()
    before = lo.witness_violations()
    low, high = lo.ordered_lock(LOW), lo.ordered_lock(HIGH)
    with low:
        with high:
            pass
    out.append(lo.witness_violations() - before)
    with high:
        out.append(_outcome(low.acquire))
    out.append(lo.witness_violations() - before)
    with low:
        out.append(_outcome(low.acquire))
    out.append(lo.witness_violations() - before)
    out.append(len(lo.witness_violation_records()) >= 2)
    lo.reset_witness_violations()
    out.append((lo.witness_violations(), lo.witness_violation_records()))
    return out


SEQUENCES = {"inversion": _seq_inversion, "self_deadlock": _seq_self_deadlock,
             "condition_wait": _seq_condition_wait, "election": _seq_election,
             "counter": _seq_counter}


def _trace(lo, conf, seq):
    try:
        return seq(lo, conf)
    finally:
        lo.disarm_witness()
        lo.reset_witness_violations()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_witness_sequences_match_the_reference(name):
    got = _trace(tlo, TRapidsConf, SEQUENCES[name])
    want = _trace(jlo, JRapidsConf, SEQUENCES[name])
    assert got == want
    assert tlo.held_snapshot() == [] and not tlo.witness_armed()


def test_witness_semaphore_matches_the_reference(monkeypatch):
    got = _trace(tlo, TRapidsConf,
                 lambda lo, c: _seq_semaphore(lo, c, monkeypatch))
    want = _trace(jlo, JRapidsConf,
                  lambda lo, c: _seq_semaphore(lo, c, monkeypatch))
    assert got == want
    assert got[1] == "AttributeError" and got[2] == "LockOrderViolation"


def test_witness_is_per_thread():
    """Another thread's held locks are not this thread's: the same
    descending pair on two threads raises nothing."""
    import threading
    tlo.arm_witness()
    low, high = tlo.ordered_lock(LOW), tlo.ordered_lock(HIGH)
    v0 = tlo.witness_violations()
    seen = []
    with high:
        t = threading.Thread(target=lambda: seen.append(
            _outcome(lambda: low.acquire() and low.release())))
        t.start()
        t.join(WAIT_S)
    assert seen == ["ok"] and tlo.witness_violations() == v0


# ---------------------------------------------------------------------------
# the witnessed chaos scenario of the reference
# ---------------------------------------------------------------------------

CHAOS_CONF = {
    "spark.rapids.lint.lockWitness": "true",
    # a small device budget forces arbiter/spill traffic under load
    "spark.rapids.memory.device.budgetBytes": str(256 * 1024),
}


def _chaos_spec():
    k = np.array(["a", "b", "c", "d"] * 60, dtype=object)
    v = np.arange(240, dtype=np.int64)
    ones = np.ones(240, bool)
    return (["k", "v"], ["string", "bigint"], [(k, ones), (v, ones)])


def test_witnessed_chaos_service_matches_the_reference():
    """Eight concurrent filter + group-by queries on three workers with
    the witness armed through the service's conf: every blocking
    acquisition of every worker respects LOCK_ORDER, and every result
    equals the reference's."""
    from spark_rapids_tpu_torch.service import QueryService
    reset_process_state()
    v0 = tlo.witness_violations()
    try:
        with per_test_timeout():
            with QueryService(dict(CHAOS_CONF), device="cpu",
                              max_concurrent=3) as svc:
                assert tlo.witness_armed()
                cond = svc._cond
                assert "witnessed" in repr(cond)
                df = tfrom(port_table(_chaos_spec()), svc.session,
                           num_batches=6)
                handles = [svc.submit(df.filter(tcol("v") >= tlit(i))
                                      .group_by("k")
                                      .agg(TF.sum("v").alias("sv")))
                           for i in range(8)]
                for h in handles:
                    assert h.wait(WAIT_S), h.state
                got = [h.result() for h in handles]
        assert tlo.held_snapshot() == []
        assert tlo.witness_violations() == v0, \
            tlo.witness_violation_records()
    finally:
        tlo.disarm_witness()
        reset_process_state()
    ref = TpuSession()
    jdf = jfrom(reference_table(_chaos_spec()), ref, num_batches=6)
    for i, table in enumerate(got):
        want = (jdf.filter(jcol("v") >= jlit(i)).group_by("k")
                .agg(JF.sum("v").alias("sv")).collect_table())
        assert tables_differ_unordered(as_reference(table), want) is None, i


# ---------------------------------------------------------------------------
# the port's table
# ---------------------------------------------------------------------------


def test_shared_names_keep_the_references_rank_and_kind():
    """Every name both tables declare keeps the reference's rank and kind,
    except the listed deviations, and each listed deviation does
    deviate."""
    shared = set(tlo.LOCK_ORDER) & set(jlo.LOCK_ORDER)
    differ = {n for n in shared
              if (tlo.LOCK_ORDER[n].rank, tlo.LOCK_ORDER[n].kind)
              != (jlo.LOCK_ORDER[n].rank, jlo.LOCK_ORDER[n].kind)}
    assert differ == set(tlo.DEVIATIONS)
    # every name of the reference's table is in the port's
    assert set(jlo.LOCK_ORDER) <= set(tlo.LOCK_ORDER)
    assert set(tlo.LOCK_ORDER) - set(jlo.LOCK_ORDER) == {
        "session.obs", "executable_cache", "fingerprint.epoch",
        "fingerprint.table_tokens", "mesh.logical", "profiler.recording",
        "profiler.nvtx", "io.scan.parquet", "io.scan.orc", "io.scan.csv",
        "io.scan.json"}
    assert tlo.LOCK_ORDER["memory.arbiter"].kind == "RLock"
    # the host arbiter's band sits between the batch and the catalog
    r = {n: d.rank for n, d in tlo.LOCK_ORDER.items()}
    assert r["spill.batch"] < r["host_alloc.instance"] < r["host_alloc.cv"] \
        < r["pinned_pool.instance"] < r["pinned_pool"] < r["spill.catalog"]
    # the session's observation lock is taken under the service's gate
    assert r["service.mesh_gate"] < r["session.obs"]
    # sites name the port's modules
    assert all(d.site.startswith(PORT + "/") for d in tlo.LOCK_ORDER.values())
    assert tlo.LOCK_ORDER["profiler"].site == (
        PORT + "/runtime/profiler.py:TorchProfiler._lock")
    assert tlo.LOCK_WITNESS.key == jlo.LOCK_WITNESS.key


def test_every_factory_call_of_the_port_names_a_declared_lock():
    """Once the factories resolve names an undeclared one raises at
    construction, so each literal name in the port's sources is declared,
    with the kind of its factory."""
    from spark_rapids_tpu_torch.lint.rules.common import (
        _iter_source_files,
        _repo_root,
    )
    kinds = {"ordered_lock": "Lock", "ordered_rlock": "RLock",
             "ordered_condition": "Condition",
             "ordered_semaphore": "Semaphore"}
    pat = re.compile(r"\b(ordered_\w+)\(\"([\w.]+)\"")
    seen = set()
    for path in _iter_source_files(_repo_root(None)):
        for fn, name in pat.findall(open(path, encoding="utf-8").read()):
            if fn in kinds:
                assert tlo.LOCK_ORDER[name].kind == kinds[fn], (path, name)
                seen.add(name)
    assert seen == set(tlo.LOCK_ORDER)


def test_registry_validation_refuses_a_broken_table(monkeypatch):
    decls = tlo._DECLS
    for bad in (decls + (decls[0],),
                (decls[1], decls[0]) + decls[2:],
                decls + (tlo.LockDecl("x.y", 99999, decls[0].site, "Lock",
                                      ""),)):
        monkeypatch.setattr(tlo, "_DECLS", bad)
        with pytest.raises(tlo.LockDeclError):
            tlo._validate_registry()
    monkeypatch.setattr(tlo, "_DECLS", decls)
    monkeypatch.setitem(tlo.DEVIATIONS, "no.such.lock", "why")
    with pytest.raises(tlo.LockDeclError, match="undeclared"):
        tlo._validate_registry()


def test_locks_md_lists_every_lock_and_deviation():
    md = tlo.generate_locks_md()
    assert md.startswith("# Lock order registry\n")
    assert "`spark_rapids_tpu_torch/lockorder.py`" in md
    for d in tlo.LOCK_ORDER.values():
        assert f"| {d.rank} | `{d.name}` | {d.kind} |" in md
    for name in tlo.DEVIATIONS:
        assert f"| `{name}` |" in md


# ---------------------------------------------------------------------------
# pins for the two rank inversions
# ---------------------------------------------------------------------------


def _record_acquisitions(monkeypatch):
    """The names of the witnessed acquisitions, in order."""
    order = []
    real = tlo._note_acquired

    def note(decl, oid, reentrant):
        order.append(decl.name)
        real(decl, oid, reentrant)

    monkeypatch.setattr(tlo, "_note_acquired", note)
    return order


def test_topology_snapshot_acquires_in_ascending_rank(monkeypatch):
    """``consistent_topology_snapshot`` over witnessed singletons: the
    nest is cluster -> health -> quarantine -> mesh -> arbiter (it took
    quarantine under mesh before), and the sections are those of the
    process's own singletons."""
    from spark_rapids_tpu_torch.parallel import mesh as tmesh
    from spark_rapids_tpu_torch.runtime import cluster as tcluster
    from spark_rapids_tpu_torch.runtime import health as thealth
    from spark_rapids_tpu_torch.runtime import memory as tmemory
    want_keys = set(thealth.consistent_topology_snapshot())
    tlo.arm_witness()
    try:
        monkeypatch.setattr(tcluster, "CLUSTER", tcluster.ClusterRuntime())
        monkeypatch.setattr(thealth, "HEALTH", thealth.DeviceHealthMonitor())
        monkeypatch.setattr(thealth, "QUARANTINE",
                            thealth.QuarantineRegistry())
        monkeypatch.setattr(tmesh, "MESH", tmesh.MeshRuntime())
        monkeypatch.setattr(tmemory, "MEMORY", tmemory.MemoryArbiter())
    finally:
        tlo.disarm_witness()
    order = _record_acquisitions(monkeypatch)
    v0 = tlo.witness_violations()
    snap = thealth.consistent_topology_snapshot()
    assert tlo.witness_violations() == v0, tlo.witness_violation_records()
    assert set(snap) == want_keys
    nest = [n for i, n in enumerate(order) if n not in order[:i]]
    assert nest == ["cluster.runtime", "health.monitor", "health.quarantine",
                    "mesh.runtime", "memory.arbiter"]
    assert [tlo.LOCK_ORDER[n].rank for n in nest] == sorted(
        tlo.LOCK_ORDER[n].rank for n in nest)
    assert tlo.held_snapshot() == []


def _long_table(rows, seed):
    from spark_rapids_tpu_torch.columnar.table import upload_host_table
    from spark_rapids_tpu_torch.interop import host_table_from_arrays
    host = host_table_from_arrays(
        ["a"], ["bigint"], [(np.arange(rows) * (seed + 1),
                             np.ones(rows, bool))])
    return upload_host_table(host, "cpu")


def test_witnessed_spill_round_trip_is_clean(monkeypatch, tmp_path):
    """Spill -> disk -> unspill round trips with every lock they take
    witnessed: the batches' RLocks, the host arbiter, the catalog and the
    device arbiter (a budget of one batch, so an unspill's landing spills
    the other batch with the first one's lock held; then a host limit of
    one copy, so a spill's grant first moves the host tier to disk). The
    host grants were taken under spill.batch at ranks below it; now no
    acquisition inverts, every batch comes back bit-identical and every
    grant returns."""
    from spark_rapids_tpu_torch.runtime import host_alloc as thost
    from spark_rapids_tpu_torch.runtime import memory as tmemory
    from spark_rapids_tpu_torch.runtime import spill as tspill
    reset_process_state()
    v0 = tlo.witness_violations()
    tlo.arm_witness()
    try:
        arb = tmemory.MemoryArbiter()
        arb.configure(TRapidsConf(
            {"spark.rapids.memory.device.budgetBytes": "40000"}))
        monkeypatch.setattr(tmemory, "MEMORY", arb)
        monkeypatch.setattr(tspill.BufferCatalog, "_instance", None)
        catalog = tspill.BufferCatalog.reset(1 << 30, str(tmp_path))
        host = thost.HostMemoryArbiter.reset(80_000)
        keep, sbs = [], []
        for seed in range(2):
            t = _long_table(4096, seed)
            keep.append(t.columns[0].data.clone())
            sbs.append(tspill.SpillableBatch(t, catalog))
            del t  # the batch's handle is the table's only reference
        assert "witnessed" in repr(sbs[0]._lock)
        assert "witnessed" in repr(host._cv)
    finally:
        tlo.disarm_witness()
    order = _record_acquisitions(monkeypatch)
    try:
        # the second batch's landing spilled the first to the host
        assert [sb.tier for sb in sbs] == ["HOST", "DEVICE"]
        assert sbs[0].spill_to_disk() > 0 and sbs[0].tier == "DISK"
        # unspill from disk: the frame's grant under batch 0's lock, then
        # the landing's account spills batch 1 with that lock held
        assert torch.equal(sbs[0].get().columns[0].data, keep[0])
        assert [sb.tier for sb in sbs] == ["DEVICE", "HOST"]
        # one copy fits the host now: batch 0's grant moves batch 1's
        # host copy to disk first (under batch 0's lock)
        host.limit_bytes = 40_000
        assert sbs[0].spill_to_host() > 0
        assert [sb.tier for sb in sbs] == ["HOST", "DISK"]
        assert host.spill_triggered_count == 1
        # batch 1's frame grant moves batch 0 to disk under batch 1's lock
        assert torch.equal(sbs[1].get().columns[0].data, keep[1])
        assert [sb.tier for sb in sbs] == ["DISK", "DEVICE"]
        assert host.spill_triggered_count == 2
        for sb in sbs:
            sb.release()
        assert host.used_bytes == 0
        assert {"spill.batch", "host_alloc.cv", "spill.catalog",
                "memory.arbiter"} <= set(order)
        assert tlo.witness_violations() == v0, \
            tlo.witness_violation_records()
        assert tlo.held_snapshot() == []
    finally:
        thost.HostMemoryArbiter.reset(4 << 30)
        reset_process_state()

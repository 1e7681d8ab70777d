"""The port's OOM retry framework (spark_rapids_tpu_torch/runtime/retry.py)
against the JAX package's (spark_rapids_tpu/runtime/retry.py) on the CPU:
``with_retry``, ``with_retry_no_split`` and ``retry_block`` under injected
RetryOOM and SplitAndRetryOOM give the uninjected run's results and the
reference's ``oomRetries`` and ``splitRetries`` (and its FatalDeviceOOM
where retries run out); ``split_device_table_in_half`` gives the
reference's halves of prefix and masked batches; a replay inside a
speculation attempt keeps that attempt's flags.

Comparators: host tables with ``scale_test.tables_differ`` (bitwise, in
order); counters as integers."""

import numpy as np
import pytest
import torch

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import DeviceTable as JDeviceTable
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.errors import FatalDeviceOOM as JFatal
from spark_rapids_tpu.runtime import memory as jmem
from spark_rapids_tpu.runtime import retry as jretry
from spark_rapids_tpu.runtime import spill as jspill
from spark_rapids_tpu_torch.columnar import DeviceTable
from spark_rapids_tpu_torch.columnar.table import (
    concat_host,
    upload_host_table,
)
from spark_rapids_tpu_torch.errors import FatalDeviceOOM, RetryOOM
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.runtime import memory as tmem
from spark_rapids_tpu_torch.runtime import retry as tretry
from spark_rapids_tpu_torch.runtime import speculation as tspec
from spark_rapids_tpu_torch.runtime import spill as tspill

CPU = torch.device("cpu")
N = 1000


@pytest.fixture(autouse=True)
def _fresh_state():
    jspill.BufferCatalog.reset()
    tspill.BufferCatalog.reset()
    jretry.RMM_TPU.clear()
    tretry.RMM_TPU.clear()
    yield
    jretry.RMM_TPU.clear()
    tretry.RMM_TPU.clear()
    jspill.BufferCatalog.reset()
    tspill.BufferCatalog.reset()


def _arrays(n=N, seed=5):
    rng = np.random.default_rng(seed)
    return (["k", "v", "s"], ["bigint", "double", "string"], [
        (rng.integers(0, 50, n), rng.random(n) > 0.1),
        (rng.standard_normal(n), np.ones(n, bool)),
        (np.array([f"x{v}" for v in rng.integers(0, 30, n)], dtype=object),
         rng.random(n) > 0.2)])


def _ref_host(names, types, arrays) -> JHostTable:
    return JHostTable(names, [JHostColumn(JT.parse_type(t), np.asarray(d),
                                          np.asarray(v, dtype=bool))
                              for t, (d, v) in zip(types, arrays)])


def _as_ref(t) -> JHostTable:
    return _ref_host(*t.to_arrays())


def _tables(masked: bool):
    """(port DeviceTable, reference DeviceTable) of one batch; masked:
    every row whose key is odd."""
    a = _arrays()
    t = upload_host_table(host_table_from_arrays(*a), CPU)
    j = JDeviceTable.from_host(_ref_host(*a))
    if masked:
        import jax.numpy as jnp
        keep = (a[2][0][0] % 2 == 1)
        tl = torch.zeros(t.capacity, dtype=torch.bool)
        tl[:N] = torch.from_numpy(keep)
        jl = np.zeros(j.capacity, bool)
        jl[:N] = keep
        t = DeviceTable(t.names, t.columns, int(keep.sum()), t.capacity,
                        CPU, live=tl)
        j = JDeviceTable(j.names, j.columns, int(keep.sum()), j.capacity,
                         live=jnp.asarray(jl))
    return t, j


def _counters():
    return ((tmem.MEM_SCOPE.get("oomRetries", 0),
             tmem.MEM_SCOPE.get("splitRetries", 0)),
            (jmem.MEM_SCOPE.get("oomRetries", 0),
             jmem.MEM_SCOPE.get("splitRetries", 0)))


def _arm(rmm, kind, n):
    if kind == "retry":
        rmm.force_retry_oom(n)
    elif kind == "split":
        rmm.force_split_and_retry_oom(n)


INJECTIONS = [(None, 0), ("retry", 1), ("retry", 2), ("retry", 3),
              ("split", 1), ("split", 2)]


@pytest.mark.parametrize("kind,n", INJECTIONS)
@pytest.mark.parametrize("splittable", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_with_retry_matches_reference(kind, n, splittable, masked):
    """Each result batch downloaded: the rows equal the uninjected run's,
    and the outcome (rows or FatalDeviceOOM) and the counters equal the
    reference's."""
    t, j = _tables(masked)
    want_rows = t.to_host()
    (t0, j0) = _counters()
    _arm(tretry.RMM_TPU, kind, n)
    _arm(jretry.RMM_TPU, kind, n)
    run_t = tretry.with_retry if splittable else tretry.with_retry_no_split
    run_j = jretry.with_retry if splittable else jretry.with_retry_no_split
    got = want = None
    try:
        got = [b.to_host() for b in run_t(t, lambda d: d)]
    except FatalDeviceOOM:
        got = "fatal"
    try:
        want = [b.to_host() for b in run_j(j, lambda d: d)]
    except JFatal:
        want = "fatal"
    (t1, j1) = _counters()
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    if want == "fatal":
        assert got == "fatal"
        return
    assert got != "fatal" and len(got) == len(want)
    assert tables_differ(_as_ref(concat_host(got)), _as_ref(want_rows)) \
        is None
    for g, w in zip(got, want):
        assert tables_differ(_as_ref(g), w) is None


@pytest.mark.parametrize("kind,n", INJECTIONS)
def test_retry_block_matches_reference(kind, n):
    t, j = _tables(False)
    want_rows = t.to_host()
    (t0, j0) = _counters()
    _arm(tretry.RMM_TPU, kind, n)
    _arm(jretry.RMM_TPU, kind, n)
    try:
        got = tretry.retry_block(lambda: t.to_host())
    except FatalDeviceOOM:
        got = "fatal"
    try:
        want = jretry.retry_block(lambda: j.to_host())
    except JFatal:
        want = "fatal"
    (t1, j1) = _counters()
    assert (t1[0] - t0[0], t1[1] - t0[1]) == (j1[0] - j0[0], j1[1] - j0[1])
    assert (got == "fatal") == (want == "fatal")
    if got != "fatal":
        assert tables_differ(_as_ref(got), _as_ref(want_rows)) is None


@pytest.mark.parametrize("masked", [False, True])
def test_split_in_half_matches_reference(masked):
    t, j = _tables(masked)
    got = tretry.split_device_table_in_half(t)
    want = jretry.split_device_table_in_half(j)
    assert [h.capacity for h in got] == [h.capacity for h in want]
    assert [h.num_rows for h in got] == [h.num_rows for h in want]
    for g, w in zip(got, want):
        assert g.live is None
        assert tables_differ(_as_ref(g.to_host()), w.to_host()) is None


def test_split_floor_is_fatal():
    one = upload_host_table(host_table_from_arrays(*_arrays(1)), CPU)
    with pytest.raises(FatalDeviceOOM, match="cannot split"):
        tretry.split_device_table_in_half(one)


def test_replay_keeps_the_attempts_flags():
    """A retry_block replay inside a speculation attempt drops only the
    flags its failed try added: the attempt's earlier flags stay pending
    and are validated at collect."""
    tok = tspec.activate()
    try:
        ctx = tspec.current()
        ctx.add_flag("site:before", torch.tensor(False))
        tries = []

        def body():
            ctx.add_flag(f"site:try{len(tries)}", torch.tensor(False))
            tries.append(1)
            if len(tries) == 1:
                raise RetryOOM("first try")
            return "ok"

        assert tretry.retry_block(body) == "ok"
        assert [s for s, _ in ctx.pending] == ["site:before", "site:try1"]
        ctx.validate_remaining()
    finally:
        tspec.deactivate(tok)


def test_real_cuda_oom_is_a_device_oom():
    """torch's OutOfMemoryError is retried like a RetryOOM: one replay
    after the spill pass, then the result."""
    calls = []

    def body():
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return len(calls)

    r0 = tmem.MEM_SCOPE.get("oomRetries", 0)
    assert tretry.retry_block(body) == 2
    assert tmem.MEM_SCOPE.get("oomRetries", 0) == r0 + 1
    assert tretry.is_device_oom(torch.cuda.OutOfMemoryError("x"))
    assert not tretry.is_device_oom(ValueError("x"))

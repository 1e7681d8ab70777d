"""Import hygiene and device rules of the PyTorch port
(spark_rapids_tpu_torch): it imports neither JAX nor the JAX package, nor
pyarrow or pandas (neither is on the card's machine: the port reads and
writes Parquet, ORC, CSV, Hive text and JSON with its own codecs), never runs on the CPU unless asked, and raises NotImplementedError for
what it has not ported instead of answering wrongly."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import spark_rapids_tpu_torch
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.session import TorchSession

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "spark_rapids_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


#: top-level modules neither the port nor chip_smoke.py may import
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu", "pyarrow", "pandas")


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


_BLOCK = "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)


def test_every_module_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with JAX, the
    JAX package, pyarrow and pandas blocked, as on the card's machine."""
    code = (
        "import sys, pkgutil, importlib\n" + _BLOCK +
        "import spark_rapids_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'spark_rapids_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 25
    assert {f"spark_rapids_tpu_torch.overrides.{m}"
            for m in PLANNING_MODULES} <= names


#: the planning modules of the overrides (the type signatures, the
#: generated matrix, the API audit and the cost-based optimizer)
PLANNING_MODULES = ("typesig", "docs", "api_validation", "optimizer")


#: the distribution's modules: the host shuffle, the mesh, the re-land,
#: the cluster and its executor entry point
DISTRIBUTION_MODULES = (
    "shuffle.serializer", "shuffle.catalogs", "shuffle.manager",
    "shuffle.transport", "shuffle.client_server", "shuffle.heartbeat",
    "shuffle.p2p", "parallel", "parallel.mesh", "parallel.exchange",
    "execs.mesh", "runtime.cluster", "runtime.cluster_exec")


@pytest.mark.parametrize("mod", DISTRIBUTION_MODULES)
def test_the_distribution_modules_are_scanned(mod):
    """The AST scan and the blocked import above cover every module of the
    distribution, the executor's entry point included."""
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    path = "spark_rapids_tpu_torch/" + mod.replace(".", "/")
    assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned


def test_an_executor_scans_with_the_forbidden_modules_blocked(tmp_path):
    """At run time too: a driver and an executor (thread mode, in a process
    where JAX, the JAX package, pyarrow and pandas cannot import) scan a
    Parquet file by host; nothing forbidden gets imported and no CUDA
    context is made."""
    code = (
        "import sys\n" + _BLOCK +
        "import numpy as np, torch\n"
        "from spark_rapids_tpu_torch.interop import host_table_from_arrays\n"
        "from spark_rapids_tpu_torch.plan import from_host_table\n"
        "from spark_rapids_tpu_torch.session import TorchSession\n"
        "from spark_rapids_tpu_torch.runtime import cluster as C\n"
        "import os\n"
        f"d = {str(tmp_path)!r}\n"
        "t = host_table_from_arrays(['k'], ['bigint'], "
        "[(np.arange(50, dtype=np.int64), np.ones(50, bool))])\n"
        "from_host_table(t, TorchSession(device='cpu')).write_parquet(d)\n"
        "paths = sorted(os.path.join(d, f) for f in os.listdir(d) "
        "if f.endswith('.parquet'))\n"
        "drv = C.ClusterDriver(1)\n"
        "ex = C.spawn_executor(drv.address, 'h0', mode='thread')\n"
        "try:\n"
        "    drv.wait_ready(1, 30)\n"
        "    C.CLUSTER.attach_driver(drv)\n"
        "    s = TorchSession({'spark.rapids.cluster.enabled': 'true'}, "
        "device='cpu')\n"
        "    assert s.read_parquet(*paths).collect_table().num_rows == 50\n"
        "    assert s.last_metrics()['hostShardsLanded'] == len(paths)\n"
        "finally:\n"
        "    ex.terminate(); drv.shutdown()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_the_planning_modules_are_scanned():
    """The AST scan above covers the overrides' planning modules."""
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {f"spark_rapids_tpu_torch/overrides/{m}.py"
            for m in PLANNING_MODULES} <= scanned


def test_session_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSession(device="cuda")
    with pytest.raises(RuntimeError):
        spark_rapids_tpu_torch.default_device()
    assert TorchSession(device="cpu").device.type == "cpu"


def test_kernel_wrappers_refuse_non_cuda_devices():
    """A wrapper takes its plain version only for CPU tensors; any other
    device must launch the kernel or raise (here: raise)."""
    from spark_rapids_tpu_torch.kernels.compact import gather_compact
    from spark_rapids_tpu_torch.kernels.segreduce import onehot_partials
    from spark_rapids_tpu_torch.kernels.sort import sort_with_payload
    meta = torch.device("meta")
    x = torch.zeros((128, 2), dtype=torch.float64, device=meta)
    gid = torch.zeros(128, dtype=torch.int32, device=meta)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        onehot_partials(x, gid, 8, 1, 128)
    keep = torch.zeros(128, dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        gather_compact([gid], [keep], keep, 128)
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        sort_with_payload([gid], gid)


def test_unported_pieces_raise_not_implemented():
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.ops.expr import col, lit
    from spark_rapids_tpu_torch.plan import from_host_table
    # spark.rapids.sql.enabled=false runs on the CPU route (an unknown
    # key still raises)
    assert RapidsConf({"spark.rapids.sql.enabled": "false"}).sql_enabled \
        is False
    with pytest.raises(NotImplementedError, match="conf keys"):
        RapidsConf({"spark.rapids.sql.no.such.key": "1"})
    s = TorchSession(device="cpu")
    t = HostTable(["k", "v", "d"], [
        HostColumn(spark_rapids_tpu_torch.types.LONG,
                   np.arange(10, dtype=np.int64)),
        HostColumn(spark_rapids_tpu_torch.types.DOUBLE, np.ones(10)),
        HostColumn(spark_rapids_tpu_torch.types.DecimalType(12, 2),
                   np.arange(10, dtype=np.int64))])
    df = from_host_table(t, s)
    # the global aggregate is ported: one row
    assert df.agg(F.sum(col("v")), F.max(col("k"))).collect() == [(10.0, 9)]
    # a cast to string and a DECIMAL128 variance run on the CPU route
    # (checked against the reference below); a TIMESTAMP literal holds
    # the reference's internal value, UTC microseconds
    import datetime

    from spark_rapids_tpu.ops.expr import lit as ref_lit
    assert lit(datetime.datetime(2020, 1, 1)).value == \
        ref_lit(datetime.datetime(2020, 1, 1)).value == 1577836800000000
    # the pieces this test once held to raising (negation, MIN over
    # BOOLEAN, MAX over a decimal, a decimal sum, a DECIMAL128 quotient)
    # run, and equal the reference's answers
    from spark_rapids_tpu import functions as JF
    from spark_rapids_tpu import types as JT
    from spark_rapids_tpu.columnar import HostColumn as JHostColumn
    from spark_rapids_tpu.columnar import HostTable as JHostTable
    from spark_rapids_tpu.ops.expr import col as jcol
    from spark_rapids_tpu.ops.expr import lit as jlit
    from spark_rapids_tpu.plan import from_host_table as jfrom
    from spark_rapids_tpu.session import TpuSession
    jt = JHostTable(t.names, [JHostColumn(JT.parse_type(
        c.dtype.simple_string()), c.data, c.validity) for c in t.columns])
    jdf = jfrom(jt, TpuSession())

    def query(d, F, c, lt):
        return [d.select((-c("k")).alias("n"),
                         (c("k") + c("d")).alias("x"),
                         (c("d") / (c("d") + lt(1))).alias("q"),
                         c("k").cast("string").alias("ks")).collect(),
                sorted(d.group_by("k").agg(
                    F.min(c("k") > lt(3)).alias("b"),
                    F.max(c("d")).alias("m")).collect()),
                d.agg(F.variance(c("d") * c("d")).alias("var")).collect()]

    assert query(df, F, col, lit) == query(jdf, JF, jcol, jlit)


#: the memory runtime's modules (and the copies of the reference's
#: lockorder and metrics factories they use): each must exist, import
#: with JAX and the JAX package blocked, and import neither
RUNTIME_MODULES = ("runtime/device_manager.py", "runtime/host_alloc.py",
                   "runtime/spill.py", "runtime/memory.py",
                   "runtime/retry.py", "runtime/semaphore.py",
                   "runtime/placement.py", "lockorder.py",
                   "obs/metrics.py")


@pytest.mark.parametrize("rel", RUNTIME_MODULES)
def test_runtime_module_is_the_ports_own(rel):
    path = PORT / rel
    assert path.exists(), rel
    assert path in _port_files()
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['spark_rapids_tpu'] = None\n"
        f"importlib.import_module('spark_rapids_tpu_torch.' + "
        f"{rel[:-3].replace('/', '.')!r})\n"
        "assert not [m for m in sys.modules if (m.startswith('jax') or "
        "m.startswith('spark_rapids_tpu.')) and sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


#: the IO slices' modules, and the bloom filter and recovery modules:
#: each must exist and import with JAX, the JAX package, pyarrow and
#: pandas blocked
IO_MODULES = ("io/parquet_format.py", "io/parquet.py", "io/common.py",
              "io/avro.py", "io/writer.py", "io/committer.py",
              "io/filecache.py", "sources.py", "native/__init__.py",
              "runtime/faults.py", "ops/inputfile.py",
              "overrides/input_file.py", "io/text_format.py", "io/csv.py",
              "io/json.py", "io/hive_text.py", "io/orc_format.py",
              "io/orc.py", "ops/bloom.py", "runtime/health.py",
              "runtime/crash_handler.py")


@pytest.mark.parametrize("rel", IO_MODULES)
def test_io_module_is_the_ports_own(rel):
    path = PORT / rel
    assert path.exists(), rel
    assert path in _port_files()
    mod = rel[:-3].replace("/", ".").replace(".__init__", "")
    code = (
        "import sys, importlib\n" + _BLOCK +
        f"importlib.import_module('spark_rapids_tpu_torch.' + {mod!r})\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


#: the query envelope's modules, each covered by the scans above
ENVELOPE_MODULES = (
    "dispatch", "lore", "runtime/profiler", "obs/spans", "obs/events",
    "plan/fingerprint", "plan/executable_cache", "tools/__init__",
    "tools/__main__", "tools/report", "tools/compare", "tools/warmup")


@pytest.mark.parametrize("name", ENVELOPE_MODULES)
def test_envelope_modules_are_scanned(name):
    assert PORT / f"{name}.py" in _port_files()


#: the nested types' modules: each must exist and import with JAX, the
#: JAX package, pyarrow and pandas blocked
NESTED_MODULES = ("columnar/nested.py", "ops/collections.py",
                  "ops/nested.py", "execs/generate.py")


@pytest.mark.parametrize("rel", NESTED_MODULES)
def test_nested_module_is_the_ports_own(rel):
    test_io_module_is_the_ports_own(rel)


def test_warmup_reaches_neither_scale_test_nor_the_reference(tmp_path):
    """tools warmup resolves a query tag against the port's own corpus:
    with scale_test.py and the reference's lint blocked as well, it
    replays a log the port wrote."""
    code = (
        "import sys\n" + _BLOCK + "sys.modules['scale_test'] = None\n"
        "from spark_rapids_tpu_torch.models.corpus import build_queries, "
        "corpus_tables\n"
        "from spark_rapids_tpu_torch.session import TorchSession\n"
        "from spark_rapids_tpu_torch.tools.warmup import run_warmup\n"
        f"d = {str(tmp_path)!r}\n"
        "s = TorchSession({'spark.rapids.sql.eventLog.enabled': 'true', "
        "'spark.rapids.sql.eventLog.dir': d}, device='cpu')\n"
        "s.next_query_tag = 'q6'\n"
        "build_queries(s, corpus_tables(0.005, 1))['q6']().collect_table()\n"
        "rep = run_warmup(d, sf=0.005, seed=1, device='cpu')\n"
        "assert rep['ok'] and rep['distinctUnits'] == 1, rep\n"
        "assert 'scale_test' not in [m for m in sys.modules "
        "if sys.modules[m] is not None]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


#: the static-analysis layer's modules: each must exist and import with
#: JAX, the JAX package, pyarrow and pandas blocked
LINT_MODULES = (
    "lint/__init__.py", "lint/__main__.py", "lint/diagnostics.py",
    "lint/plan_verifier.py", "lint/golden.py", "lint/registry_audit.py",
    "lint/concurrency.py",
    "lint/repo_lint.py", "lint/rules/__init__.py", "lint/rules/common.py",
    "lint/rules/conf_keys.py", "lint/rules/determinism.py",
    "lint/rules/fault_points.py", "lint/rules/io_write.py",
    "lint/rules/obs_passive.py", "lint/rules/streaming_epoch.py",
    "lint/rules/thread_shared.py", "lint/rules/device_residency.py")


@pytest.mark.parametrize("rel", LINT_MODULES)
def test_lint_module_is_the_ports_own(rel):
    test_io_module_is_the_ports_own(rel)


def test_the_lint_package_is_whole():
    """Every module of the port's lint/ is in the list above."""
    have = sorted(p.relative_to(PORT).as_posix()
                  for p in (PORT / "lint").rglob("*.py"))
    assert have == sorted(LINT_MODULES)

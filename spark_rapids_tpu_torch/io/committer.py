"""Transactional output committer (port of the WriteJob part of
``spark_rapids_tpu/io/committer.py``; reference: Spark's
HadoopMapReduceCommitProtocol under DataWritingCommandExec).

Task output stages under ``_temporary/<jobId>/<attempt>/`` mirroring the
final layout; task commit promotes each staged file into place with an
atomic rename (an overwritten file is moved aside first, so an abort can
restore it); job commit publishes the ``_SUCCESS`` marker as a JSON
MANIFEST (job id, committed files, row and byte totals), which makes a
re-run of the same job idempotent; abort rolls back every promoted file
and sweeps the staging tree, so a failed write never leaves a torn file a
scan would read. The ``write`` metric scope counts files, bytes, commits,
aborts and swept staging files.

Jobs still in flight when the process dies are aborted by
``sweep_active_jobs``: at exit, and on the crash handler's exit-20 path
(runtime/crash_handler.py). The vacuum protection
(:func:`vacuum_protection`) keeps what a writer in flight owns: a job's
staging tree and promoted files, and the data files a Delta transaction
staged before its log commit (:func:`protect_files`). The Delta
transaction's counters share the scope (``commitRetries``,
``commitConflicts``, ``vacuumedFiles``)."""

from __future__ import annotations

import atexit
import json
import os
import shutil
import time
import uuid
import weakref
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.lockorder import ordered_lock
from spark_rapids_tpu_torch.obs.metrics import metric_scope, register_metric
from spark_rapids_tpu_torch.runtime.faults import fault_point

#: staging root inside the destination directory; '_'-prefixed so the
#: scan listing (io/common.expand_paths) skips it
TEMP_DIR = "_temporary"
SUCCESS_MARKER = "_SUCCESS"

#: the ``write`` metric scope
WRITE_METRICS = metric_scope("write")
for _name, _kind, _doc in (
        ("filesWritten", "count", "data files committed into place by "
                                  "the transactional writer"),
        ("bytesWritten", "bytes", "bytes of committed data files"),
        ("jobsCommitted", "count", "write jobs that published their "
                                   "_SUCCESS manifest"),
        ("jobsAborted", "count", "write jobs rolled back (promoted files "
                                 "deleted, staging swept)"),
        ("stagingFilesSwept", "count", "staged files removed by a write "
                                       "job's abort and by failed Delta "
                                       "transactions (the write path's "
                                       "failure signal)"),
        ("vacuumedFiles", "count", "un-referenced files removed by vacuum"),
        ("commitRetries", "count", "Delta optimistic commits rebased and "
                                   "retried after losing the version race"),
        ("commitConflicts", "count", "Delta commit conflicts observed "
                                     "(retried blind appends plus typed "
                                     "metadata or overlap raises)"),
):
    register_metric(_name, _kind, "ESSENTIAL", _doc)
    WRITE_METRICS.setdefault(_name, 0)
del _name, _kind, _doc


#: the write jobs in flight in this process, by (destination, job id)
_ACTIVE_JOBS: Dict[Tuple[str, str], "WriteJob"] = {}
_ACTIVE_LOCK = ordered_lock("io.committer.jobs")

#: files other in-flight writers own, owner -> (base path, full paths): a
#: Delta transaction writes data files into the table directory before
#: its log commit lands, and vacuum must not sweep them from under it.
#: Weak keys: an abandoned transaction's protection expires with it.
_PROTECTED_OWNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def protect_files(owner, base_path: str, full_paths) -> None:
    """Shield ``full_paths`` (under ``base_path``) from vacuum for the
    owner's lifetime (or until :func:`unprotect_files`)."""
    with _ACTIVE_LOCK:
        _PROTECTED_OWNERS[owner] = (base_path, set(full_paths))


def unprotect_files(owner) -> None:
    with _ACTIVE_LOCK:
        _PROTECTED_OWNERS.pop(owner, None)


def sweep_active_jobs() -> int:
    """Abort every write job in flight: the crash handler's exit path
    (``os._exit`` skips the unwinding that would abort them). Each abort
    runs the full rollback. Returns the jobs swept."""
    with _ACTIVE_LOCK:
        jobs = list(_ACTIVE_JOBS.values())
    for job in jobs:
        try:
            job.abort()
        except Exception:
            pass  # an armed io.write.abort fault must not stop the sweep
    return len(jobs)


atexit.register(sweep_active_jobs)


class WriteJob:
    """One transactional write job over a destination directory.

    ``stage_path()`` per output file (the writer writes the staged path),
    ``commit_task()`` promotes every staged file with an atomic
    ``os.replace``, ``commit_job()`` publishes the ``_SUCCESS`` manifest
    and sweeps staging, ``abort()`` rolls the job back. A job is
    single-use; its id is the idempotency key a re-run checks."""

    def __init__(self, path: str, job_id: Optional[str] = None,
                 attempt: int = 0):
        self.path = path
        self.job_id = job_id or uuid.uuid4().hex[:16]
        self.attempt = attempt
        self.staging = os.path.join(path, TEMP_DIR, self.job_id,
                                    str(attempt))
        self._staged: List[Tuple[str, str]] = []   # (staged abs, rel)
        #: (final abs path, backup abs path or None) per promoted file
        self._promoted: List[Tuple[str, Optional[str]]] = []
        self._done = False
        os.makedirs(self.staging, exist_ok=True)
        with _ACTIVE_LOCK:
            _ACTIVE_JOBS[(self.path, self.job_id)] = self

    # -- task side -----------------------------------------------------------
    def stage_path(self, rel: str) -> str:
        """The staging location of one output file whose final path is
        ``rel`` (partition directories included); registers it for
        promotion at task commit."""
        staged = os.path.join(self.staging, rel)
        os.makedirs(os.path.dirname(staged), exist_ok=True)
        self._staged.append((staged, rel))
        return staged

    def commit_task(self) -> List[str]:
        """Promote every staged file into its destination, atomically per
        file: a reader listing the directory meanwhile sees each file
        absent or whole. A destination file that already exists is first
        moved aside into the staging tree, so abort() can restore it."""
        final = []
        for staged, rel in self._staged:
            dst = os.path.join(self.path, rel)
            d = os.path.dirname(dst)
            if d:
                os.makedirs(d, exist_ok=True)
            fault_point("io.write.commit")
            backup = None
            if os.path.exists(dst):
                backup = os.path.join(self.staging, ".backup", rel)
                os.makedirs(os.path.dirname(backup), exist_ok=True)
                os.replace(dst, backup)
            # recorded before the promoting rename: a failure between the
            # two renames must still restore the backup
            self._promoted.append((dst, backup))
            os.replace(staged, dst)
            final.append(dst)
        self._staged = []
        return final

    # -- job side ------------------------------------------------------------
    def commit_job(self, num_rows: int = 0) -> dict:
        """Publish the ``_SUCCESS`` manifest (atomically, through a staged
        temp file) listing every committed file, then sweep this job's
        staging tree. Returns the manifest."""
        if self._staged:
            self.commit_task()
        rels = sorted(os.path.relpath(p, self.path)
                      for p, _backup in self._promoted)
        num_bytes = sum(os.path.getsize(p)
                        for p, _backup in self._promoted)
        manifest = {
            "jobId": self.job_id,
            "attempt": self.attempt,
            "numFiles": len(rels),
            "numRows": int(num_rows),
            "numBytes": int(num_bytes),
            "files": rels,
            "committedAt": int(time.time() * 1000),
        }
        tmp = os.path.join(self.staging, SUCCESS_MARKER)
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.path, SUCCESS_MARKER))
        # routine cleanup (the .backup copies of overwritten files), not
        # a failure signal
        self._sweep_staging(record=False)
        self._finish()
        WRITE_METRICS.add("filesWritten", len(rels))
        WRITE_METRICS.add("bytesWritten", num_bytes)
        WRITE_METRICS.add("jobsCommitted", 1)
        return manifest

    def abort(self) -> None:
        """Roll the job back: every promoted file is removed and any file
        it overwrote is restored from its backup, then the staging tree is
        swept. Idempotent; the cleanup never raises (an abort runs inside
        exception handlers), though an armed ``io.write.abort`` fault
        surfaces after it."""
        if self._done:
            return
        try:
            fault_point("io.write.abort")
        finally:
            for dst, backup in reversed(self._promoted):
                try:
                    if backup is not None:
                        os.replace(backup, dst)  # restore the original
                    else:
                        os.unlink(dst)
                    WRITE_METRICS.add("stagingFilesSwept", 1)
                except OSError:
                    pass
            self._promoted = []
            self._sweep_staging()
            self._finish()
            WRITE_METRICS.add("jobsAborted", 1)

    # -- internals -----------------------------------------------------------
    def _finish(self) -> None:
        self._done = True
        with _ACTIVE_LOCK:
            _ACTIVE_JOBS.pop((self.path, self.job_id), None)

    def _sweep_staging(self, record: bool = True) -> None:
        job_root = os.path.join(self.path, TEMP_DIR, self.job_id)
        swept = 0
        for _root, _dirs, files in os.walk(job_root):
            swept += len(files)
        shutil.rmtree(job_root, ignore_errors=True)
        if swept and record:
            WRITE_METRICS.add("stagingFilesSwept", swept)
        # drop _temporary/ itself once the last job under it is gone
        try:
            os.rmdir(os.path.join(self.path, TEMP_DIR))
        except OSError:
            pass
        self._staged = []


def read_manifest(path: str) -> Optional[dict]:
    """The destination's ``_SUCCESS`` manifest, or None when absent or an
    empty marker."""
    p = os.path.join(path, SUCCESS_MARKER)
    try:
        with open(p) as f:
            m = json.load(f)
        return m if isinstance(m, dict) and "jobId" in m else None
    except (OSError, ValueError):
        return None


def vacuum_protection(path: str, retention_hours: float):
    """THE keep-predicate of both vacuums (tools/vacuum.py and
    delta/commands.vacuum_table): a file is kept when it belongs to a
    writer in flight in this process (a job's staging tree or promoted
    files, a Delta transaction's staged data files) or is younger than
    the retention window (unreadable mtimes count as young). Returns
    ``protected(full_path) -> bool``."""
    with _ACTIVE_LOCK:
        staging = [j.staging for j in _ACTIVE_JOBS.values()
                   if j.path == path]
        promoted = {p for j in _ACTIVE_JOBS.values() if j.path == path
                    for p, _backup in list(j._promoted)}
        promoted |= {p for bp, paths in _PROTECTED_OWNERS.values()
                     if bp == path for p in paths}
    cutoff = (time.time() - retention_hours * 3600.0
              if retention_hours > 0 else None)

    def protected(full: str) -> bool:
        if full in promoted or any(
                full.startswith(s + os.sep) for s in staging):
            return True
        if cutoff is not None:
            try:
                return os.path.getmtime(full) > cutoff
            except OSError:
                return True
        return False

    return protected


def unlink_and_prune(base: str, rels, keep_dirs=()) -> int:
    """Delete ``rels`` (relative to ``base``), then prune emptied
    directories bottom-up; a directory whose path holds a ``keep_dirs``
    name is never pruned. Returns the count deleted."""
    deleted = 0
    for rel in rels:
        try:
            os.unlink(os.path.join(base, rel))
            deleted += 1
        except OSError:
            pass
    for root, _dirs, _files in os.walk(base, topdown=False):
        if root == base or any(k in root.split(os.sep) for k in keep_dirs):
            continue
        try:
            os.rmdir(root)
        except OSError:
            pass
    return deleted


def find_staging_orphans(path: str) -> List[str]:
    """Every file under ``<path>/_temporary/``: staged output of jobs
    that died without an abort (vacuum removes these)."""
    root = os.path.join(path, TEMP_DIR)
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            out.append(os.path.join(dirpath, f))
    return out

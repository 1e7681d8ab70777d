"""``tools vacuum``: find and remove un-referenced or staged output files
(port of ``spark_rapids_tpu/tools/vacuum.py``).

Three directory shapes, auto-detected:

* **Delta table** (``_delta_log/`` present): orphans are files the
  latest snapshot does not reference — overwritten versions' data
  files, failed/conflicted transactions' staged writes, orphaned
  deletion vectors (delta/commands.vacuum_table; the retention window
  comes from ``spark.rapids.delta.vacuum.retentionHours``).
* **Committed write directory** (``_SUCCESS`` manifest from the
  transactional committer): orphans are files the manifest does not
  list — leftovers of older jobs into the same directory — plus
  anything under ``_temporary/`` (staging of jobs that died without
  abort).
* **Anything else**: only ``_temporary/`` staging trees are provably
  garbage; nothing else is touched.

DRY RUN is the default — the report lists what ``--delete`` would
remove. Removal never touches ``_delta_log/``, the manifest itself, or
change-data-feed files.
"""

from __future__ import annotations

import os
from typing import List, Optional


def _manifest_orphans(path: str, manifest: dict) -> List[str]:
    from spark_rapids_tpu_torch.io.committer import SUCCESS_MARKER, TEMP_DIR
    referenced = set(manifest.get("files", ()))
    orphans: List[str] = []
    for root, dirs, files in os.walk(path):
        # EVERYTHING under _temporary/ is an orphan candidate,
        # hidden names included (.backup/ trees of dead jobs); outside
        # it, other _/. dirs (foreign markers) are left alone
        in_temp = os.path.relpath(root, path).split(os.sep)[0] == TEMP_DIR
        if not in_temp:
            dirs[:] = [d for d in dirs
                       if not d.startswith(("_", ".")) or d == TEMP_DIR]
        for f in sorted(files):
            full = os.path.join(root, f)
            rel = os.path.relpath(full, path)
            if rel == SUCCESS_MARKER or rel in referenced:
                continue
            if f.startswith(("_", ".")) \
                    and not rel.startswith(TEMP_DIR + os.sep):
                continue
            orphans.append(rel)
    return orphans


def run_vacuum(path: str, delete: bool = False,
               retention_hours: Optional[float] = None) -> dict:
    """Returns the vacuum report dict; ``delete=False`` (the default)
    only reports. ``retention_hours`` (default: the
    ``spark.rapids.delta.vacuum.retentionHours`` conf) applies in
    EVERY mode — an orphan younger than the window may belong to a
    writer in another process that has not committed yet. Jobs in
    flight in THIS process are never touched regardless: neither
    their staging trees nor files they have promoted but not yet
    recorded in a manifest (committer.vacuum_protection)."""
    from spark_rapids_tpu_torch.conf import (
        DELTA_VACUUM_RETENTION_HOURS,
        RapidsConf,
    )
    from spark_rapids_tpu_torch.io.committer import (
        WRITE_METRICS,
        find_staging_orphans,
        read_manifest,
        unlink_and_prune,
        vacuum_protection,
    )
    if not os.path.isdir(path):
        raise SystemExit(f"tools vacuum: {path} is not a directory")
    if retention_hours is None:
        retention_hours = float(
            RapidsConf().get_entry(DELTA_VACUUM_RETENTION_HOURS))
    if os.path.isdir(os.path.join(path, "_delta_log")):
        from spark_rapids_tpu_torch.delta.commands import vacuum_table
        res = vacuum_table(path, dry_run=not delete,
                           retention_hours=retention_hours)
        return {"path": path, "mode": "delta",
                "orphans": res["orphans"],
                "deleted": res["files_deleted"],
                "dryRun": not delete,
                "retentionHours": res["retention_hours"]}

    manifest = read_manifest(path)
    if manifest is not None:
        orphans = _manifest_orphans(path, manifest)
        mode = "manifest"
    else:
        orphans = [os.path.relpath(p, path)
                   for p in find_staging_orphans(path)]
        mode = "staging-only"
    protected = vacuum_protection(path, retention_hours)
    orphans = [rel for rel in orphans
               if not protected(os.path.join(path, rel))]
    deleted = 0
    if delete:
        deleted = unlink_and_prune(path, orphans)
        if deleted:
            WRITE_METRICS.add("vacuumedFiles", deleted)
    return {"path": path, "mode": mode, "orphans": orphans,
            "deleted": deleted, "dryRun": not delete,
            "retentionHours": retention_hours}


def render_vacuum(report: dict) -> str:
    lines = [f"vacuum {report['path']} ({report['mode']})"
             + ("  [DRY RUN — pass --delete to remove]"
                if report["dryRun"] else "")]
    if not report["orphans"]:
        lines.append("  zero orphans — directory is clean")
    for rel in report["orphans"]:
        verb = "would remove" if report["dryRun"] else "removed"
        lines.append(f"  {verb}  {rel}")
    if not report["dryRun"]:
        lines.append(f"  {report['deleted']} file(s) removed")
    return "\n".join(lines)

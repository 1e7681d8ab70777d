"""Write-ahead offset log for streaming checkpoints (port of
``spark_rapids_tpu/streaming/offsets.py``).

Layout under a checkpoint directory (the structured-streaming analog):

* ``offsets/<batch_id>.json`` — written BEFORE a micro-batch runs; records
  the exact source range the batch will read.
* ``commits/<batch_id>.json`` — written only after the batch's sink commit
  lands.

Exactly-once resume falls out of the two-file protocol: an offsets file
without a matching commit file is a batch that died mid-flight, and the
restarted stream re-runs it over the SAME recorded range (sources read
deterministically from offsets). The sink side dedupes via the Delta
``txn`` watermark (delta/log.SetTransaction), so a batch that died AFTER
the sink commit but before the commit marker replays as a no-op.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from spark_rapids_tpu_torch.errors import ColumnarProcessingError

__all__ = ["OffsetLog"]


class OffsetLog:
    """Durable per-stream batch bookkeeping rooted at ``checkpoint_dir``."""

    def __init__(self, checkpoint_dir: str):
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.offsets_dir = os.path.join(self.checkpoint_dir, "offsets")
        self.commits_dir = os.path.join(self.checkpoint_dir, "commits")
        os.makedirs(self.offsets_dir, exist_ok=True)
        os.makedirs(self.commits_dir, exist_ok=True)

    # -- low level -----------------------------------------------------------
    @staticmethod
    def _ids(d: str):
        out = []
        for f in os.listdir(d):
            if f.endswith(".json"):
                try:
                    out.append(int(f[:-5]))
                except ValueError:
                    continue
        return sorted(out)

    def _write_json(self, d: str, batch_id: int, payload: dict) -> None:
        # tmp + rename so a crash mid-write never leaves a torn entry the
        # resume path would misread as a planned batch
        final = os.path.join(d, f"{batch_id}.json")
        tmp = final + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(tmp, final)

    def _read_json(self, d: str, batch_id: int) -> dict:
        with open(os.path.join(d, f"{batch_id}.json")) as f:
            return json.load(f)

    # -- offsets -------------------------------------------------------------
    def latest_batch_id(self) -> int:
        """Highest batch id with a planned-offsets entry; -1 if none."""
        ids = self._ids(self.offsets_dir)
        return ids[-1] if ids else -1

    def latest_committed_id(self) -> int:
        ids = self._ids(self.commits_dir)
        return ids[-1] if ids else -1

    def write_offsets(self, batch_id: int, offsets: dict) -> None:
        if batch_id != self.latest_batch_id() + 1:
            raise ColumnarProcessingError(
                f"offset log gap: planning batch {batch_id} but latest "
                f"planned is {self.latest_batch_id()}")
        self._write_json(self.offsets_dir, batch_id, offsets)

    def read_offsets(self, batch_id: int) -> dict:
        return self._read_json(self.offsets_dir, batch_id)

    def write_commit(self, batch_id: int, info: dict) -> None:
        self._write_json(self.commits_dir, batch_id, info)

    def pending_batch(self) -> Optional[Tuple[int, dict]]:
        """The planned-but-uncommitted batch to re-run on resume, if any.
        At most ONE can exist: offsets are written strictly one batch
        ahead of commits."""
        planned, committed = self.latest_batch_id(), self.latest_committed_id()
        if planned > committed:
            return planned, self.read_offsets(planned)
        return None

    def last_end_offset(self):
        """End offset of the newest planned batch (the next batch's start),
        or None if the stream has never planned a batch."""
        planned = self.latest_batch_id()
        if planned < 0:
            return None
        return self.read_offsets(planned).get("end")

"""FileCache: decoded-batch cache for file scans (port of
``spark_rapids_tpu/io/filecache.py``).

The reference's FileCache subsystem (filecache/FileCache.scala) caches
remote file data on local disk so repeated scans skip the slow fetch. Here
the slow layer is the host DECODE, so the cache holds decoded HostTables
keyed by (path, mtime, scan options), LRU-bounded by
``spark.rapids.filecache.maxBytes``. Off by default
(``spark.rapids.filecache.enabled``), as the reference's."""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.lockorder import ordered_lock


class _FileCache:
    def __init__(self):
        self._lock = ordered_lock("io.filecache")
        self._entries: "OrderedDict[tuple, HostTable]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get_or_decode(self, path: str, options_key: tuple,
                      decode: Callable[[], HostTable],
                      max_bytes: int) -> HostTable:
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return decode()
        key = (os.path.abspath(path), mtime, options_key)
        with self._lock:
            got = self._entries.get(key)
            if got is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return got
            self.misses += 1
        table = decode()
        size = table.nbytes()
        if size > max_bytes:
            return table  # too big to cache
        with self._lock:
            if key not in self._entries:  # a concurrent decode of one key
                self._entries[key] = table
                self._bytes += size
            while self._bytes > max_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes()
        return table

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0


FILE_CACHE = _FileCache()

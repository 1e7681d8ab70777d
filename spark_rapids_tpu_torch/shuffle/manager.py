"""MULTITHREADED shuffle manager over local files (port of
``spark_rapids_tpu/shuffle/manager.py``; spark-rapids'
``RapidsShuffleThreadedWriterBase``/``ReaderBase``).

Spark's sort-shuffle layout: per map output ONE data file of concatenated
per-partition segments plus an index of offsets. A thread pool serializes
(TPAK, shuffle/serializer.py) and compresses on the writer side, reads and
decompresses on the reader side; the threads touch host memory only, the
reduce partition's upload runs on the exchange's own thread and stream
(execs/exchange.py). Codecs: none, zlib, and LZ4 and ZSTD through the
port's own host library (native/lz4_host.cpp, native/zstd_host.cpp). The
reference falls back to zlib where its ``zstandard`` module is missing;
the port always has ZSTD and records ``zstd``. The frames are the
reference's: an LZ4 blob is the 8-byte little-endian raw size and one raw
LZ4 block, a ZSTD blob one frame with its content size, so either package
decodes the other's.

A shuffle is N map outputs (one per input batch) by P reduce partitions.
The reader reads a reduce partition's segments from every map output in
parallel and yields them in map order."""

from __future__ import annotations

import concurrent.futures as cf
import os
import tempfile
import threading
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import (
    RapidsConf,
    SHUFFLE_COMPRESSION_CODEC,
    SHUFFLE_FETCH_BACKOFF_MULT,
    SHUFFLE_FETCH_MAX_RETRIES,
    SHUFFLE_FETCH_RETRY_WAIT_MS,
    SHUFFLE_MT_READER_THREADS,
    SHUFFLE_MT_WRITER_THREADS,
)
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    CorruptFrameError,
    MapOutputLostError,
    ShuffleFetchError,
)
from spark_rapids_tpu_torch.runtime.faults import backoff_retry, fault_point
from spark_rapids_tpu_torch.shuffle.serializer import pack_table, unpack_table


#: the codecs a shuffle may record
CODECS = ("none", "zlib", "lz4", "zstd")


def resolve_codec(requested: str) -> str:
    """The codec that runs for a requested one, as it is recorded and
    used for decoding. Every codec runs in the port (LZ4 and ZSTD through
    its host library), so the request is the answer; an unknown one
    raises."""
    if requested in CODECS:
        return requested
    raise ColumnarProcessingError(f"unknown shuffle codec {requested}")


def _compress(codec: str, data: bytes) -> bytes:
    if codec == "none":
        return data
    if codec == "zlib":
        return zlib.compress(data, level=1)
    from spark_rapids_tpu_torch import native
    if codec == "lz4":
        # a raw LZ4 block does not carry its size: frame it
        return len(data).to_bytes(8, "little") + native.lz4_compress(data)
    if codec == "zstd":
        return native.zstd_compress(data)
    raise ColumnarProcessingError(f"unresolved shuffle codec {codec}")


def _decompress(codec: str, data) -> bytes:
    if codec == "none":
        return data
    if codec == "zlib":
        return zlib.decompress(data)
    from spark_rapids_tpu_torch import native
    if codec == "lz4":
        if len(data) < 8:
            raise ValueError("LZ4 shuffle blob shorter than its size word")
        size = int.from_bytes(bytes(data[:8]), "little")
        out = native.lz4_decompress(memoryview(data)[8:], size)
        if len(out) != size:
            raise ValueError(f"LZ4 blob decoded {len(out)} of {size} bytes")
        return out
    if codec == "zstd":
        return native.zstd_decompress(data)
    raise ColumnarProcessingError(f"unresolved shuffle codec {codec}")


#: the exception types a codec raises on CORRUPT input (the host library
#: raises ColumnarProcessingError); a programming error (TypeError,
#: AttributeError) surfaces instead of passing for corruption
_CODEC_ERRORS = (zlib.error, ValueError, ColumnarProcessingError)


def encode_blob(codec: str, table: HostTable):
    """(blob, pack seconds, codec seconds) of one table: its TPAK frame
    compressed by ``codec``."""
    import time
    t0 = time.perf_counter()
    raw = pack_table(table)
    t1 = time.perf_counter()
    blob = _compress(codec, raw)
    return blob, t1 - t0, time.perf_counter() - t1


def decode_blob(codec: str, blob) -> HostTable:
    """Decompress and unpack one shuffle blob. Every corruption signal
    becomes the retryable CorruptFrameError: under compression the codec's
    error is the only one (the TPAK CRC sits inside)."""
    try:
        raw = _decompress(codec, blob)
    except _CODEC_ERRORS as e:
        raise CorruptFrameError(
            f"corrupt compressed shuffle blob (codec {codec}): {e}") from e
    table, _ = unpack_table(raw)  # CRC-checked; raises CorruptFrameError
    return table


@dataclass
class MapOutput:
    data_path: str
    #: offsets[p] .. offsets[p+1] = partition p's byte range
    offsets: List[int] = field(default_factory=list)


class ShuffleWriteHandle:
    """Writer for one shuffle: each written batch becomes one map output."""

    def __init__(self, shuffle_id: int, num_partitions: int, workdir: str,
                 codec: str, pool: cf.ThreadPoolExecutor):
        self.shuffle_id = shuffle_id
        self.num_partitions = num_partitions
        self.workdir = workdir
        self.codec = codec
        self.pool = pool
        self.map_outputs: List[MapOutput] = []
        self.bytes_written = 0

    def write_partitions(self, partitions: List[HostTable]) -> MapOutput:
        """Serialize per-partition tables (in parallel) and append one map
        output file (data + in-memory index). Serialized bytes are held
        under a host-memory grant until flushed (HostAlloc integration)."""
        if len(partitions) != self.num_partitions:
            raise ColumnarProcessingError("partition count mismatch")
        import time

        from spark_rapids_tpu_torch.obs.metrics import metric_scope
        from spark_rapids_tpu_torch.obs.spans import span
        from spark_rapids_tpu_torch.runtime.host_alloc import HostMemoryArbiter
        codec = self.codec
        grant = HostMemoryArbiter.get().alloc(
            sum(t.nbytes() for t in partitions))
        try:
            t0 = time.perf_counter()
            with span("shuffle.serialize", cat="shuffle"):
                done = list(self.pool.map(
                    lambda t: encode_blob(codec, t), partitions))
            blobs = [b for b, _, _ in done]
            # recorded from the calling thread (worker adds would race)
            scope = metric_scope("shuffle")
            scope.add("serializeTime", time.perf_counter() - t0)
            scope.add("packThreadTime", sum(x for _, x, _ in done))
            scope.add("codecThreadTime", sum(x for _, _, x in done))
        except BaseException:
            grant.release()
            raise
        try:
            map_id = len(self.map_outputs)
            with span("shuffle.write.map", cat="shuffle", map=map_id):
                out = self._write_map_file(map_id, blobs)
            self.map_outputs.append(out)
            self.bytes_written += out.offsets[-1]
            metric_scope("shuffle").add("shuffleBytesWritten",
                                        out.offsets[-1])
            return out
        finally:
            grant.release()

    def _write_map_file(self, map_id: int, blobs, revision: int = 0
                        ) -> MapOutput:
        fault_point("shuffle.write.map")
        suffix = f"_r{revision}" if revision else ""
        path = os.path.join(
            self.workdir,
            f"shuffle_{self.shuffle_id}_{map_id}{suffix}.data")
        offsets = [0]
        with open(path, "wb") as f:
            for b in blobs:
                f.write(b)
                offsets.append(offsets[-1] + len(b))
        return MapOutput(path, offsets)

    def rewrite_map(self, map_id: int, partitions: List[HostTable]
                    ) -> MapOutput:
        """Recompute path: replace one LOST/CORRUPT map output with a
        freshly serialized copy (written to a new revisioned file so
        readers never see a half-rewritten file)."""
        if not 0 <= map_id < len(self.map_outputs):
            raise ColumnarProcessingError(
                f"cannot rewrite unknown map output {map_id}")
        if len(partitions) != self.num_partitions:
            raise ColumnarProcessingError("partition count mismatch")
        # same host-memory grant as write_partitions: recovery runs when
        # the system is already degraded, so it must not overcommit the
        # arbiter's budget either
        from spark_rapids_tpu_torch.runtime.host_alloc import HostMemoryArbiter
        codec = self.codec
        grant = HostMemoryArbiter.get().alloc(
            sum(t.nbytes() for t in partitions))
        try:
            blobs = [b for b, _, _ in self.pool.map(
                lambda t: encode_blob(codec, t), partitions)]
            old = self.map_outputs[map_id]
            revision = 1
            if "_r" in os.path.basename(old.data_path):
                revision = 1 + int(
                    os.path.basename(old.data_path).rsplit("_r", 1)[1]
                    .split(".")[0])
            out = self._write_map_file(map_id, blobs, revision)
        finally:
            grant.release()
        self.map_outputs[map_id] = out
        try:
            os.unlink(old.data_path)
        except OSError:
            pass
        return out


class ShuffleReadHandle:
    def __init__(self, handle: ShuffleWriteHandle, codec: str,
                 pool: cf.ThreadPoolExecutor,
                 max_retries: int = 3, retry_wait_s: float = 0.05,
                 backoff_mult: float = 2.0):
        self.write_handle = handle
        self.codec = codec
        self.pool = pool
        self.bytes_read = 0
        self.max_retries = max_retries
        self.retry_wait_s = retry_wait_s
        self.backoff_mult = backoff_mult
        self.retry_count = 0

    def _fetch_segment(self, mo: MapOutput, p: int):
        fault_point("shuffle.read.partition")
        start, end = mo.offsets[p], mo.offsets[p + 1]
        if end <= start:
            return None, 0
        size = end - start
        with open(mo.data_path, "rb") as f:
            f.seek(start)
            blob = f.read(size)
        # decode_blob turns codec errors and CRC mismatches into the
        # retryable CorruptFrameError
        return decode_blob(self.codec, blob), size

    def read_partition(self, p: int) -> Iterator[HostTable]:
        """All map outputs' segments for reduce partition p, deserialized in
        parallel, yielded in map order. A retryable failure (corrupt
        frame, torn read, injected fault) replays that map's read with
        exponential backoff; exhaustion raises MapOutputLostError naming
        the map so the exchange recomputes it from lineage."""

        def fetch(args):
            map_id, mo = args

            def note(_exc, _attempt):
                self.retry_count += 1

            try:
                return backoff_retry(
                    lambda: self._fetch_segment(mo, p),
                    max_retries=self.max_retries,
                    wait_s=self.retry_wait_s,
                    backoff_mult=self.backoff_mult,
                    retryable=(ShuffleFetchError, OSError),
                    on_failure=note)
            except (ShuffleFetchError, OSError) as e:
                raise MapOutputLostError(
                    f"map output {map_id} of shuffle "
                    f"{self.write_handle.shuffle_id} unreadable after "
                    f"retries: {e}", map_ids=[map_id]) from e

        from spark_rapids_tpu_torch.obs.metrics import metric_scope
        from spark_rapids_tpu_torch.obs.spans import span
        # materialize INSIDE the span (a span held open across yields
        # would absorb downstream consumer time and leak on
        # abandonment); the only caller buffers the partition anyway —
        # it is the recovery unit
        with span("shuffle.read.partition", cat="shuffle", partition=p):
            results = list(self.pool.map(
                fetch, enumerate(self.write_handle.map_outputs)))
        for t, nbytes in results:
            self.bytes_read += nbytes  # consumer thread only: no races
            if nbytes:
                metric_scope("shuffle").add("shuffleBytesRead", nbytes)
            if t is not None and t.num_rows > 0:
                yield t


class ShuffleManager:
    """Process-wide registry of shuffles (GpuShuffleEnv analog)."""

    def __init__(self, conf: RapidsConf):
        self.conf = conf
        self._lock = threading.Lock()
        self._next_id = 0
        self._shuffles: Dict[int, ShuffleWriteHandle] = {}
        self.workdir = tempfile.mkdtemp(prefix="rapids_tpu_shuffle_")
        self.codec = resolve_codec(
            str(conf.get_entry(SHUFFLE_COMPRESSION_CODEC)).lower())
        self._writer_pool = cf.ThreadPoolExecutor(
            max_workers=max(1, conf.get_entry(SHUFFLE_MT_WRITER_THREADS)),
            thread_name_prefix="shuffle-writer")
        self._reader_pool = cf.ThreadPoolExecutor(
            max_workers=max(1, conf.get_entry(SHUFFLE_MT_READER_THREADS)),
            thread_name_prefix="shuffle-reader")

    def new_shuffle(self, num_partitions: int) -> ShuffleWriteHandle:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            h = ShuffleWriteHandle(sid, num_partitions, self.workdir,
                                   self.codec, self._writer_pool)
            self._shuffles[sid] = h
            return h

    def reader(self, handle: ShuffleWriteHandle) -> ShuffleReadHandle:
        return ShuffleReadHandle(
            handle, self.codec, self._reader_pool,
            max_retries=int(self.conf.get_entry(SHUFFLE_FETCH_MAX_RETRIES)),
            retry_wait_s=self.conf.get_entry(
                SHUFFLE_FETCH_RETRY_WAIT_MS) / 1000.0,
            backoff_mult=float(self.conf.get_entry(
                SHUFFLE_FETCH_BACKOFF_MULT)))

    def remove_shuffle(self, handle: ShuffleWriteHandle):
        with self._lock:
            self._shuffles.pop(handle.shuffle_id, None)
        for mo in handle.map_outputs:
            try:
                os.unlink(mo.data_path)
            except OSError:
                pass


_MANAGERS: Dict[tuple, ShuffleManager] = {}
_MANAGER_LOCK = threading.Lock()


def get_shuffle_manager(conf: RapidsConf) -> ShuffleManager:
    """One manager per distinct (codec, thread pools) configuration, so a
    session's shuffle settings always take effect."""
    key = (str(conf.get_entry(SHUFFLE_COMPRESSION_CODEC)).lower(),
           conf.get_entry(SHUFFLE_MT_WRITER_THREADS),
           conf.get_entry(SHUFFLE_MT_READER_THREADS),
           conf.get_entry(SHUFFLE_FETCH_MAX_RETRIES),
           conf.get_entry(SHUFFLE_FETCH_RETRY_WAIT_MS),
           conf.get_entry(SHUFFLE_FETCH_BACKOFF_MULT))
    with _MANAGER_LOCK:
        mgr = _MANAGERS.get(key)
        if mgr is None:
            mgr = ShuffleManager(conf)
            _MANAGERS[key] = mgr
        return mgr

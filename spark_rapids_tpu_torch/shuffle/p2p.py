"""P2P shuffle mode (port of ``spark_rapids_tpu/shuffle/p2p.py``;
spark-rapids' UCX mode with ``RapidsCachingWriter``).

The writer keeps each map output resident in the spillable
ShuffleBufferCatalog instead of writing shuffle files; readers fetch the
blocks from every executor that holds them through the client/server
protocol over the transport (in-process, or TCP over loopback or a
network), the peers found through driver heartbeats. One
``P2PShuffleEnv`` per executor wires catalog, server, transport and
heartbeat endpoint. Within one process the fetch still runs the whole
protocol over the chosen transport, so the wire path runs in use, not
only in tests; several executors (tests/test_torch_shuffle_modes.py runs
2 and 3) connect the same pieces over TCP."""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.columnar import HostTable
from spark_rapids_tpu_torch.conf import (
    RapidsConf,
    SHUFFLE_BOUNCE_ACQUIRE_TIMEOUT_MS,
    SHUFFLE_COMPRESSION_CODEC,
    SHUFFLE_CONNECT_TIMEOUT_MS,
    SHUFFLE_FETCH_BACKOFF_MULT,
    SHUFFLE_FETCH_MAX_RETRIES,
    SHUFFLE_FETCH_RETRY_WAIT_MS,
    P2P_BOUNCE_BUFFER_SIZE,
    P2P_BOUNCE_BUFFERS,
    P2P_CACHE_LIMIT,
    P2P_TRANSPORT,
)
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    MapOutputLostError,
    ShuffleFetchError,
)
from spark_rapids_tpu_torch.runtime.faults import RECOVERY, backoff_retry
from spark_rapids_tpu_torch.shuffle.catalogs import (
    ShuffleBufferCatalog,
    ShuffleReceivedBufferCatalog,
)
from spark_rapids_tpu_torch.shuffle.client_server import ShuffleClient, ShuffleServer
from spark_rapids_tpu_torch.shuffle.heartbeat import (
    ShuffleHeartbeatEndpoint,
    ShuffleHeartbeatManager,
)
from spark_rapids_tpu_torch.shuffle.manager import (
    _compress,
    decode_blob,
    resolve_codec,
)
from spark_rapids_tpu_torch.shuffle.serializer import pack_table
from spark_rapids_tpu_torch.shuffle.transport import (
    BounceBufferManager,
    Connection,
    InProcessTransport,
    PeerInfo,
    TcpShuffleServerListener,
    TcpTransport,
)


class P2PShuffleEnv:
    """Executor-side wiring of the p2p shuffle (GpuShuffleEnv analog for
    UCX mode). ``driver`` is the shared heartbeat manager; standalone use
    (single executor) creates a private one."""

    def __init__(self, conf: RapidsConf, executor_id: str = "exec-0",
                 driver: Optional[ShuffleHeartbeatManager] = None):
        self.executor_id = executor_id
        self.codec = resolve_codec(
            str(conf.get_entry(SHUFFLE_COMPRESSION_CODEC)).lower())
        bounce_size = int(conf.get_entry(P2P_BOUNCE_BUFFER_SIZE))
        bounce_n = int(conf.get_entry(P2P_BOUNCE_BUFFERS))
        acquire_timeout = conf.get_entry(
            SHUFFLE_BOUNCE_ACQUIRE_TIMEOUT_MS) / 1000.0
        self.catalog = ShuffleBufferCatalog(
            host_limit_bytes=int(conf.get_entry(P2P_CACHE_LIMIT)))
        self.send_pool = BounceBufferManager(
            bounce_size, bounce_n, default_timeout=acquire_timeout)
        self.recv_pool = BounceBufferManager(
            bounce_size, bounce_n, default_timeout=acquire_timeout)
        self.server = ShuffleServer(self.catalog, self.send_pool)
        self.window_size = bounce_size
        # fetch-retry policy (spark.rapids.shuffle.fetch.*)
        self.fetch_max_retries = int(conf.get_entry(
            SHUFFLE_FETCH_MAX_RETRIES))
        self.fetch_retry_wait_s = conf.get_entry(
            SHUFFLE_FETCH_RETRY_WAIT_MS) / 1000.0
        self.fetch_backoff_mult = float(conf.get_entry(
            SHUFFLE_FETCH_BACKOFF_MULT))

        kind = str(conf.get_entry(P2P_TRANSPORT)).lower()
        self._listener: Optional[TcpShuffleServerListener] = None
        if kind == "tcp":
            self._listener = TcpShuffleServerListener(self.server)
            self.transport = TcpTransport(
                self.recv_pool,
                connect_timeout=conf.get_entry(
                    SHUFFLE_CONNECT_TIMEOUT_MS) / 1000.0)
            self.me = PeerInfo(executor_id, self._listener.host,
                               self._listener.port)
        elif kind == "inprocess":
            InProcessTransport.register_server(executor_id, self.server)
            self.transport = InProcessTransport(self.recv_pool)
            self.me = PeerInfo(executor_id)
        else:
            raise ColumnarProcessingError(f"unknown p2p transport {kind}")

        self._peers: Dict[str, PeerInfo] = {}
        self._connections: Dict[str, Connection] = {}
        self._conn_lock = threading.Lock()
        self._shuffle_id_lock = threading.Lock()
        self._next_shuffle = 0
        # per-peer CUMULATIVE fetch-failure counts (session lifetime, not
        # per fetch): a peer is excluded from fetch targets when one
        # fetch exhausts its retries OR when its total failures cross the
        # chronic-flakiness budget (4x maxRetries) even though each fetch
        # eventually limped through — recompute beats endless backoff.
        # Cleared only by an actual re-registration (_on_new_peer).
        self._peer_failures: Dict[str, int] = {}
        self._excluded_peers: Set[str] = set()
        from spark_rapids_tpu_torch.conf import HEARTBEAT_INTERVAL_S
        self.driver = driver or ShuffleHeartbeatManager()
        self.heartbeat = ShuffleHeartbeatEndpoint(
            self.driver, self.me, self._on_new_peer,
            interval_s=float(conf.get_entry(HEARTBEAT_INTERVAL_S)),
            on_evicted=self._rejoin_after_eviction)
        self.heartbeat.start()

    def _on_new_peer(self, peer: PeerInfo):
        """Normal heartbeat delivery: entries registered SINCE the last
        beat. For an excluded peer, seeing it here means it actually
        RE-registered with the driver — trust it again."""
        self._peers[peer.executor_id] = peer
        self._excluded_peers.discard(peer.executor_id)
        self._peer_failures.pop(peer.executor_id, None)

    def _rejoin_after_eviction(self):
        """OUR eviction, not theirs: re-register and re-DISCOVER the live
        peers, but keep our exclusion list — the driver's reply names
        every live peer, not peers that re-registered, so it proves
        nothing about a peer we excluded for failing fetches."""
        for peer in self.driver.register_executor(self.me):
            self._peers[peer.executor_id] = peer

    def on_peer_evicted(self, executor_id: str):
        """Driver-eviction hook: stop targeting the peer immediately; the
        next read that misses its blocks recomputes them from lineage."""
        if executor_id in self._excluded_peers:
            return
        self._excluded_peers.add(executor_id)
        RECOVERY.bump("peer_exclusions")

    def exclude_peer(self, executor_id: str):
        self.on_peer_evicted(executor_id)

    def connection_to(self, executor_id: str) -> Connection:
        with self._conn_lock:
            conn = self._connections.get(executor_id)
            if conn is not None and getattr(conn, "broken", False):
                # dead/desynced socket: evict so this fetch
                # reconnects instead of failing forever
                self._connections.pop(executor_id, None)
                conn = None
        if conn is not None:
            return conn
        peer = self.me if executor_id == self.executor_id \
            else self._peers.get(executor_id)
        if peer is None:
            raise ColumnarProcessingError(
                f"unknown peer {executor_id} (not heartbeat-discovered)")
        # connect OUTSIDE the lock: a slow/unreachable peer must not stall
        # connections to healthy ones (TCP connect can block for seconds)
        conn = self.transport.connect(peer)
        with self._conn_lock:
            existing = self._connections.get(executor_id)
            if existing is not None and getattr(existing, "broken", False):
                existing.close()
                existing = None
            if existing is None:
                self._connections[executor_id] = conn
                return conn
        # lost the race to a healthy connection: use it, free ours
        conn.close()
        return existing

    def client_for(self, executor_id: str) -> ShuffleClient:
        return ShuffleClient(self.connection_to(executor_id),
                             window_size=self.window_size)

    def peers(self) -> List[str]:
        return [ex for ex in self._peers if ex not in self._excluded_peers]

    def fetch_partition_with_retry(self, shuffle_id: int, partition_id: int,
                                   executor_id: str
                                   ) -> List[Tuple[tuple, int, HostTable]]:
        """One peer's blocks for a reduce partition, through the full
        client/server protocol, with exponential-backoff retry; returns
        (block_id, wire_bytes, table) triples. Deserialization runs INSIDE
        the retry so a corrupt frame (CRC mismatch) refetches. Exhaustion
        excludes the peer and raises MapOutputLostError naming the maps we
        know it held (the RapidsShuffleIterator retry + transport-error
        handling analog)."""
        local = executor_id == self.executor_id
        if not local and executor_id in self._excluded_peers:
            raise MapOutputLostError(
                f"peer {executor_id} is excluded (evicted or repeatedly "
                "failing)", executor_id=executor_id)
        state = {"known_maps": None, "chronic": False, "attempts": 0}

        def attempt():
            client = self.client_for(executor_id)
            blocks = client.fetch_metadata(shuffle_id, partition_id)
            if not blocks:
                return []
            state["known_maps"] = [bid[1] for bid, _ in blocks]
            received = ShuffleReceivedBufferCatalog()
            client.fetch_blocks(blocks, received)
            # decode inside the retry: a corrupt frame (CRC mismatch or
            # codec error — decode_blob normalizes both to the retryable
            # kind) refetches like any other failure
            return [(bid, len(blob), decode_blob(self.codec, blob))
                    for bid, blob in received.drain()]

        def on_failure(_exc, attempt_no):
            state["attempts"] = attempt_no
            total = self._peer_failures.get(executor_id, 0) + 1
            self._peer_failures[executor_id] = total
            state["chronic"] = (not local
                                and total > 4 * self.fetch_max_retries)
            return state["chronic"]  # budget blown: stop retrying now

        try:
            return backoff_retry(
                attempt, max_retries=self.fetch_max_retries,
                wait_s=self.fetch_retry_wait_s,
                backoff_mult=self.fetch_backoff_mult,
                retryable=ShuffleFetchError, on_failure=on_failure)
        except ShuffleFetchError as e:
            # the LOCAL executor is never excluded — after a recompute
            # rewrites its blocks, fetches must be able to target it again
            if not local:
                self.exclude_peer(executor_id)
            why = (f"{self._peer_failures.get(executor_id)} cumulative "
                   "failures (chronically flaky)" if state["chronic"]
                   else f"{state['attempts']} attempts")
            raise MapOutputLostError(
                f"fetch of shuffle {shuffle_id} partition {partition_id} "
                f"from {executor_id} failed after {why}: {e}",
                executor_id=executor_id,
                map_ids=state["known_maps"]) from e

    # -- engine ShuffleManager interface ------------------------------------
    def new_shuffle(self, num_partitions: int) -> "P2PWriteHandle":
        with self._shuffle_id_lock:
            sid = self._next_shuffle
            self._next_shuffle = sid + 1
        return P2PWriteHandle(self, sid, num_partitions)

    def reader(self, handle: "P2PWriteHandle") -> "P2PReadHandle":
        return P2PReadHandle(self, handle)

    def remove_shuffle(self, handle: "P2PWriteHandle"):
        self.catalog.remove_shuffle(handle.shuffle_id)

    def close(self):
        self.heartbeat.close()
        if self._listener is not None:
            self._listener.close()
        else:
            InProcessTransport.unregister_server(self.executor_id)


class P2PWriteHandle:
    """Caching writer: each batch's partition split lands in the local
    spillable catalog as one block per (map, partition)."""

    def __init__(self, env: P2PShuffleEnv, shuffle_id: int,
                 num_partitions: int):
        self.env = env
        self.shuffle_id = shuffle_id
        self.num_partitions = num_partitions
        self.num_maps = 0
        self.bytes_written = 0
        # map-output tracker slice: which (map, partition) blocks exist
        # (empty partitions write no block, so absence alone cannot
        # distinguish "empty" from "lost")
        self._written: Dict[int, Set[int]] = {}

    def write_partitions(self, partitions: List[HostTable]):
        """Idempotent under retry: all blobs are serialized
        BEFORE the map id is claimed or any block lands in the catalog, so
        a retryable failure mid-serialization leaves no partial map output
        and the replay starts clean (no duplicated partitions)."""
        if len(partitions) != self.num_partitions:
            raise ColumnarProcessingError("partition count mismatch")
        staged = []
        for p, table in enumerate(partitions):
            if table.num_rows == 0:
                continue
            staged.append((p, _compress(self.env.codec, pack_table(table))))
        map_id = self.num_maps
        added = []
        try:
            for p, blob in staged:
                bid = (self.shuffle_id, map_id, p)
                self.env.catalog.add_block(bid, blob)
                added.append(bid)
                self.bytes_written += len(blob)
        except BaseException:
            # leave no partial map output behind: a replay re-adds the
            # same (map, partition) block ids and must start clean
            for bid in added:
                self.env.catalog.remove_block(bid)
            self.bytes_written -= sum(len(b) for _, b in staged[:len(added)])
            raise
        self._written[map_id] = {p for p, _ in staged}
        self.num_maps += 1

    def rewrite_map(self, map_id: int, partitions: List[HostTable]):
        """Recompute path: replace one lost map output's blocks with
        freshly serialized copies in the LOCAL catalog (whether the
        originals lived here or on an evicted peer)."""
        if not 0 <= map_id < self.num_maps:
            raise ColumnarProcessingError(
                f"cannot rewrite unknown map output {map_id}")
        if len(partitions) != self.num_partitions:
            raise ColumnarProcessingError("partition count mismatch")
        for p in range(self.num_partitions):
            self.env.catalog.remove_block((self.shuffle_id, map_id, p))
        written = set()
        for p, table in enumerate(partitions):
            if table.num_rows == 0:
                continue
            blob = _compress(self.env.codec, pack_table(table))
            self.env.catalog.add_block((self.shuffle_id, map_id, p), blob)
            written.add(p)
        self._written[map_id] = written

    def expected_maps(self, partition_id: int) -> Set[int]:
        """Map ids that WROTE a block for this reduce partition — the
        completeness contract the reader verifies (a lost peer must not
        silently drop rows)."""
        return {m for m, parts in self._written.items()
                if partition_id in parts}

    @property
    def map_outputs(self):  # parity with ShuffleWriteHandle for metrics
        return list(range(self.num_maps))


class P2PReadHandle:
    """Reader: fetches a reduce partition through the full client/server
    protocol from every executor that holds blocks for it."""

    def __init__(self, env: P2PShuffleEnv, handle: P2PWriteHandle):
        self.env = env
        self.handle = handle
        self.bytes_read = 0

    def read_partition(self, p: int) -> Iterator[HostTable]:
        """Fetch a reduce partition from every live source with
        per-source retry, then verify COMPLETENESS against the write
        handle's map-output tracker: any locally-written map whose block
        did not arrive is reported lost (the exchange recomputes it) —
        a dead peer must fail loudly, never silently drop rows."""
        sources = [self.env.executor_id] + [
            ex for ex in self.env.peers() if ex != self.env.executor_id]
        got_maps = set()
        for executor_id in sources:
            for bid, nbytes, table in self.env.fetch_partition_with_retry(
                    self.handle.shuffle_id, p, executor_id):
                self.bytes_read += nbytes
                got_maps.add(bid[1])
                if table.num_rows > 0:
                    yield table
        missing = self.handle.expected_maps(p) - got_maps
        if missing:
            raise MapOutputLostError(
                f"shuffle {self.handle.shuffle_id} partition {p}: map "
                f"outputs {sorted(missing)} missing from every live "
                "source", map_ids=missing)


_P2P_ENVS: Dict[tuple, P2PShuffleEnv] = {}
_P2P_LOCK = threading.Lock()


def get_p2p_env(conf: RapidsConf) -> P2PShuffleEnv:
    key = (str(conf.get_entry(SHUFFLE_COMPRESSION_CODEC)).lower(),
           str(conf.get_entry(P2P_TRANSPORT)).lower(),
           int(conf.get_entry(P2P_BOUNCE_BUFFER_SIZE)),
           int(conf.get_entry(P2P_BOUNCE_BUFFERS)),
           int(conf.get_entry(P2P_CACHE_LIMIT)),
           int(conf.get_entry(SHUFFLE_FETCH_MAX_RETRIES)),
           conf.get_entry(SHUFFLE_FETCH_RETRY_WAIT_MS),
           float(conf.get_entry(SHUFFLE_FETCH_BACKOFF_MULT)))
    with _P2P_LOCK:
        env = _P2P_ENVS.get(key)
        if env is None:
            env = P2PShuffleEnv(conf, executor_id=f"exec-local-{len(_P2P_ENVS)}")
            _P2P_ENVS[key] = env
        return env

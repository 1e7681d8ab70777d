"""P2P shuffle transport (port of ``spark_rapids_tpu/shuffle/transport.py``;
spark-rapids' UCX transport stack, ``WindowedBlockIterator`` and
``BounceBufferManager``): bounce buffers, transactions, windowed transfers
and two connections, one in-process and one over TCP sockets.

A fetch holds at most ``num_buffers * buffer_size`` bytes in flight
whatever the shuffle's size: blocks move in windows of at most one bounce
buffer, on both ends. The TCP connection sends length-prefixed frames
(``u32 msg_type | u64 length | payload``); the in-process one calls the
peer's server directly and serves the protocol tests."""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    ShuffleFetchError,
    ShuffleTransportError,
)
from spark_rapids_tpu_torch.runtime.faults import fault_point

# message types (ActiveMessage ids in the reference's UCX.scala)
MSG_METADATA_REQ = 1
MSG_METADATA_RESP = 2
MSG_TRANSFER_REQ = 3
MSG_DATA_WINDOW = 4
MSG_TRANSFER_DONE = 5
MSG_ERROR = 6

TX_SUCCESS = "SUCCESS"
TX_ERROR = "ERROR"
TX_CANCELLED = "CANCELLED"


@dataclass
class Transaction:
    """Completion handle for one request/transfer (Transaction analog,
    UCXTransaction.scala)."""

    status: str = TX_SUCCESS
    error_message: Optional[str] = None
    bytes_transferred: int = 0
    payload: Optional[bytes] = None


#: sentinel distinguishing "no timeout passed" (use the pool default) from
#: an explicit timeout=None (wait forever)
_USE_DEFAULT = object()


class BounceBufferManager:
    """Bounded pool of fixed-size reusable buffers (BounceBufferManager
    analog). acquire() blocks until a buffer frees; the pool caps how much
    memory an in-flight fetch pipeline can hold.

    ``default_timeout`` (seconds; plumbed from
    spark.rapids.shuffle.p2p.bounceAcquireTimeoutMs by the p2p env) bounds
    how long an acquire with no explicit timeout waits — a peer dying
    while holding buffers must surface as a retryable ShuffleFetchError,
    not a hang."""

    def __init__(self, buffer_size: int, num_buffers: int,
                 default_timeout: Optional[float] = None):
        if buffer_size <= 0 or num_buffers <= 0:
            raise ColumnarProcessingError("bounce pool must be non-empty")
        self.buffer_size = buffer_size
        self.num_buffers = num_buffers
        self.default_timeout = default_timeout
        self._free: List[bytearray] = [bytearray(buffer_size)
                                       for _ in range(num_buffers)]
        self._cv = threading.Condition()
        self.acquire_count = 0
        self.high_water = 0

    def acquire(self, timeout=_USE_DEFAULT) -> bytearray:
        if timeout is _USE_DEFAULT:
            timeout = self.default_timeout
        with self._cv:
            if not self._cv.wait_for(lambda: self._free, timeout=timeout):
                raise ShuffleFetchError(
                    f"timed out after {timeout}s waiting for a bounce "
                    "buffer (peer holding buffers may be dead)")
            buf = self._free.pop()
            self.acquire_count += 1
            in_use = self.num_buffers - len(self._free)
            self.high_water = max(self.high_water, in_use)
            return buf

    def release(self, buf: bytearray):
        with self._cv:
            if len(self._free) >= self.num_buffers:
                raise ColumnarProcessingError("double release of bounce buffer")
            self._free.append(buf)
            self._cv.notify()

    @property
    def available(self) -> int:
        with self._cv:
            return len(self._free)


@dataclass(frozen=True)
class BlockRange:
    """One requested block (a serialized shuffle blob) addressed by id."""

    block_id: Tuple[int, int, int]  # (shuffle_id, map_id, partition_id)
    length: int


@dataclass(frozen=True)
class WindowSlice:
    """A window-sized piece of one block (WindowedBlockIterator element)."""

    block_index: int
    block_offset: int
    length: int


def windowed_slices(blocks: List[BlockRange],
                    window_size: int) -> List[List[WindowSlice]]:
    """Split a block list into windows of at most ``window_size`` bytes;
    blocks larger than a window span multiple windows, and small blocks
    share one (WindowedBlockIterator.scala:179). Each window maps onto one
    bounce buffer on both ends."""
    if window_size <= 0:
        raise ColumnarProcessingError("window_size must be positive")
    windows: List[List[WindowSlice]] = []
    cur: List[WindowSlice] = []
    cur_bytes = 0
    for bi, blk in enumerate(blocks):
        off = 0
        remaining = blk.length
        while remaining > 0:
            take = min(remaining, window_size - cur_bytes)
            cur.append(WindowSlice(bi, off, take))
            off += take
            remaining -= take
            cur_bytes += take
            if cur_bytes == window_size:
                windows.append(cur)
                cur, cur_bytes = [], 0
    if cur:
        windows.append(cur)
    return windows


class Connection:
    """One logical peer connection: a synchronous request channel plus a
    windowed data-stream channel (ClientConnection analog)."""

    def request(self, msg_type: int, payload: bytes) -> Transaction:
        raise NotImplementedError

    def stream(self, msg_type: int, payload: bytes,
               on_window: Callable[[memoryview], None]) -> Transaction:
        """Send a request whose response is a stream of data windows;
        ``on_window`` runs for each arriving window (inside a bounce
        buffer), and the returned transaction completes at DONE/ERROR."""
        raise NotImplementedError


class Transport:
    """Factory for peer connections + owner of the bounce pools
    (RapidsShuffleTransport analog)."""

    def __init__(self, recv_pool: BounceBufferManager):
        self.recv_pool = recv_pool

    def connect(self, peer: "PeerInfo") -> Connection:
        raise NotImplementedError

    def shutdown(self):
        pass


@dataclass(frozen=True)
class PeerInfo:
    """What the driver's heartbeat manager hands out per executor."""

    executor_id: str
    host: str = ""
    port: int = 0


# ---------------------------------------------------------------------------
# In-process transport: direct calls into a peer server object. The protocol
# tests (RapidsShuffleClientSuite analog) run against this, as the
# reference's run against mocked jucx.
# ---------------------------------------------------------------------------

class InProcessTransport(Transport):
    _registry: Dict[str, "object"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, recv_pool: BounceBufferManager):
        super().__init__(recv_pool)

    @classmethod
    def register_server(cls, executor_id: str, server: "object"):
        with cls._registry_lock:
            cls._registry[executor_id] = server

    @classmethod
    def unregister_server(cls, executor_id: str):
        with cls._registry_lock:
            cls._registry.pop(executor_id, None)

    def connect(self, peer: PeerInfo) -> Connection:
        with self._registry_lock:
            server = self._registry.get(peer.executor_id)
        if server is None:
            raise ColumnarProcessingError(
                f"no in-process server for executor {peer.executor_id}")
        return _InProcessConnection(server, self.recv_pool)


class _InProcessConnection(Connection):
    def __init__(self, server, recv_pool: BounceBufferManager):
        self.server = server
        self.recv_pool = recv_pool

    def request(self, msg_type: int, payload: bytes) -> Transaction:
        try:
            fault_point("shuffle.transport.request")
            resp_type, resp = self.server.handle_request(msg_type, payload)
        except Exception as e:  # transport surfaces handler faults as tx errors
            return Transaction(status=TX_ERROR, error_message=str(e))
        if resp_type == MSG_ERROR:
            return Transaction(status=TX_ERROR,
                               error_message=resp.decode("utf-8", "replace"))
        return Transaction(payload=resp, bytes_transferred=len(resp))

    def stream(self, msg_type: int, payload: bytes,
               on_window: Callable[[memoryview], None]) -> Transaction:
        from spark_rapids_tpu_torch.runtime.faults import FAULTS
        total = 0
        try:
            for window in self.server.handle_stream(msg_type, payload):
                if FAULTS.armed:
                    # disconnect/slow raise or stall here; corrupt
                    # damages the window copy before reassembly
                    window = fault_point("shuffle.transport.stream",
                                         data=bytes(window))
                buf = self.recv_pool.acquire()
                try:
                    n = len(window)
                    if n > len(buf):
                        raise ColumnarProcessingError(
                            f"window {n}B exceeds bounce buffer {len(buf)}B")
                    buf[:n] = window
                    total += n
                    on_window(memoryview(buf)[:n])
                finally:
                    self.recv_pool.release(buf)
        except Exception as e:
            return Transaction(status=TX_ERROR, error_message=str(e),
                               bytes_transferred=total)
        return Transaction(bytes_transferred=total)


# ---------------------------------------------------------------------------
# TCP transport: length-prefixed frames over sockets — the DCN wire. Frame:
# u32 msg_type | u64 length | payload.
# ---------------------------------------------------------------------------

_FRAME_HDR = struct.Struct("<IQ")


#: payloads up to this size go out in one send with their header (two
#: small sends would wait on the peer's delayed ACK)
_COALESCE_BYTES = 64 << 10


def _send_frame(sock: socket.socket, msg_type: int, payload) -> None:
    hdr = _FRAME_HDR.pack(msg_type, len(payload))
    if len(payload) <= _COALESCE_BYTES:
        sock.sendall(hdr + bytes(payload))
        return
    sock.sendall(hdr)
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int, buf: Optional[bytearray] = None):
    out = buf if buf is not None else bytearray(n)
    view = memoryview(out)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:n], n - got)
        if r == 0:
            raise ColumnarProcessingError("peer closed connection mid-frame")
        got += r
    return out


def _recv_frame_header(sock: socket.socket) -> Tuple[int, int]:
    hdr = _recv_exact(sock, _FRAME_HDR.size)
    return _FRAME_HDR.unpack(bytes(hdr))


class TcpShuffleServerListener:
    """Accept loop for a peer server: each connection gets a handler thread
    (UCX listener analog). ``server`` must expose handle_request /
    handle_stream like the in-process one."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0):
        self.server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._closing = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="shuffle-server-accept", daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,),
                             name="shuffle-server-conn", daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while True:
                try:
                    msg_type, length = _recv_frame_header(conn)
                except ColumnarProcessingError:
                    return  # peer hung up between requests
                payload = bytes(_recv_exact(conn, length)) if length else b""
                if msg_type == MSG_TRANSFER_REQ:
                    try:
                        for window in self.server.handle_stream(
                                msg_type, payload):
                            _send_frame(conn, MSG_DATA_WINDOW, window)
                        _send_frame(conn, MSG_TRANSFER_DONE, b"")
                    except Exception as e:
                        _send_frame(conn, MSG_ERROR, str(e).encode())
                else:
                    try:
                        resp_type, resp = self.server.handle_request(
                            msg_type, payload)
                        _send_frame(conn, resp_type, resp)
                    except Exception as e:
                        _send_frame(conn, MSG_ERROR, str(e).encode())
        finally:
            conn.close()

    def close(self):
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass


class TcpTransport(Transport):
    """``connect_timeout`` comes from spark.rapids.shuffle.fetch
    .connectTimeoutMs; a timed-out connect raises a retryable
    ShuffleTransportError so the fetch-retry loop counts it against the
    peer instead of the query dying on socket.timeout."""

    def __init__(self, recv_pool: BounceBufferManager,
                 connect_timeout: float = 30.0):
        super().__init__(recv_pool)
        self.connect_timeout = connect_timeout

    def connect(self, peer: PeerInfo) -> Connection:
        try:
            sock = socket.create_connection((peer.host, peer.port),
                                            timeout=self.connect_timeout)
        except OSError as e:
            raise ShuffleTransportError(
                f"cannot connect to shuffle peer {peer.executor_id} at "
                f"{peer.host}:{peer.port}: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return _TcpConnection(sock, self.recv_pool)


class _TcpConnection(Connection):
    """``broken`` marks a connection whose wire state is undefined — a
    transport fault (socket error) or protocol desync (unexpected frame,
    oversized window, partially-read stream). The env evicts broken
    connections so the next fetch reconnects instead of parsing mid-stream
    bytes as frame headers. A clean MSG_ERROR response at a
    frame boundary does NOT break the connection."""

    def __init__(self, sock: socket.socket, recv_pool: BounceBufferManager):
        self.sock = sock
        self.recv_pool = recv_pool
        self.broken = False
        self._lock = threading.Lock()  # one request at a time per connection

    def _fault(self, e) -> Transaction:
        self.broken = True
        self.close()
        return Transaction(status=TX_ERROR, error_message=str(e))

    def request(self, msg_type: int, payload: bytes) -> Transaction:
        with self._lock:
            try:
                fault_point("shuffle.transport.request")
                _send_frame(self.sock, msg_type, payload)
                resp_type, length = _recv_frame_header(self.sock)
                resp = bytes(_recv_exact(self.sock, length)) if length else b""
            except (OSError, ColumnarProcessingError) as e:
                return self._fault(e)
        if resp_type == MSG_ERROR:
            return Transaction(status=TX_ERROR,
                               error_message=resp.decode("utf-8", "replace"))
        return Transaction(payload=resp, bytes_transferred=len(resp))

    def stream(self, msg_type: int, payload: bytes,
               on_window: Callable[[memoryview], None]) -> Transaction:
        from spark_rapids_tpu_torch.runtime.faults import FAULTS
        total = 0
        with self._lock:
            try:
                _send_frame(self.sock, msg_type, payload)
                while True:
                    resp_type, length = _recv_frame_header(self.sock)
                    if resp_type == MSG_TRANSFER_DONE:
                        return Transaction(bytes_transferred=total)
                    if resp_type == MSG_ERROR:
                        msg = bytes(_recv_exact(self.sock, length)).decode(
                            "utf-8", "replace") if length else "server error"
                        return Transaction(status=TX_ERROR, error_message=msg,
                                           bytes_transferred=total)
                    if resp_type != MSG_DATA_WINDOW:
                        raise ColumnarProcessingError(
                            f"unexpected frame type {resp_type} in stream")
                    buf = self.recv_pool.acquire()
                    try:
                        if length > len(buf):
                            raise ColumnarProcessingError(
                                f"window {length}B exceeds bounce buffer "
                                f"{len(buf)}B")
                        # receive directly into the bounce buffer
                        view = memoryview(buf)[:length]
                        got = 0
                        while got < length:
                            r = self.sock.recv_into(view[got:], length - got)
                            if r == 0:
                                raise ColumnarProcessingError(
                                    "peer closed mid-window")
                            got += r
                        total += length
                        if FAULTS.armed:
                            view = memoryview(fault_point(
                                "shuffle.transport.stream",
                                data=bytes(view)))
                        on_window(view)
                    finally:
                        self.recv_pool.release(buf)
            except (OSError, ColumnarProcessingError) as e:
                tx = self._fault(e)
                tx.bytes_transferred = total
                return tx

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass

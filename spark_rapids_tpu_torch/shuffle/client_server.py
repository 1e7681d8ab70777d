"""P2P shuffle client/server protocol (port of
``spark_rapids_tpu/shuffle/client_server.py``; spark-rapids'
``RapidsShuffleClient`` and ``RapidsShuffleServer``).

A fetch: the client asks for the (shuffle, partition) blocks it needs, the
server answers from its ShuffleBufferCatalog with block ids and sizes,
then the client requests the transfer and the server streams the blocks
through its send bounce buffers in fixed windows, which the client
reassembles into whole blocks for the received-buffer catalog. Messages
are little-endian struct-packed."""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.errors import ColumnarProcessingError, ShuffleFetchError
from spark_rapids_tpu_torch.runtime.faults import FAULTS, fault_point
from spark_rapids_tpu_torch.shuffle.catalogs import (
    BlockId,
    ShuffleBufferCatalog,
    ShuffleReceivedBufferCatalog,
)
from spark_rapids_tpu_torch.shuffle.transport import (
    MSG_ERROR,
    MSG_METADATA_REQ,
    MSG_METADATA_RESP,
    MSG_TRANSFER_REQ,
    TX_SUCCESS,
    BlockRange,
    BounceBufferManager,
    Connection,
    windowed_slices,
)

_META_REQ = struct.Struct("<IIi")          # shuffle_id, partition_id, n_maps
_BLOCK = struct.Struct("<IIIQ")            # shuffle, map, part, length
_XFER_HDR = struct.Struct("<QI")           # window_size, n_blocks
_BLOCK_ID = struct.Struct("<III")


def encode_metadata_request(shuffle_id: int, partition_id: int,
                            map_ids: Optional[List[int]]) -> bytes:
    n = -1 if map_ids is None else len(map_ids)
    out = bytearray(_META_REQ.pack(shuffle_id, partition_id, n))
    for m in (map_ids or ()):
        out += struct.pack("<I", m)
    return bytes(out)


def decode_metadata_request(payload: bytes):
    shuffle_id, partition_id, n = _META_REQ.unpack_from(payload, 0)
    if n < 0:
        return shuffle_id, partition_id, None
    off = _META_REQ.size
    map_ids = [struct.unpack_from("<I", payload, off + 4 * i)[0]
               for i in range(n)]
    return shuffle_id, partition_id, map_ids


def encode_block_list(blocks: List[Tuple[BlockId, int]]) -> bytes:
    out = bytearray(struct.pack("<I", len(blocks)))
    for (sid, mid, pid), length in blocks:
        out += _BLOCK.pack(sid, mid, pid, length)
    return bytes(out)


def decode_block_list(payload: bytes) -> List[Tuple[BlockId, int]]:
    (n,) = struct.unpack_from("<I", payload, 0)
    out = []
    off = 4
    for _ in range(n):
        sid, mid, pid, length = _BLOCK.unpack_from(payload, off)
        out.append(((sid, mid, pid), length))
        off += _BLOCK.size
    return out


def encode_transfer_request(window_size: int,
                            block_ids: List[BlockId]) -> bytes:
    out = bytearray(_XFER_HDR.pack(window_size, len(block_ids)))
    for sid, mid, pid in block_ids:
        out += _BLOCK_ID.pack(sid, mid, pid)
    return bytes(out)


def decode_transfer_request(payload: bytes):
    window_size, n = _XFER_HDR.unpack_from(payload, 0)
    off = _XFER_HDR.size
    ids = []
    for _ in range(n):
        ids.append(_BLOCK_ID.unpack_from(payload, off))
        off += _BLOCK_ID.size
    return window_size, ids


class ShuffleServer:
    """Serves cached shuffle blocks (RapidsShuffleServer analog). Plugged
    into a transport listener (TCP) or the in-process registry."""

    def __init__(self, catalog: ShuffleBufferCatalog,
                 send_pool: BounceBufferManager):
        self.catalog = catalog
        self.send_pool = send_pool
        self.requests_served = 0
        self.windows_sent = 0

    # -- request channel ----------------------------------------------------
    def handle_request(self, msg_type: int, payload: bytes):
        if msg_type != MSG_METADATA_REQ:
            return MSG_ERROR, f"unsupported request type {msg_type}".encode()
        shuffle_id, partition_id, map_ids = decode_metadata_request(payload)
        blocks = self.catalog.blocks_for_partition(
            shuffle_id, partition_id, map_ids)
        self.requests_served += 1
        return MSG_METADATA_RESP, encode_block_list(blocks)

    # -- stream channel (BufferSendState analog) ----------------------------
    def handle_stream(self, msg_type: int,
                      payload: bytes) -> Iterator[memoryview]:
        if msg_type != MSG_TRANSFER_REQ:
            raise ColumnarProcessingError(
                f"unsupported stream type {msg_type}")
        window_size, ids = decode_transfer_request(payload)
        if window_size > self.send_pool.buffer_size:
            raise ColumnarProcessingError(
                f"requested window {window_size}B exceeds server bounce "
                f"buffer {self.send_pool.buffer_size}B")
        blocks = []
        for bid in ids:
            length = self.catalog.block_length(bid)
            if length is None:
                raise ColumnarProcessingError(
                    f"unknown shuffle block {bid}")
            blocks.append(BlockRange(bid, length))
        for window in windowed_slices(blocks, window_size):
            buf = self.send_pool.acquire()
            try:
                fill = 0
                for ws in window:
                    data = self.catalog.get_block(blocks[ws.block_index]
                                                  .block_id)
                    buf[fill:fill + ws.length] = \
                        data[ws.block_offset:ws.block_offset + ws.length]
                    fill += ws.length
                self.windows_sent += 1
                yield memoryview(buf)[:fill]
            finally:
                self.send_pool.release(buf)


class ShuffleClient:
    """Fetches a reduce partition's blocks from one peer
    (RapidsShuffleClient analog)."""

    def __init__(self, connection: Connection, window_size: int = 1 << 20):
        self.connection = connection
        self.window_size = window_size

    def fetch_metadata(self, shuffle_id: int, partition_id: int,
                       map_ids: Optional[List[int]] = None
                       ) -> List[Tuple[BlockId, int]]:
        fault_point("shuffle.fetch.metadata")
        tx = self.connection.request(
            MSG_METADATA_REQ,
            encode_metadata_request(shuffle_id, partition_id, map_ids))
        if tx.status != TX_SUCCESS:
            # retryable: the peer may be transiently overloaded or the
            # connection desynced — the fetch-retry loop reconnects
            raise ShuffleFetchError(
                f"metadata fetch failed: {tx.error_message}")
        return decode_block_list(tx.payload)

    def fetch_blocks(self, blocks: List[Tuple[BlockId, int]],
                     received: ShuffleReceivedBufferCatalog):
        """Stream the given blocks; completed blocks land in ``received``
        in arrival order (BufferReceiveState reassembly)."""
        if not blocks:
            received.expect(0)
            return
        received.expect(len(blocks))
        # one buffer per in-flight block, handed over (not retained) on
        # completion — client memory is bounded by the bounce pool plus the
        # single block being assembled, not the whole partition
        state = {"next_block": 0, "block_filled": 0,
                 "buf": bytearray(blocks[0][1])}

        def on_window(view: memoryview):
            consumed = 0
            while consumed < len(view):
                i = state["next_block"]
                if i >= len(blocks):
                    raise ColumnarProcessingError(
                        "server sent more bytes than requested")
                _bid, length = blocks[i]
                take = min(len(view) - consumed,
                           length - state["block_filled"])
                start = state["block_filled"]
                state["buf"][start:start + take] = \
                    view[consumed:consumed + take]
                state["block_filled"] += take
                consumed += take
                if state["block_filled"] == length:
                    blob = bytes(state["buf"])
                    if FAULTS.armed:
                        # corrupt kind damages the completed block; the
                        # TPAK CRC catches it at deserialization and the
                        # fetch retries
                        blob = fault_point("shuffle.fetch.stream",
                                           data=blob)
                    received.add(blocks[i][0], blob)
                    state["next_block"] += 1
                    state["block_filled"] = 0
                    if state["next_block"] < len(blocks):
                        state["buf"] = bytearray(
                            blocks[state["next_block"]][1])

        fault_point("shuffle.fetch.stream")
        tx = self.connection.stream(
            MSG_TRANSFER_REQ,
            encode_transfer_request(self.window_size,
                                    [bid for bid, _ in blocks]),
            on_window)
        if tx.status != TX_SUCCESS:
            received.fail(tx.error_message or "transfer failed")
            raise ShuffleFetchError(
                f"block transfer failed: {tx.error_message}")
        if state["next_block"] != len(blocks):
            received.fail("short transfer")
            raise ShuffleFetchError(
                f"short transfer: {state['next_block']}/{len(blocks)} blocks")

    def fetch_partition(self, shuffle_id: int, partition_id: int,
                        received: ShuffleReceivedBufferCatalog,
                        map_ids: Optional[List[int]] = None
                        ) -> List[Tuple[BlockId, int]]:
        """Metadata round trip + streamed transfer; returns the block list
        (what the reference's RapidsShuffleIterator drives per peer)."""
        from spark_rapids_tpu_torch.obs.spans import span
        with span("shuffle.fetch", cat="shuffle",
                  shuffle=shuffle_id, partition=partition_id):
            blocks = self.fetch_metadata(shuffle_id, partition_id, map_ids)
            self.fetch_blocks(blocks, received)
        return blocks

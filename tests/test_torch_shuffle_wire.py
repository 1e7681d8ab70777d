"""The port's host-shuffle wire (spark_rapids_tpu_torch/shuffle/
serializer.py, manager.py codecs, catalogs.py, transport.py,
client_server.py, heartbeat.py) against the JAX package's on the same
numpy inputs.

Comparators:
- TPAK frames: ``bytes ==`` (byte for byte the reference's frame of the
  same table, every flat type, nulls, 0 rows);
- unpacked tables across packages: ``scale_test.tables_differ`` (bitwise,
  in order);
- codec frames: ``bytes ==`` of what each package decodes from the
  other's blob;
- the transport and the catalogs: the bytes served equal the bytes put,
  and the bounce pools' high-water mark stays at or under their buffer
  count."""

import threading

import numpy as np
import pytest

from scale_test import tables_differ
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import HostColumn as JHostColumn
from spark_rapids_tpu.columnar import HostTable as JHostTable
from spark_rapids_tpu.shuffle import manager as jmanager
from spark_rapids_tpu.shuffle import serializer as jser
from spark_rapids_tpu_torch.columnar import HostColumn, HostTable
from spark_rapids_tpu_torch.errors import (
    ColumnarProcessingError,
    CorruptFrameError,
    ShuffleFetchError,
)
from spark_rapids_tpu_torch.interop import host_table_from_arrays
from spark_rapids_tpu_torch.shuffle import manager as tmanager
from spark_rapids_tpu_torch.shuffle import serializer as tser
from spark_rapids_tpu_torch.shuffle.catalogs import (
    ShuffleBufferCatalog,
    ShuffleReceivedBufferCatalog,
)
from spark_rapids_tpu_torch.shuffle.client_server import (
    ShuffleClient,
    ShuffleServer,
    decode_block_list,
    decode_metadata_request,
    decode_transfer_request,
    encode_block_list,
    encode_metadata_request,
    encode_transfer_request,
)
from spark_rapids_tpu_torch.shuffle.heartbeat import (
    ShuffleHeartbeatEndpoint,
    ShuffleHeartbeatManager,
)
from spark_rapids_tpu_torch.shuffle.transport import (
    BlockRange,
    BounceBufferManager,
    InProcessTransport,
    PeerInfo,
    TcpShuffleServerListener,
    TcpTransport,
    windowed_slices,
)

N = 777


def _arrays(n=N, seed=5, nulls=True):
    rng = np.random.default_rng(seed)

    def v():
        return (rng.random(n) > 0.2) if nulls else np.ones(n, bool)

    words = np.array(["", "a", "bé", "çàz", "long value " * 3, "日本"],
                     dtype=object)
    return (
        ["b", "i8", "i16", "i32", "i64", "f32", "f64", "s", "d", "ts",
         "d64", "d128"],
        ["boolean", "tinyint", "smallint", "int", "bigint", "float",
         "double", "string", "date", "timestamp", "decimal(12,2)",
         "decimal(38,4)"],
        [(rng.random(n) > 0.5, v()),
         (rng.integers(-128, 128, n).astype(np.int8), v()),
         (rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16), v()),
         (rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32), v()),
         (rng.integers(-2 ** 62, 2 ** 62, n).astype(np.int64), v()),
         (rng.standard_normal(n).astype(np.float32), v()),
         (rng.standard_normal(n), v()),
         (words[rng.integers(0, len(words), n)], v()),
         (rng.integers(-3000, 30000, n).astype(np.int32), v()),
         (rng.integers(-2 ** 50, 2 ** 50, n).astype(np.int64), v()),
         (rng.integers(-10 ** 11, 10 ** 11, n).astype(np.int64), v()),
         (np.array([int(x) * 10 ** 24 + int(y) for x, y in zip(
             rng.integers(-10 ** 9, 10 ** 9, n),
             rng.integers(-10 ** 9, 10 ** 9, n))], dtype=object), v())])


def _reference(t: HostTable) -> JHostTable:
    names, types, arrays = t.to_arrays()
    return JHostTable(list(names), [
        JHostColumn(JT.parse_type(ty), d, v)
        for ty, (d, v) in zip(types, arrays)])


def _port(j: JHostTable) -> HostTable:
    return host_table_from_arrays(
        list(j.names), [c.dtype.simple_string() for c in j.columns],
        [(c.data, c.validity) for c in j.columns])


@pytest.mark.parametrize("n,nulls", [(N, True), (N, False), (0, True),
                                     (1, True), (9, True)])
def test_tpak_bytes_equal_the_reference(n, nulls):
    t = host_table_from_arrays(*_arrays(n, nulls=nulls))
    assert tser.pack_table(t) == jser.pack_table(_reference(t))


def test_null_type_column_and_unpacking_across_packages():
    names, types, arrays = _arrays()
    t = host_table_from_arrays(names, types, arrays)
    j = _reference(t)
    jt, used = jser.unpack_table(tser.pack_table(t))
    assert tables_differ(jt, j) is None
    tt, used2 = tser.unpack_table(jser.pack_table(j))
    assert used == used2
    assert tables_differ(_reference(tt), j) is None
    # an all-null NULL-typed column: validity only, in both
    from spark_rapids_tpu_torch import types as TT
    nt = HostTable(["z"], [HostColumn(TT.NullType(), np.zeros(5, np.int8),
                                      np.zeros(5, bool))])
    jn = JHostTable(["z"], [JHostColumn(JT.NullType(), np.zeros(5, np.int8),
                                        np.zeros(5, bool))])
    assert tser.pack_table(nt) == jser.pack_table(jn)


def test_a_flipped_byte_raises_corrupt_frame():
    frame = bytearray(tser.pack_table(host_table_from_arrays(*_arrays(50))))
    for pos in (0, 7, len(frame) // 2, len(frame) - 1):
        bad = bytearray(frame)
        bad[pos] ^= 0xFF
        with pytest.raises(CorruptFrameError):
            tser.unpack_table(bytes(bad))
    with pytest.raises(CorruptFrameError):
        tser.unpack_table(bytes(frame[:-3]))


@pytest.mark.parametrize("codec", ["none", "zlib", "lz4", "zstd"])
def test_codec_frames_cross_decode(codec):
    raw = tser.pack_table(host_table_from_arrays(*_arrays()))
    port_blob = tmanager._compress(codec, raw)
    ref_blob = jmanager._compress(codec, raw)
    assert bytes(jmanager._decompress(codec, port_blob)) == raw
    assert bytes(tmanager._decompress(codec, ref_blob)) == raw
    t = tmanager.decode_blob(codec, ref_blob)
    assert tables_differ(_reference(t), jmanager.decode_blob(
        codec, port_blob)) is None


def test_zstd_is_recorded_where_the_reference_may_fall_back():
    """The port runs ZSTD through its own host library, so it records
    ``zstd`` for a zstd request whatever the machine has; the reference
    records ``zlib`` where its ``zstandard`` module is missing (a
    deliberate deviation, ROADMAP Queue 3)."""
    assert tmanager.resolve_codec("zstd") == "zstd"
    assert tmanager.resolve_codec("lz4") == "lz4"
    assert jmanager.resolve_codec("zstd") in ("zstd", "zlib")
    with pytest.raises(ColumnarProcessingError):
        tmanager.resolve_codec("snappy")
    with pytest.raises(CorruptFrameError):
        tmanager.decode_blob("lz4", b"\x05\x00\x00")
    with pytest.raises(CorruptFrameError):
        tmanager.decode_blob("zstd", b"not a zstd frame at all")


def test_windowed_slices_are_the_references():
    from spark_rapids_tpu.shuffle import transport as jtransport
    blocks = [(1, 7), (2, 100), (3, 0), (4, 33), (5, 260)]
    tb = [BlockRange((0, i, 0), n) for i, n in blocks]
    jb = [jtransport.BlockRange((0, i, 0), n) for i, n in blocks]
    for window in (1, 16, 64, 1000):
        got = [[(w.block_index, w.block_offset, w.length) for w in win]
               for win in windowed_slices(tb, window)]
        want = [[(w.block_index, w.block_offset, w.length) for w in win]
                for win in jtransport.windowed_slices(jb, window)]
        assert got == want
        assert all(sum(x[2] for x in win) <= window for win in got)


def test_message_encodings_match_the_reference():
    from spark_rapids_tpu.shuffle import client_server as jcs
    cases = [
        (encode_metadata_request(3, 9, [1, 4]),
         jcs.encode_metadata_request(3, 9, [1, 4])),
        (encode_metadata_request(3, 9, None),
         jcs.encode_metadata_request(3, 9, None)),
        (encode_block_list([((1, 2, 3), 40), ((1, 5, 3), 0)]),
         jcs.encode_block_list([((1, 2, 3), 40), ((1, 5, 3), 0)])),
        (encode_transfer_request(4096, [(1, 2, 3)]),
         jcs.encode_transfer_request(4096, [(1, 2, 3)])),
    ]
    for mine, theirs in cases:
        assert mine == theirs
    assert decode_metadata_request(cases[0][0]) == (3, 9, [1, 4])
    assert decode_block_list(cases[2][0])[0] == ((1, 2, 3), 40)
    assert decode_transfer_request(cases[3][0]) == (4096, [(1, 2, 3)])


def test_catalog_spills_and_faults_back(tmp_path):
    cat = ShuffleBufferCatalog(host_limit_bytes=1000,
                               disk_dir=str(tmp_path))
    blobs = {(0, m, p): bytes([m * 3 + p]) * (300 + m)
             for m in range(4) for p in range(2)}
    for bid, b in blobs.items():
        cat.add_block(bid, b)
    assert cat.spill_count > 0 and cat.host_bytes <= 1000
    for bid, b in blobs.items():
        assert cat.get_block(bid) == b  # spilled ones fault back
    assert [b for b, _ in cat.blocks_for_partition(0, 1)] == [
        (0, m, 1) for m in range(4)]
    with pytest.raises(ColumnarProcessingError):
        cat.add_block((0, 0, 0), b"x")
    cat.remove_shuffle(0)
    assert cat.host_bytes == 0 and not cat.blocks_for_partition(0, 0)


def _serve(transport_kind, window, nbufs, blocks):
    """One server and one client over ``transport_kind``; returns what the
    client received and both pools."""
    cat = ShuffleBufferCatalog()
    for bid, b in blocks.items():
        cat.add_block(bid, b)
    send = BounceBufferManager(window, nbufs, default_timeout=10)
    recv = BounceBufferManager(window, nbufs, default_timeout=10)
    server = ShuffleServer(cat, send)
    listener = None
    if transport_kind == "tcp":
        listener = TcpShuffleServerListener(server)
        transport = TcpTransport(recv, connect_timeout=10)
        peer = PeerInfo("srv", listener.host, listener.port)
    else:
        InProcessTransport.register_server("srv", server)
        transport = InProcessTransport(recv)
        peer = PeerInfo("srv")
    try:
        conn = transport.connect(peer)
        client = ShuffleClient(conn, window_size=window)
        got = {}
        for p in sorted({bid[2] for bid in blocks}):
            received = ShuffleReceivedBufferCatalog()
            client.fetch_partition(7, p, received)
            got.update(dict(received.drain(timeout=10)))
        if transport_kind == "tcp":
            conn.close()
        return got, send, recv
    finally:
        if listener is not None:
            listener.close()
        else:
            InProcessTransport.unregister_server("srv")


@pytest.mark.parametrize("kind", ["inprocess", "tcp"])
def test_client_server_windows_never_exceed_the_pools(kind):
    rng = np.random.default_rng(3)
    blocks = {(7, m, p): rng.integers(0, 256, int(rng.integers(1, 5000)),
                                      dtype=np.uint8).tobytes()
              for m in range(5) for p in range(3)}
    window, nbufs = 1024, 2
    got, send, recv = _serve(kind, window, nbufs, blocks)
    assert got == blocks
    # a fetch never holds more than num_buffers * buffer_size in flight
    assert send.high_water <= nbufs and recv.high_water <= nbufs
    assert send.available == nbufs and recv.available == nbufs


def test_bounce_pool_blocks_then_times_out():
    pool = BounceBufferManager(16, 1, default_timeout=0.05)
    buf = pool.acquire()
    with pytest.raises(ShuffleFetchError):
        pool.acquire()
    t = threading.Timer(0.05, pool.release, args=(buf,))
    t.start()
    assert len(pool.acquire(timeout=5)) == 16
    t.join()


def test_server_refuses_an_oversized_window_and_unknown_blocks():
    cat = ShuffleBufferCatalog()
    cat.add_block((1, 0, 0), b"abc")
    server = ShuffleServer(cat, BounceBufferManager(8, 1))
    with pytest.raises(ColumnarProcessingError):
        list(server.handle_stream(3, encode_transfer_request(64,
                                                             [(1, 0, 0)])))
    with pytest.raises(ColumnarProcessingError):
        list(server.handle_stream(3, encode_transfer_request(8,
                                                             [(1, 9, 0)])))


def test_heartbeat_discovery_eviction_and_rejoin():
    import time
    mgr = ShuffleHeartbeatManager(heartbeat_timeout_s=0.2)
    seen = {"a": [], "b": []}
    ea = ShuffleHeartbeatEndpoint(mgr, PeerInfo("a"),
                                  lambda p: seen["a"].append(p.executor_id),
                                  interval_s=60)
    eb = ShuffleHeartbeatEndpoint(mgr, PeerInfo("b"),
                                  lambda p: seen["b"].append(p.executor_id),
                                  interval_s=60)
    ea.beat_once()
    assert seen == {"a": ["b"], "b": ["a"]}
    time.sleep(0.3)
    eb.beat_once()  # b is fresh again, a is not
    assert mgr.evict_dead() == ["a"]
    assert mgr.live_executors() == ["b"]
    # the evicted executor's next beat is refused; it re-registers
    ea.beat_or_recover()
    assert ea.evicted_count == 1
    assert sorted(mgr.live_executors()) == ["a", "b"]
    eb.beat_once()
    assert seen["b"] == ["a", "a"]
    with pytest.raises(ColumnarProcessingError):
        mgr.heartbeat("nobody")

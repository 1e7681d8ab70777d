"""The port's binary codecs (spark_rapids_tpu_torch/native/zstd_host.cpp and
lz4_host.cpp, through native/__init__.py) against pyarrow's: the ZSTD
decoder reproduces the input of ``pyarrow.Codec("zstd")`` frames at
levels 1, 3, 9 and 19 over text, random bytes and long repeats, plus
checksummed, concatenated, skippable and empty frames; the LZ4 block
decoder reproduces ``pyarrow.Codec("lz4_raw")``'s; the port's encoders'
output decodes through pyarrow's decoders (libzstd checks the XXH64
checksum the port writes); a hypothesis round trip; corrupt and truncated
input raises ColumnarProcessingError and never crashes the process.

Comparator: byte equality of the decoded buffers."""

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from spark_rapids_tpu_torch import native as N
from spark_rapids_tpu_torch.errors import ColumnarProcessingError


def _shapes():
    rng = np.random.default_rng(17)
    words = [b"lineitem", b"orders", b"|", b"1994-01-01", b"AIR", b"RAIL",
             b"0.07", b"\n", b"DELIVER IN PERSON", b"carefully final"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 60_000))
    numbers = np.sort(rng.integers(0, 10**7, 40_000)).astype("<i8")
    return {
        "text": text,
        "random": rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes(),
        "repeats": b"x" * 300_000 + b"yz" * 70_000 + b"x" * 5,
        "numbers": numbers.tobytes(),
        "small": b"abc",
        "one": b"\x00",
    }


SHAPES = _shapes()


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_zstd_decodes_pyarrow_frames(level, shape):
    data = SHAPES[shape]
    frame = pa.Codec("zstd", compression_level=level).compress(
        data, asbytes=True)
    assert N.zstd_decompress(frame).tobytes() == data
    assert N.zstd_decompress(frame, len(data)).tobytes() == data


def test_zstd_empty_multi_frame_and_skippable():
    codec = pa.Codec("zstd")
    empty = codec.compress(b"", asbytes=True)
    assert N.zstd_decompress(empty).tobytes() == b""
    a, b = SHAPES["text"], SHAPES["numbers"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    frames = codec.compress(a, asbytes=True) + skip + \
        codec.compress(b, asbytes=True) + empty
    assert N.zstd_decompress(frames).tobytes() == a + b


def test_zstd_rle_literals_by_hand():
    """A compressed block whose literals are RLE (20 x "z") and that has no
    sequences, behind an RLE block: the one literal form libzstd leaves
    rare, held against pyarrow's decoder."""
    body = bytes([(20 << 3) | 1]) + b"z" + b"\x00"
    rle_block = ((4 << 3) | (1 << 1)).to_bytes(3, "little") + b"q"
    comp_block = ((len(body) << 3) | (2 << 1) | 1).to_bytes(3, "little")
    frame = b"\x28\xb5\x2f\xfd" + bytes([0x20, 24]) + rle_block + \
        comp_block + body
    want = b"q" * 4 + b"z" * 20
    assert pa.Codec("zstd").decompress(frame, decompressed_size=24,
                                       asbytes=True) == want
    assert N.zstd_decompress(frame).tobytes() == want


def test_zstd_output_bound_is_held():
    data = SHAPES["text"]
    frame = pa.Codec("zstd").compress(data, asbytes=True)
    with pytest.raises(ColumnarProcessingError, match="larger"):
        N.zstd_decompress(frame, len(data) - 1)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_zstd_encoder_round_trips_through_pyarrow(shape):
    data = SHAPES[shape]
    dec = pa.Codec("zstd")
    for checksum in (False, True):
        frame = N.zstd_compress(data, checksum=checksum)
        assert dec.decompress(frame, decompressed_size=len(data),
                              asbytes=True) == data
        assert N.zstd_decompress(frame).tobytes() == data
    if shape in ("text", "repeats", "numbers"):
        assert len(N.zstd_compress(data)) < len(data) // 2


def test_zstd_window_past_8_mib_and_full_blocks():
    rng = np.random.default_rng(5)
    block = rng.integers(0, 256, 1 << 17, dtype=np.uint8).tobytes()
    # a repeat 9 MiB back: the port's frame takes a window descriptor
    data = block + rng.integers(0, 4, 9 << 20, dtype=np.uint8).tobytes() \
        + block
    frame = N.zstd_compress(data)
    assert pa.Codec("zstd").decompress(
        frame, decompressed_size=len(data), asbytes=True) == data
    assert N.zstd_decompress(frame).tobytes() == data
    # libzstd's frame of it is multi-segment too (a window descriptor)
    theirs = pa.Codec("zstd", compression_level=1).compress(
        data, asbytes=True)
    assert not theirs[4] & 0x20
    assert N.zstd_decompress(theirs).tobytes() == data


def test_xxh64_checksum_is_libzstds():
    """A checksummed frame whose checksum is off by one bit: libzstd and
    the port both refuse it."""
    data = SHAPES["text"]
    frame = bytearray(N.zstd_compress(data, checksum=True))
    frame[-1] ^= 1
    with pytest.raises(ColumnarProcessingError):
        N.zstd_decompress(bytes(frame))
    with pytest.raises(Exception):
        pa.Codec("zstd").decompress(bytes(frame),
                                    decompressed_size=len(data))


def test_zstd_corrupt_and_truncated_input_raises():
    rng = np.random.default_rng(11)
    frames = [pa.Codec("zstd", compression_level=lv).compress(
        SHAPES[s][:50_000], asbytes=True)
        for lv, s in ((3, "text"), (19, "text"), (1, "numbers"))]
    frames.append(N.zstd_compress(SHAPES["text"][:50_000], checksum=True))
    for frame in frames:
        for cut in sorted(set(rng.integers(1, len(frame), 40).tolist())):
            with pytest.raises(ColumnarProcessingError):
                N.zstd_decompress(frame[:cut])
        for _ in range(150):
            bad = bytearray(frame)
            bad[int(rng.integers(0, len(bad)))] ^= 1 << int(
                rng.integers(0, 8))
            try:
                N.zstd_decompress(bytes(bad), 60_000)
            except ColumnarProcessingError:
                pass
    with pytest.raises(ColumnarProcessingError):
        N.zstd_decompress(b"\x28\xb5\x2f\xfd")
    with pytest.raises(ColumnarProcessingError):
        N.zstd_decompress(b"not a zstd frame")
    # a frame that names a dictionary
    with pytest.raises(ColumnarProcessingError, match="dictionary"):
        N.zstd_decompress(b"\x28\xb5\x2f\xfd\x01\x00\x07\x01\x00\x00\x00")


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lz4_block_codec_against_pyarrow(shape):
    data = SHAPES[shape]
    codec = pa.Codec("lz4_raw")
    block = codec.compress(data, asbytes=True)
    assert N.lz4_decompress(block, len(data)).tobytes() == data
    mine = N.lz4_compress(data)
    assert codec.decompress(mine, decompressed_size=len(data),
                            asbytes=True) == data


def test_lz4_corrupt_and_truncated_input_raises():
    data = SHAPES["text"][:20_000]
    block = pa.Codec("lz4_raw").compress(data, asbytes=True)
    for cut in (1, 7, len(block) // 2, len(block) - 1):
        with pytest.raises(ColumnarProcessingError):
            N.lz4_decompress(block[:cut], len(data))
    with pytest.raises(ColumnarProcessingError):
        N.lz4_decompress(block, len(data) - 1)
    bad = bytearray(block)
    bad[1:3] = b"\xff\xff"
    try:
        N.lz4_decompress(bytes(bad), len(data))
    except ColumnarProcessingError:
        pass


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.binary(min_size=0, max_size=40),
                          st.integers(1, 200)), max_size=30),
       st.booleans())
def test_round_trip_hypothesis(pieces, checksum):
    data = b"".join(p * k for p, k in pieces)
    frame = N.zstd_compress(data, checksum=checksum)
    assert N.zstd_decompress(frame).tobytes() == data
    assert pa.Codec("zstd").decompress(
        frame, decompressed_size=len(data), asbytes=True) == data
    if data:
        block = N.lz4_compress(data)
        assert N.lz4_decompress(block, len(data)).tobytes() == data

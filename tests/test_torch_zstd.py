"""The port's zstd decoder (``vit_ssl_tpu_torch/csrc/zstd_decode.cpp`` through
``utils/zstd.py``) against ``zstandard``, the reference encoder and decoder.

Every case is exact: the decoded bytes equal the input that ``zstandard``
compressed. Cases: levels 1, 3, 19 and 22 (the fast levels' Huffman
literals and FSE sequences; the high levels' long matches and repeat
offsets), the content checksum on and off, the content size absent, text,
random bytes and fp32 arrays (one over 128 KB, so several blocks), several
frames and skippable frames in one buffer, a window of 128 MB, a property
over bounded random inputs, and damaged frames, which raise naming the byte
offset. The CRC-32C that OCDBT uses and XXH64 are held to published values.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from vit_ssl_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

RNG = np.random.default_rng(0)
README = (open(__file__, "rb").read() * 8)[:60_000]
DATA = {
    "text": README,
    "random": RNG.bytes(50_000),
    "fp32": RNG.standard_normal(5_000).astype(np.float32).tobytes(),
    "fp32_large": RNG.standard_normal(60_000).astype(np.float32).tobytes(),  # 240 KB
    "small_ints": RNG.integers(0, 5, 70_000, dtype=np.uint8).tobytes(),
    "zeros": bytes(200_000),
    "empty": b"",
}


def _compress(data, level, checksum=False, content_size=True):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19, 22])
@pytest.mark.parametrize("kind", sorted(DATA))
def test_levels_match_zstandard(kind, level, checksum):
    frame = _compress(DATA[kind], level, checksum)
    assert zstd.decompress(frame) == DATA[kind]


@pytest.mark.parametrize("kind", ["text", "fp32_large", "zeros"])
def test_content_size_absent(kind):
    """A frame with no content size (the streaming API writes one)."""
    frame = _compress(DATA[kind], 3, content_size=False)
    assert zstandard.get_frame_parameters(frame).content_size == zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(frame) == DATA[kind]
    writer = zstandard.ZstdCompressor(level=1).compressobj()
    streamed = writer.compress(DATA[kind]) + writer.flush()
    assert zstd.decompress(streamed) == DATA[kind]


def test_frames_and_skippable_frames():
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    blob = (_compress(b"first", 1) + skippable + _compress(DATA["text"], 19, True)
            + skippable + _compress(b"", 3))
    assert zstd.decompress(blob) == b"first" + DATA["text"]


def test_large_window():
    """A window descriptor of 128 MB (window log 27) on a small frame."""
    params = zstandard.ZstdCompressionParameters.from_level(19, window_log=27)
    writer = zstandard.ZstdCompressor(compression_params=params).compressobj()
    frame = writer.compress(DATA["text"]) + writer.flush()  # size unknown: window kept
    assert zstandard.get_frame_parameters(frame).window_size == 1 << 27
    assert zstd.decompress(frame) == DATA["text"]


def test_decompress_into_and_raw_frames():
    """``decompress_into`` fills an array exactly and refuses a wrong size;
    ``frame_raw`` writes frames of Raw blocks that zstandard reads."""
    array = RNG.standard_normal((300, 200)).astype(np.float32)
    out = np.empty_like(array)
    zstd.decompress_into(_compress(array.tobytes(), 1), out)
    assert out.tobytes() == array.tobytes()
    with pytest.raises(ValueError, match="output larger than"):
        zstd.decompress_into(_compress(array.tobytes(), 1), np.empty(10, np.float32))
    with pytest.raises(ValueError, match="decodes to 40 bytes"):
        zstd.decompress_into(_compress(bytes(40), 1), np.empty(20, np.float32))
    for size in (0, 1, 131_072, 131_073, 400_000):
        data = RNG.bytes(size)
        raw = zstd.frame_raw(data)
        assert zstandard.ZstdDecompressor().decompress(raw) == data
        assert zstd.decompress(raw) == data


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=3000), level=st.integers(1, 19),
       checksum=st.booleans(), repeat=st.integers(1, 4))
def test_property_random_inputs(data, level, checksum, repeat):
    data = data * repeat  # repeats give the match finder something to find
    assert zstd.decompress(_compress(data, level, checksum)) == data


def test_damaged_frames_raise_with_the_offset():
    frame = _compress(DATA["text"], 19, checksum=True)
    with pytest.raises(ValueError, match=r"byte \d+: .*cut short|runs past"):
        zstd.decompress(frame[:len(frame) // 2])
    with pytest.raises(ValueError, match=r"byte 0: bad magic number"):
        zstd.decompress(b"\x00" + frame[1:])
    broken = bytearray(frame)
    broken[-2] ^= 0xFF
    with pytest.raises(ValueError, match=r"byte \d+: content checksum mismatch"):
        zstd.decompress(bytes(broken))
    with pytest.raises(ValueError, match=r"byte \d+: .* stray bytes"):
        zstd.decompress(frame + b"\x28\xb5")
    # every single flipped byte past the magic raises or decodes exactly
    rng = np.random.default_rng(1)
    for at in rng.integers(4, len(frame), 300):
        flipped = bytearray(frame)
        flipped[at] ^= int(rng.integers(1, 256))
        try:
            assert zstd.decompress(bytes(flipped)) == DATA["text"]
        except ValueError as e:
            assert str(e).startswith("zstd: byte ")


def test_dictionaries_are_refused_by_name():
    samples = [DATA["text"][i:i + 400] for i in range(0, 40_000, 400)]
    dictionary = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(samples[3])
    with pytest.raises(zstd.UnsupportedZstd, match="dictionar"):
        zstd.decompress(frame)


def test_checksums_match_published_values():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    data = DATA["fp32"]
    frame = _compress(data, 3, checksum=True)
    assert frame[-4:] == (zstd.xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")

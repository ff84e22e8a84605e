"""On-disk format bit-compatibility: bincode .needle.dat and skip JSON."""

import numpy as np
import pytest

from needle_tpu.data import (
    FrameHashes,
    SkipFile,
    frame_hash_data_path,
    shortest_f32_repr,
    skip_file_path,
    with_rust_extension,
)
from needle_tpu.duration import Duration
from needle_tpu.errors import FrameHashDataInvalidVersion, FrameHashDataNotFound


def test_with_rust_extension():
    assert str(with_rust_extension("/a/ep1.mp4", "needle.dat")) == "/a/ep1.needle.dat"
    assert str(with_rust_extension("/a/ep1", "needle.dat")) == "/a/ep1.needle.dat"
    assert (
        str(with_rust_extension("/a/e.s01.mkv", "needle.skip.json"))
        == "/a/e.s01.needle.skip.json"
    )
    assert str(frame_hash_data_path("/a/x.webm")) == "/a/x.needle.dat"
    assert str(skip_file_path("/a/x.webm")) == "/a/x.needle.skip.json"


def test_bincode_layout_exact():
    fh = FrameHashes(
        np.array([0xDEADBEEF], np.uint32),
        np.array([3 * 10**9 + 4081566], np.int64),
        np.zeros(0, np.uint32),
        np.zeros(0, np.int64),
        Duration.from_secs_f32(0.3),
        "0123456789abcdef0123456789abcdef",
    )
    raw = fh.to_bytes()
    # version enum variant index (u32 LE) == 0, data enum index == 0
    assert raw[:8] == b"\x00\x00\x00\x00\x00\x00\x00\x00"
    # opening vec: u64 len 1, then (u32 hash, u64 secs, u32 nanos)
    assert raw[8:16] == (1).to_bytes(8, "little")
    assert raw[16:20] == (0xDEADBEEF).to_bytes(4, "little")
    assert raw[20:28] == (3).to_bytes(8, "little")
    assert raw[28:32] == (4081566).to_bytes(4, "little")
    # ending vec: len 0
    assert raw[32:40] == (0).to_bytes(8, "little")
    # hash_duration: 0.3f32 -> (0 secs, 300000012 nanos)
    assert raw[40:48] == (0).to_bytes(8, "little")
    assert raw[48:52] == (300000012).to_bytes(4, "little")
    # md5: u64 len + bytes
    assert raw[52:60] == (32).to_bytes(8, "little")
    assert raw[60:] == b"0123456789abcdef0123456789abcdef"


def test_bincode_roundtrip(rng):
    n = 500
    hashes = rng.integers(0, 2**32, n).astype(np.uint32)
    ts = (rng.integers(0, 10**12, n)).astype(np.int64)
    ts.sort()
    fh = FrameHashes(hashes, ts, hashes[:7], ts[:7], Duration.from_millis(300), "x" * 32)
    fh2 = FrameHashes.from_bytes(fh.to_bytes())
    assert (fh2.opening_hashes == hashes).all()
    assert (fh2.opening_ts_nanos == ts).all()
    assert (fh2.ending_hashes == hashes[:7]).all()
    assert fh2.hash_duration() == Duration.from_millis(300)
    assert fh2.md5() == "x" * 32


def test_bad_version_rejected():
    fh = FrameHashes(
        np.zeros(0, np.uint32), np.zeros(0, np.int64),
        np.zeros(0, np.uint32), np.zeros(0, np.int64),
        Duration.from_millis(300), "m" * 32,
    )
    raw = bytearray(fh.to_bytes())
    raw[0] = 7
    with pytest.raises(FrameHashDataInvalidVersion):
        FrameHashes.from_bytes(bytes(raw))


def test_from_path_missing(tmp_path):
    with pytest.raises(FrameHashDataNotFound):
        FrameHashes.from_path(tmp_path / "nope.needle.dat")


def test_shortest_f32_repr():
    # values from the reference README's published skip file
    assert shortest_f32_repr(np.float32(1331.664387072)) == "1331.6644"
    assert shortest_f32_repr(np.float32(1419.024930474)) == "1419.0249"
    assert shortest_f32_repr(np.float32(2.0)) == "2.0"
    assert shortest_f32_repr(np.float32(0.1)) == "0.1"


def test_skip_file_json_bytes():
    sf = SkipFile(
        opening=None,
        ending=(np.float32(1331.664387072), np.float32(1419.024930474)),
        md5="14bfa97f85d86f74e1ab5a26066f9181",
    )
    assert sf.to_json_bytes() == (
        b'{"opening":null,"ending":[1331.6644,1419.0249],'
        b'"md5":"14bfa97f85d86f74e1ab5a26066f9181"}'
    )
    rt = SkipFile.from_json_bytes(sf.to_json_bytes())
    assert rt.opening is None and rt.md5 == sf.md5
    assert rt.ending == pytest.approx((1331.6644, 1419.0249))


def test_fuzz_corrupt_dat_always_needle_error(rng):
    """Truncated/mutated/garbage .needle.dat bytes must surface as needle
    `Error` subclasses, never raw struct.error/UnicodeDecodeError
    (reference data.rs:104-115: bincode failures wrap into needle::Error)."""
    from needle_tpu.errors import Error

    n = 64
    fh = FrameHashes(
        rng.integers(0, 2**32, n).astype(np.uint32),
        np.sort(rng.integers(0, 10**12, n)).astype(np.int64),
        rng.integers(0, 2**32, 7).astype(np.uint32),
        np.sort(rng.integers(0, 10**12, 7)).astype(np.int64),
        Duration.from_millis(300),
        "14bfa97f85d86f74e1ab5a26066f9181",
    )
    golden = fh.to_bytes()

    def check(raw):
        try:
            FrameHashes.from_bytes(bytes(raw))
        except Error:
            pass  # the only acceptable failure class

    # every truncation point
    for cut in range(len(golden)):
        check(golden[:cut])
    # random byte mutations (hits length prefixes, variant indices, the
    # UTF-8 md5 payload, duration fields)
    for _ in range(300):
        raw = bytearray(golden)
        for _ in range(int(rng.integers(1, 4))):
            raw[int(rng.integers(0, len(raw)))] = int(rng.integers(0, 256))
        check(raw)
    # random garbage of assorted sizes
    for size in (0, 1, 4, 8, 12, 16, 64, 1024):
        check(rng.integers(0, 256, size).astype(np.uint8).tobytes())
    # adversarial: plausible header, absurd vec length
    check(
        b"\x00" * 8 + (1 << 50).to_bytes(8, "little") + b"\x00" * 16
    )


def test_ts_mode_golden_bytes(monkeypatch):
    """Both NEEDLE_TPU_TS_MODE interpretations of chromaprint's delay/item
    conversion produce their exact expected on-disk bytes (reference
    analyzer.rs:286-318).

    samples (default): full-precision sample counters (28666/11025 s delay,
    1365/11025 s item). ms: the C API's truncating millisecond accessors
    (chromaprint_get_delay_ms = 2600 ms, chromaprint_get_item_duration_ms
    = 123 ms). step_by is identical in both (123 ms item)."""
    from needle_tpu.analyzer import Analyzer, chromaprint_delay_item

    golden = {
        # mode -> (delay_ns, item_ns, first five ts at step_by=2)
        "samples": (
            2600090703,
            123809524,
            [2600090703, 2847709736, 3095328769, 3342947802, 3590566834],
        ),
        "ms": (
            2600000000,
            123000000,
            [2600000000, 2846000007, 3092000014, 3338000035, 3584000027],
        ),
    }
    hd = Duration.from_secs_f32(np.float32(0.3))
    raw = np.arange(10, dtype=np.uint32)
    for mode, (delay_ns, item_ns, ts_expect) in golden.items():
        monkeypatch.setenv("NEEDLE_TPU_TS_MODE", mode)
        d, it = chromaprint_delay_item()
        assert d.total_nanos() == delay_ns
        assert it.total_nanos() == item_ns
        hashes, ts = Analyzer._hashes_with_timestamps(raw, hd, None)
        assert hashes.tolist() == [0, 2, 4, 6, 8]
        assert ts.tolist() == ts_expect
        # byte-golden through the bincode layer: Duration (u64 secs, u32
        # nanos) of the first timestamp
        fh = FrameHashes(
            hashes, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64), hd,
            "m" * 32,
        )
        b = fh.to_bytes()
        assert b[16:20] == (0).to_bytes(4, "little")  # hash 0
        assert b[20:28] == (ts_expect[0] // 10**9).to_bytes(8, "little")
        assert b[28:32] == (ts_expect[0] % 10**9).to_bytes(4, "little")
        rt = FrameHashes.from_bytes(b)
        assert rt.opening_ts_nanos.tolist() == ts_expect

    monkeypatch.setenv("NEEDLE_TPU_TS_MODE", "bogus")
    with pytest.raises(ValueError):
        chromaprint_delay_item()


def test_shortest_f32_repr_round_values_positional():
    """ryu prints positional decimals for round values — never "9e+01"."""
    for v, expect in [(90.0, "90.0"), (30.0, "30.0"), (120.0, "120.0"),
                      (1000.0, "1000.0"), (0.0, "0.0")]:
        assert shortest_f32_repr(v) == expect
    assert np.float32(shortest_f32_repr(1331.664387072)) == np.float32(
        1331.664387072
    )

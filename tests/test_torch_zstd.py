"""The port's zstd frame decoder (``csrc/zstd_decode.cpp`` through
``utils/zstd.py``) against the system's libzstd as the oracle.

libzstd is loaded here through ctypes, in the tests alone: the port never
loads it.  Frames are written by libzstd at levels 1, 3, 9 and 19, with and
without checksums and content sizes, windowed and single-segment; the
committed orbax trees' chunk frames are decoded by both and compared.
Truncated and bit-flipped frames must raise ValueError (or, for a flip the
format ignores, give the same bytes), never crash.
"""

import ctypes
import ctypes.util
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from omniparser_tpu_torch.ops import cuda_build
from omniparser_tpu_torch.utils import zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = ("det_synth", "ocr_en_synth", "cap_synth")

# ZSTD_cParameter values (zstd.h)
C_LEVEL, C_WINDOW_LOG = 100, 101
C_CONTENT_SIZE, C_CHECKSUM = 200, 201


def _libzstd():
    name = ctypes.util.find_library("zstd") or "libzstd.so.1"
    try:
        # its own symbols first: a package loaded earlier in the process may
        # export another zstd's functions under the same names
        lib = ctypes.CDLL(name, mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
    except OSError:
        pytest.skip("no libzstd on this machine to hold the decoder against")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    return lib


@pytest.fixture(scope="module")
def libzstd():
    return _libzstd()


def compress(lib, data: bytes, level: int, checksum: bool = False, content_size: bool = True,
             window_log: int = 0) -> bytes:
    cctx = lib.ZSTD_createCCtx()
    try:
        for param, value in ((C_LEVEL, level), (C_CHECKSUM, int(checksum)),
                             (C_CONTENT_SIZE, int(content_size)), (C_WINDOW_LOG, window_log)):
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, param, value))
        cap = lib.ZSTD_compressBound(len(data))
        out = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return out.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def oracle_decode(lib, frame: bytes, size: int) -> bytes:
    out = ctypes.create_string_buffer(max(size, 1))
    n = lib.ZSTD_decompress(out, max(size, 1), frame, len(frame))
    assert not lib.ZSTD_isError(n)
    return out.raw[:n]


def make_buffer(kind: str, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "repetitive":  # short motifs repeated at varying distances
        motifs = [rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
                  for _ in range(8)]
        out = bytearray()
        while len(out) < size:
            out += motifs[int(rng.integers(0, 8))] * int(rng.integers(1, 40))
        return bytes(out[:size])
    if kind == "text":  # words from a skewed vocabulary
        words = [bytes(rng.integers(97, 123, int(rng.integers(1, 10)), dtype=np.uint8))
                 for _ in range(500)]
        picks = np.minimum(rng.zipf(1.3, size // 3 + 1), 500) - 1
        return b" ".join(words[i] for i in picks)[:size]
    # float32 weights: what the trees' chunks hold
    return rng.standard_normal(size // 4 + 1).astype(np.float32).tobytes()[:size]


@pytest.mark.parametrize("level", [1, 3, 9, 19])
@settings(max_examples=12, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(kind=st.sampled_from(["random", "repetitive", "text", "floats"]),
       size=st.one_of(st.integers(0, 600), st.integers(100_000, 2 << 20)),
       seed=st.integers(0, 2**31 - 1), checksum=st.booleans())
def test_round_trip_against_libzstd(libzstd, level, kind, size, seed, checksum):
    data = make_buffer(kind, size, seed)
    frame = compress(libzstd, data, level, checksum=checksum)
    got = zstd.decompress(frame)
    assert got.dtype == np.uint8 and got.tobytes() == data


def test_checksum_and_windowed_frames(libzstd):
    """A content checksum is verified; a frame without a content size is a
    windowed one, decoded to the caller's expected size, and its matches
    reach further back than 128 KB."""
    rng = np.random.default_rng(1)
    block = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    data = block + make_buffer("text", 200_000, 2) + block  # a match 500 KB back
    frame = compress(libzstd, data, 19, checksum=True, content_size=False, window_log=21)
    fhd = frame[4]
    assert not fhd & 0x20 and fhd & 0x04 and fhd >> 6 == 0  # windowed, checksum, no size
    assert len(frame) < len(data) // 2  # the repeat was found across the window
    assert zstd.decompress(frame, expected_size=len(data)).tobytes() == data
    with pytest.raises(ValueError, match="no content size"):
        zstd.decompress(frame)
    with pytest.raises(ValueError, match="expected"):
        zstd.decompress(frame, expected_size=len(data) + 1)
    bad = bytearray(frame)
    bad[-1] ^= 0x40  # the checksum's last byte
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(bad), expected_size=len(data))


def test_concatenated_and_skippable_frames(libzstd):
    a, b = make_buffer("text", 70_000, 3), make_buffer("floats", 50_000, 4)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"xxxxx"
    stream = compress(libzstd, a, 3) + skippable + compress(libzstd, b, 9, checksum=True)
    assert zstd.decompress(stream).tobytes() == a + b
    assert zstd.decompress(skippable + compress(libzstd, b"", 1)).tobytes() == b""


def test_dictionary_frames_raise(libzstd):
    frame = bytearray(compress(libzstd, make_buffer("text", 1000, 5), 3))
    # set Dictionary_ID_flag to 1 and insert a one-byte dictionary id after
    # the descriptor (and the window byte where the frame has one)
    at = 5 if frame[4] & 0x20 else 6
    frame[4] |= 0x01
    frame[at:at] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(frame), expected_size=1000)


@pytest.mark.parametrize("tree", TREES)
def test_every_chunk_frame_of_the_committed_trees(libzstd, tree):
    """Each zstd frame in the tree (every array chunk and every compressed
    B+tree node) decodes to libzstd's bytes."""
    from omniparser_tpu_torch.weights.orbax_read import OcdbtStore

    store = OcdbtStore(os.path.join(ROOT, "omniparser_tpu", "weights", tree))
    chunks = 0
    for key in store.keys():
        if key.endswith(b"/.zarray"):
            continue
        frame = store.read(key)
        got = zstd.decompress(frame, limit=1 << 26)
        assert got.tobytes() == oracle_decode(libzstd, frame, got.size), key
        chunks += 1
    assert chunks == len(store.keys()) // 2
    root = store.version.root
    with open(os.path.join(store.root, root.file), "rb") as f:
        f.seek(root.offset)
        node = f.read(root.length)
    body = node[14:-4]  # magic, length, version 0 and compression 1, one byte each
    assert node[12:14] == b"\x00\x01"
    got = zstd.decompress(body, limit=1 << 24)
    assert got.tobytes() == oracle_decode(libzstd, body, 1 << 24)


def _frames(lib):
    rng = np.random.default_rng(6)
    return [compress(lib, make_buffer(kind, size, int(rng.integers(0, 1 << 30))), level,
                     checksum=True)
            for kind, size, level in (("text", 5000, 3), ("floats", 40_000, 1),
                                      ("repetitive", 150_000, 19), ("random", 3000, 9),
                                      ("text", 300, 1))]


def test_truncated_frames_raise(libzstd):
    for frame in _frames(libzstd):
        for cut in sorted({0, 1, 4, 5, 6, 8, 12, len(frame) // 2, len(frame) - 5,
                           len(frame) - 1}):
            with pytest.raises(ValueError):
                zstd.decompress(frame[:cut])


def test_bit_flipped_frames_raise_or_decode_equal(libzstd):
    """A flipped bit gives ValueError, or (a bit the format ignores, such as
    the descriptor's unused bit or a larger window) the same bytes; never a
    crash and never other bytes."""
    rng = np.random.default_rng(7)
    raised = same = 0
    for frame in _frames(libzstd):
        data = oracle_decode(libzstd, frame, 1 << 20)
        positions = list(range(min(len(frame), 24))) + list(
            rng.integers(0, len(frame), 160))
        for pos in positions:
            bad = bytearray(frame)
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            try:
                got = zstd.decompress(bytes(bad), expected_size=len(data))
            except ValueError:
                raised += 1
                continue
            assert got.tobytes() == data, pos
            same += 1
    assert raised > 10 * same


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "zstd_decode.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "SOURCE", str(src))
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building .*zstd_decode.cpp failed"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")

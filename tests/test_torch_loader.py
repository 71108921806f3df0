"""The port's native prefetch loader (ame_tpu_torch.io.loader over its own
copy of io/native/ameloader.cpp, linked into the amecodec library): decode
parity with the port's Python decoders, submission order, the Python route
and its counter, and a corrupt file yielding its error
(tests/test_loader.py's contract). Nothing here calls ame_tpu.io.loader:
it builds its shim in place."""

import math
import struct

import numpy as np
import pytest

from ame_tpu_torch.io import codecs, loader, read_audio
from ame_tpu_torch.io.loader import PrefetchLoader
from ame_tpu_torch.io.wav import write_wav

SR = 22050


@pytest.fixture(autouse=True)
def _fresh_counts(monkeypatch):
    monkeypatch.setattr(loader, "decodes", {"native": {}, "python": {}})


def _tracks(tmp_path, n=5):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        x = (rng.standard_normal((SR // 2 + i * 37, 2)) * 0.2).astype(
            np.float32)
        p = str(tmp_path / f"t{i}.wav")
        write_wav(p, x, SR, bits=[16, 24, 32, 16, 24][i % 5])
        paths.append(p)
    return paths


def flac_verbatim(path, pcm, sr, block=4096):
    """int16 [N, C] as a FLAC stream of verbatim subframes (CRCs and MD5
    zero: the decoder checks none)."""
    n, c = pcm.shape
    info = struct.pack(">HHHBHB", block, block, 0, 0, 0, 0)
    info += struct.pack(">Q", (sr << 44) | ((c - 1) << 41) | (15 << 36) | n)
    out = [b"fLaC", b"\x80" + struct.pack(">I", len(info) + 16)[1:],
           info, bytes(16)]
    for i, s in enumerate(range(0, n, block)):
        blk = pcm[s:s + block]
        out.append(b"\xff\xf8" + bytes([0x70, ((c - 1) << 4) | 0x08])
                   + chr(i).encode("utf-8")
                   + struct.pack(">H", len(blk) - 1) + b"\x00")
        for ch in range(c):
            out.append(b"\x02" + blk[:, ch].astype(">i2").tobytes())
        out.append(b"\x00\x00")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def aiff16(path, mono, sr):
    pcm = (mono * 32767).astype(">i2")

    def ext80(rate):
        m, e = math.frexp(rate)
        return struct.pack(">HQ", e + 16382, int(m * (1 << 64)))

    comm = struct.pack(">HIH", 1, len(pcm), 16) + ext80(sr)
    ssnd = struct.pack(">II", 0, 0) + pcm.tobytes()
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def test_native_loader_is_linked_into_the_codec_library():
    lib = loader._lib()
    assert lib is not None, "ameloader shim failed to build or bind"
    assert lib is codecs._load()
    for sym in ("ame_loader_open", "ame_loader_next", "ame_loader_close",
                "ame_flac_decode"):
        assert hasattr(lib, sym)


def test_loader_matches_python_decoders(tmp_path):
    """PCM 16 / 24 / 32 WAVs and a FLAC decode natively, bit-equal to the
    port's read_audio, in submission order."""
    paths = _tracks(tmp_path)
    pcm = (np.random.default_rng(1).standard_normal((10_000, 2)) * 3000
           ).astype(np.int16)
    flac = str(tmp_path / "f.flac")
    flac_verbatim(flac, pcm, SR)
    paths.insert(2, flac)
    got = list(PrefetchLoader(paths, workers=3))
    assert [g[0] for g in got] == paths
    for p, audio, sr in got:
        want, wsr = read_audio(p)
        assert sr == wsr == SR
        assert audio.dtype == np.float32
        np.testing.assert_array_equal(audio, want)
    np.testing.assert_array_equal(got[2][1], pcm / np.float32(32768.0))
    assert loader.decodes == {"native": {".wav": 5, ".flac": 1},
                              "python": {}}


def test_loader_python_route_for_aiff(tmp_path):
    """AIFF is not native-decodable: the loader falls back to the Python
    decoder, and the counter says so."""
    x = np.sin(2 * np.pi * 440 * np.arange(SR) / SR) * 0.3
    p = str(tmp_path / "a.aiff")
    aiff16(p, x, SR)
    got = list(PrefetchLoader([p], workers=1))
    assert len(got) == 1
    path, audio, sr = got[0]
    want, wsr = read_audio(p)
    assert path == p and sr == wsr
    np.testing.assert_array_equal(audio, want)
    assert loader.decodes == {"native": {}, "python": {".aiff": 1}}


def test_loader_corrupt_file_yields_error(tmp_path):
    good = _tracks(tmp_path, 2)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage")
    items = list(PrefetchLoader([good[0], bad, good[1]], workers=2))
    assert [i[0] for i in items] == [good[0], bad, good[1]]
    assert items[0][1] is not None and items[2][1] is not None
    assert items[1][1] is None
    assert isinstance(items[1][2], Exception)
    assert loader.decodes == {"native": {".wav": 2}, "python": {".wav": 1}}


def test_loader_keeps_order_with_four_workers(tmp_path):
    """Many files of very different lengths on 4 workers: later, shorter
    files finish first, and the loader still yields in submission order."""
    rng = np.random.default_rng(3)
    paths = []
    for i in range(12):
        n = [40_000, 50, 3000][i % 3] + i
        p = str(tmp_path / f"o{i:02d}.wav")
        write_wav(p, (rng.standard_normal((n, 1)) * 0.1).astype(np.float32),
                  SR)
        paths.append(p)
    with PrefetchLoader(paths, workers=4) as it:
        got = list(it)
    assert [g[0] for g in got] == paths
    for (p, audio, _), i in zip(got, range(12)):
        assert audio.shape == ([40_000, 50, 3000][i % 3] + i, 1)
        np.testing.assert_array_equal(audio, read_audio(p)[0])


def test_loader_without_the_shim_takes_the_python_route(tmp_path,
                                                         monkeypatch):
    """Where the shim cannot be built every file takes the Python route,
    with the same results."""
    paths = _tracks(tmp_path, 2)
    monkeypatch.setattr(loader, "_lib", lambda: None)
    got = list(PrefetchLoader(paths, workers=2))
    for p, audio, _ in got:
        np.testing.assert_array_equal(audio, read_audio(p)[0])
    assert loader.decodes == {"native": {}, "python": {".wav": 2}}

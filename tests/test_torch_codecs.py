"""The port's codec edge (ame_tpu_torch.io: codecs, flac, av, audio_file) and
its native build (ops._build.build / build_host), on the CPU.

FLAC streams are written here by a bit writer (no FLAC encoder is needed),
one per subframe kind and stereo decorrelation, and must decode to the PCM
that was written. Nothing here calls ame_tpu.io's codecs: they build their
shim in place."""

import ctypes
import os
import struct
import sys
import threading

import numpy as np
import pytest

from ame_tpu_torch.io import codecs, read_audio, write_audio
from ame_tpu_torch.io import wav as W
from ame_tpu_torch.io.flac import read_flac
from ame_tpu_torch.ops import _build


class BitWriter:
    def __init__(self):
        self.bits = []

    def w(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def sw(self, value, n):
        self.w(value & ((1 << n) - 1), n)

    def unary(self, q):
        self.bits.extend([0] * q + [1])

    def rice(self, residuals, param):
        for r in residuals:
            u = (r << 1) if r >= 0 else ((-r << 1) - 1)
            self.unary(u >> param)
            self.w(u & ((1 << param) - 1), param)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self):
        self.align()
        return np.packbits(np.array(self.bits, np.uint8)).tobytes()


def _flac_file(frames: bytes, rate=44100, channels=2, bps=16, total=0):
    bw = BitWriter()
    for v, n in ((4096, 16), (4096, 16), (0, 24), (0, 24), (rate, 20),
                 (channels - 1, 3), (bps - 1, 5), (total, 36)):
        bw.w(v, n)
    si = bw.bytes() + bytes(16)           # + the MD5 (not checked)
    return (b"fLaC" + bytes([0x80]) + struct.pack(">I", len(si))[1:] + si
            + frames)


def _frame(subframes, ch_asgn, n=192):
    """One frame of blocksize 192 (code 1) at the STREAMINFO rate; each
    subframe is (kind, values, bits)."""
    bw = BitWriter()
    for v, k in ((0x3FFE, 14), (0, 1), (0, 1), (1, 4), (0, 4), (ch_asgn, 4),
                 (4, 3), (0, 1), (0, 8), (0, 8)):   # frame 0, CRC-8 unchecked
        bw.w(v, k)
    for kind, vals, bits in subframes:
        bw.w(0, 1)
        if kind == "constant":
            bw.w(0, 6)
            bw.w(0, 1)
            bw.sw(int(vals[0]), bits)
        elif kind == "verbatim":
            bw.w(1, 6)
            bw.w(0, 1)
            for v in vals:
                bw.sw(int(v), bits)
        elif kind == "fixed":               # order 2: 2 s[i-1] - s[i-2]
            bw.w(8 + 2, 6)
            bw.w(0, 1)
            for v in vals[:2]:
                bw.sw(int(v), bits)
            bw.w(0, 2)
            bw.w(0, 4)
            bw.w(10, 4)
            bw.rice([int(vals[i] - 2 * vals[i - 1] + vals[i - 2])
                     for i in range(2, n)], 10)
        else:                               # lpc order 2, 12-bit coeffs
            coef, shift = (1843, -840), 10
            bw.w(32 + 1, 6)
            bw.w(0, 1)
            for v in vals[:2]:
                bw.sw(int(v), bits)
            bw.w(12 - 1, 4)
            bw.sw(shift, 5)
            for c in coef:
                bw.sw(c, 12)
            bw.w(0, 2)
            bw.w(0, 4)
            bw.w(12, 4)
            bw.rice([int(vals[i] - ((coef[0] * int(vals[i - 1])
                                     + coef[1] * int(vals[i - 2])) >> shift))
                     for i in range(2, n)], 12)
    bw.align()
    bw.w(0, 16)                             # CRC-16 (unchecked)
    return bw.bytes()


def _pcm(kind, n=192, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    if kind == "constant":
        return np.array([[1234] * n, [-77] * n], np.int64).T
    if kind == "verbatim":
        return rng.integers(-30000, 30000, (n, 2)).astype(np.int64)
    return np.stack([np.round(8000 * np.sin(2 * np.pi * 5 * t / n)),
                     np.round(6000 * np.sin(2 * np.pi * 3 * t / n + 0.5))],
                    axis=1).astype(np.int64) + rng.integers(-40, 40, (n, 2))


@pytest.mark.parametrize("kind", ["constant", "verbatim", "fixed", "lpc"])
def test_flac_subframe_kinds(tmp_path, kind):
    """Each subframe kind, two independent channels, decodes to the PCM
    that was written (int16 / 32768)."""
    want = _pcm(kind)
    blob = _flac_file(_frame([(kind, want[:, c], 16) for c in range(2)], 1),
                      total=len(want))
    p = tmp_path / "t.flac"
    p.write_bytes(blob)
    y, sr = read_flac(str(p))
    assert sr == 44100 and y.shape == want.shape
    np.testing.assert_array_equal(y, want.astype(np.float32) / 32768.0)


@pytest.mark.parametrize("mode", ["left_side", "right_side", "mid_side"])
def test_flac_stereo_decorrelation(tmp_path, mode):
    """Left/side (8), right/side (9) and mid/side (10) frames rebuild both
    channels exactly; the side channel carries one more bit."""
    want = _pcm("fixed", seed=1)
    left, right = want[:, 0], want[:, 1]
    side = left - right
    chans = {"left_side": (8, [(left, 16), (side, 17)]),
             "right_side": (9, [(side, 17), (right, 16)]),
             "mid_side": (10, [((left + right) >> 1, 16), (side, 17)])}
    asgn, subs = chans[mode]
    blob = _flac_file(_frame([("fixed", v, b) for v, b in subs], asgn),
                      total=len(want))
    p = tmp_path / f"{mode}.flac"
    p.write_bytes(blob)
    y, _ = read_flac(str(p))
    np.testing.assert_array_equal(y, want.astype(np.float32) / 32768.0)


def test_flac_mutations_never_crash(tmp_path):
    """Byte flips, truncations and splices of a valid stream either decode
    to finite samples or raise RuntimeError: the server decodes untrusted
    uploads in-process, so a crash would take the server down."""
    want = _pcm("verbatim")
    blob = _flac_file(_frame([("fixed", want[:, c], 16) for c in range(2)],
                             1), total=len(want))
    rng = np.random.default_rng(0xF1AC)
    p = tmp_path / "fuzz.flac"
    for trial in range(150):
        mut = bytearray(blob)
        if trial % 3 == 0:
            for _ in range(int(rng.integers(1, 9))):
                mut[int(rng.integers(0, len(mut)))] ^= int(
                    rng.integers(1, 256))
        elif trial % 3 == 1:
            mut = mut[:int(rng.integers(1, len(mut)))]
        else:
            i = int(rng.integers(0, len(mut)))
            mut[i:i] = rng.integers(0, 256, int(rng.integers(1, 64)),
                                    dtype=np.uint8).tobytes()
        p.write_bytes(bytes(mut))
        try:
            y, _ = read_flac(str(p))
        except RuntimeError:
            continue
        assert np.isfinite(y).all()


def _tone(n=44100, sr=44100):
    x = 0.5 * np.sin(2 * np.pi * 440 * np.arange(n) / sr).astype(np.float32)
    return np.stack([x, 0.8 * x], axis=1)


def test_mp3_roundtrip(tmp_path):
    """LAME V0 encode, mpg123 decode: the length within the encoder's
    padding and the 440 Hz tone intact (tests/test_io.py's bounds)."""
    if not codecs.have_mp3_encode():
        pytest.skip("no libmp3lame")
    sr = 44100
    x = _tone()
    p = str(tmp_path / "t.mp3")
    codecs.encode_mp3(p, x, sr)
    assert os.path.getsize(p) > 8000
    if not codecs.have_mp3_decode():
        pytest.skip("no libmpg123")
    y, sr2 = read_audio(p)
    assert sr2 == sr and y.shape[1] == 2
    assert abs(y.shape[0] - len(x)) < 5000
    seg = y[len(y) // 4: len(y) // 4 + 4096, 0]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(np.argmax(spec) * sr / len(seg) - 440) < 15


def test_audio_file_dispatch(tmp_path):
    """By extension (WAV, AIFF, FLAC, MP3), by magic (RIFF keeps
    prefer_int16, fLaC), and the refusals."""
    x = _tone(4410)
    p = str(tmp_path / "d.wav")
    write_audio(p, x, 44100)
    y, sr = read_audio(p)
    assert sr == 44100 and y.shape == x.shape and y.dtype == np.float32
    raw = tmp_path / "riff.bin"
    raw.write_bytes(open(p, "rb").read())
    y16, _ = read_audio(str(raw), prefer_int16=True)
    assert y16.dtype == np.int16
    np.testing.assert_array_equal(y16.astype(np.float32) / 32768.0, y)
    pa = str(tmp_path / "d.aiff")
    write_audio(pa, x, 44100)
    np.testing.assert_array_equal(read_audio(pa)[0], y)

    want = _pcm("verbatim")
    blob = _flac_file(_frame([("verbatim", want[:, c], 16)
                              for c in range(2)], 1), total=len(want))
    for name in ("f.flac", "f.dat"):
        (tmp_path / name).write_bytes(blob)
        yf, _ = read_audio(str(tmp_path / name))
        np.testing.assert_array_equal(yf, want.astype(np.float32) / 32768.0)

    if codecs.have_mp3_encode() and codecs.have_mp3_decode():
        pm = str(tmp_path / "d.mp3")
        write_audio(pm, x, 44100)
        assert read_audio(pm)[0].shape[1] == 2
    with pytest.raises(ValueError, match="unsupported output format"):
        write_audio(str(tmp_path / "x.xyz"), x, 44100)
    bad = tmp_path / "x.mp3"
    bad.write_bytes(b"ID3\x04not really an mp3")
    with pytest.raises(RuntimeError, match="MP3 decode"):
        read_audio(str(bad))


def test_build_host_race(tmp_path, monkeypatch):
    """Four threads build one library through build_host into an empty
    _build directory at once: one compile, one path, a loadable library,
    no temp file left behind."""
    monkeypatch.setattr(_build, "_OUT", tmp_path / "_build")
    src = os.path.join(os.path.dirname(codecs.__file__), "native",
                       "amecodec.cpp")
    barrier = threading.Barrier(4)
    results = [None] * 4

    def go(i):
        barrier.wait()
        try:
            results[i] = _build.build_host("amecodec", [src],
                                           ("-ldl", "-lpthread"))
        except Exception as e:  # noqa: BLE001 — surfaced below
            results[i] = e

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    assert all(isinstance(r, dict) for r in results), results
    assert len({r["path"] for r in results}) == 1
    assert sum(r["seconds"] > 0 for r in results) == 1
    assert os.listdir(tmp_path / "_build") == [results[0]["path"].name]
    lib = ctypes.CDLL(str(results[0]["path"]))
    assert lib.ame_have_lame() in (0, 1)


def test_build_is_locked_and_names_temp_by_thread(tmp_path, monkeypatch):
    """_build.build under four racing threads runs the compiler once, into
    a temp file named by pid and thread, renamed into place (a stand-in
    nvcc records its output path)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.txt"
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"open({str(calls)!r}, 'a').write(out + '\\n')\n"
        "time.sleep(0.3)\n"
        "open(out, 'wb').write(b'lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "_OUT", tmp_path / "_build")
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(_build.build("cascade_scan")))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(results) == 4 and len({r["path"] for r in results}) == 1
    tmp_names = calls.read_text().split()
    assert len(tmp_names) == 1
    assert f".{os.getpid()}." in tmp_names[0]
    assert tmp_names[0].endswith(".tmp")
    assert results[0]["path"].read_bytes() == b"lib"
    assert os.listdir(tmp_path / "_build") == [results[0]["path"].name]


def test_build_host_failure_raises_and_leaves_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_OUT", tmp_path / "_build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ building bad"):
        _build.build_host("bad", [bad])
    assert os.listdir(tmp_path / "_build") == []


def test_av_probe_is_a_bool():
    """have_av() answers True or False (False where the FFmpeg development
    files are missing: logged, never raised)."""
    from ame_tpu_torch.io import av
    assert av.have_av() in (True, False)
    if av.have_av():
        assert ".ogg" in av.DECODE_EXTENSIONS


def test_wav_roundtrip_through_dispatch(tmp_path):
    x = _tone(1000)
    p = str(tmp_path / "r.wav")
    write_audio(p, x, 48000, bits=24)
    y, sr = W.read_wav(p)
    assert sr == 48000
    np.testing.assert_allclose(y, x, atol=2 / 8388608)

"""The port's cover-art providers (ame_tpu_torch.creative.art, .procedural)
against ame_tpu's, on the CPU."""

import os
import struct
import subprocess
import zlib

import numpy as np
import pytest

from ame_tpu_torch.creative import art, procedural

HAPPY = ("An award-winning piece of vibrant, euphoric digital artwork, "
         "joyful energy")
SAD = "An award-winning piece of melancholic, somber artwork, rainy window"


@pytest.fixture
def registry(monkeypatch):
    """An empty provider registry for one test (restored afterwards), with
    the opt-in variable unset and the cloud SDK's probe left out (its
    import alone takes ~30 s where it is installed)."""
    monkeypatch.setattr(art, "_try_register_vertex", lambda: None)
    monkeypatch.setattr(art, "_providers", {})
    monkeypatch.setattr(art, "_active", None)
    monkeypatch.delenv("AME_TPU_ART_PROVIDER", raising=False)
    return art


def _read_png(path):
    """Decode an 8-bit RGB PNG of filter-0 scanlines with the standard
    library: the pixels and the chunk tags."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, tags, idat = 8, [], b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body)
        tags.append(tag)
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3), tags


def test_provider_registry(tmp_path, registry):
    calls = []

    def fake(prompt, out_path):
        calls.append((prompt, out_path))
        with open(out_path, "wb") as f:
            f.write(b"png")
        return out_path

    assert not registry.available()     # no provider, no opt-in: no art
    registry.register_provider("fake", fake)
    assert registry.available()
    out = registry.generate_cover_art("a test prompt",
                                      str(tmp_path / "master.wav"))
    assert out == str(tmp_path / "master_art.png")   # engine:163-166
    assert calls == [("a test prompt", out)]
    # a later provider registered without activation keeps the slot
    registry.register_provider("other", fake, activate=False)
    assert registry._active == "fake"


def test_no_provider_raises(tmp_path, registry):
    with pytest.raises(RuntimeError, match="no art provider"):
        registry.generate_cover_art("p", str(tmp_path / "m.wav"))


def test_art_path_matches_reference():
    from ame_tpu.creative import art as ref_art
    for p in ("/a/b/song.wav", "rel.mp3", "/x/y.z.wav"):
        assert art.art_path_for(p) == ref_art.art_path_for(p)


def test_gcloud_project_fallback(monkeypatch):
    """The project id comes from `gcloud config get-value project`
    (engine:157-159); unset or missing gcloud gives None."""
    def fake(stdout):
        def run(cmd, **kw):
            assert cmd == ["gcloud", "config", "get-value", "project"]
            return subprocess.CompletedProcess(cmd, 0, stdout=stdout,
                                               stderr="")
        return run

    monkeypatch.setattr(subprocess, "run", fake("my-proj-123\n"))
    assert art._gcloud_project_id() == "my-proj-123"
    monkeypatch.setattr(subprocess, "run", fake("(unset)\n"))
    assert art._gcloud_project_id() is None

    def missing(cmd, **kw):
        raise FileNotFoundError("gcloud")
    monkeypatch.setattr(subprocess, "run", missing)
    assert art._gcloud_project_id() is None


@pytest.mark.parametrize("prompt", [HAPPY, SAD, "a plain prompt"],
                         ids=["happy", "sad", "default"])
def test_procedural_pixels_match_reference(tmp_path, prompt):
    """The port's PNG (written with zlib + struct) decodes, with Pillow, to
    the pixels of ame_tpu.creative.procedural.render's PNG."""
    Image = pytest.importorskip("PIL.Image")
    from ame_tpu.creative import procedural as ref_proc
    ref = ref_proc.render(prompt, str(tmp_path / "ref.png"))
    out = procedural.render(prompt, str(tmp_path / "port.png"))
    a = np.asarray(Image.open(out).convert("RGB"))
    b = np.asarray(Image.open(ref).convert("RGB"))
    assert a.shape == (procedural.SIZE, procedural.SIZE, 3)
    np.testing.assert_array_equal(a, b)


def test_procedural_png_is_valid_and_deterministic(tmp_path):
    """Decoded by the standard library alone: IHDR / IDAT / IEND with good
    CRCs, the same pixels as ``pixels``; the same prompt gives the same
    cover, a sad prompt a cooler one."""
    a = procedural.render(HAPPY, str(tmp_path / "a.png"))
    img, tags = _read_png(a)
    assert tags == [b"IHDR", b"IDAT", b"IEND"]
    np.testing.assert_array_equal(img, procedural.pixels(HAPPY))
    sad = procedural.pixels(SAD)
    assert np.abs(img.astype(int) - sad.astype(int)).mean() > 10
    assert img[..., 0].mean() > sad[..., 0].mean()


def test_write_png_small(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    p = str(tmp_path / "s.png")
    procedural.write_png(p, rgb)
    np.testing.assert_array_equal(_read_png(p)[0], rgb)


def test_procedural_is_opt_in(tmp_path, registry, monkeypatch):
    """Default: the procedural provider is not registered (the reference's
    degrade contract); AME_TPU_ART_PROVIDER=procedural activates it."""
    registry.available()
    assert "procedural" not in registry._providers
    monkeypatch.setenv("AME_TPU_ART_PROVIDER", "procedural")
    assert registry.available()
    assert registry._active == "procedural"
    out = registry.generate_cover_art("serene tranquil pastel artwork",
                                      str(tmp_path / "m.wav"))
    assert out.endswith("m_art.png") and os.path.getsize(out) > 10000

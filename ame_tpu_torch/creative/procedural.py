"""Procedural cover-art provider — deterministic generative art, no cloud.

Port of ``ame_tpu/creative/procedural.py``: the same pixels for the same
prompt (the prompt's sha256 seeds ``numpy.random.default_rng``; its mood
and style words select the palette). It is 1024² host work in numpy, as in
the reference. The PNG is written with the standard library (``zlib`` and
``struct``), so no imaging package is needed.

OPT-IN (reference parity keeps art unavailable when no cloud provider
exists): activate with AME_TPU_ART_PROVIDER=procedural, or
``creative.procedural.activate()``.
"""

from __future__ import annotations

import hashlib
import struct
import zlib

import numpy as np

SIZE = 1024

# palette anchors (dark -> mid -> bright) keyed by prompt words; the first
# matching row wins. Colors are this module's own voicing of the four mood
# families the Musicologist emits.
_PALETTES = [
    (("aggressive", "chaotic", "distorted", "anxious", "angry"),
     ((12, 6, 10), (156, 22, 36), (247, 188, 64))),
    (("melancholic", "somber", "sorrowful", "sad", "rainy"),
     ((8, 10, 24), (38, 66, 110), (158, 190, 214))),
    (("serene", "tranquil", "calm", "peaceful", "pastel"),
     ((18, 28, 26), (86, 148, 132), (230, 238, 212))),
    (("joyful", "vibrant", "euphoric", "happy", "sunny"),
     ((24, 10, 34), (224, 98, 40), (255, 224, 120))),
]
_DEFAULT = ((10, 12, 18), (96, 72, 128), (220, 210, 230))


def _palette_for(prompt: str):
    low = prompt.lower()
    for words, pal in _PALETTES:
        if any(w in low for w in words):
            return pal
    return _DEFAULT


def _field(rng: np.random.Generator, energetic: bool) -> np.ndarray:
    """Layered sinusoidal interference in [0, 1]: K rotated plaids whose
    frequency range tracks the prompt's energy."""
    ax = np.linspace(-1.0, 1.0, SIZE)
    X, Y = np.meshgrid(ax, ax)
    k = 6 if energetic else 4
    f_lo, f_hi = (3.0, 11.0) if energetic else (1.0, 4.5)
    t = np.zeros((SIZE, SIZE))
    for _ in range(k):
        th = rng.uniform(0, np.pi)
        f = rng.uniform(f_lo, f_hi)
        ph = rng.uniform(0, 2 * np.pi)
        u = X * np.cos(th) + Y * np.sin(th)
        # warp the coordinate with a slower wave: organic, not gridded
        w = 0.25 * np.sin(2 * np.pi * rng.uniform(0.3, 1.2)
                          * (X * np.sin(th) - Y * np.cos(th))
                          + rng.uniform(0, 2 * np.pi))
        t += np.sin(2 * np.pi * f * (u + w) + ph)
    t = t / k
    # radial focus: brighter structure toward a randomly offset center
    cx, cy = rng.uniform(-0.35, 0.35, 2)
    r = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
    t = t * (1.0 - 0.45 * r)
    t = (t - t.min()) / max(t.max() - t.min(), 1e-9)
    return t


def _colorize(t: np.ndarray, pal) -> np.ndarray:
    (c0, c1, c2) = [np.asarray(c, np.float32) for c in pal]
    lo = np.clip(t * 2.0, 0.0, 1.0)[..., None]
    hi = np.clip(t * 2.0 - 1.0, 0.0, 1.0)[..., None]
    img = c0 * (1 - lo) + c1 * lo
    img = img * (1 - hi) + c2 * hi
    return img


def pixels(prompt: str) -> np.ndarray:
    """The [SIZE, SIZE, 3] uint8 RGB cover for ``prompt``."""
    seed = int.from_bytes(
        hashlib.sha256(prompt.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    low = prompt.lower()
    energetic = any(w in low for w in
                    ("fast", "energetic", "aggressive", "chaotic",
                     "vibrant", "euphoric"))
    t = _field(rng, energetic)
    img = _colorize(t, _palette_for(prompt))
    # vignette + film grain finish
    ax = np.linspace(-1.0, 1.0, SIZE)
    X, Y = np.meshgrid(ax, ax)
    vig = 1.0 - 0.35 * np.clip(np.sqrt(X ** 2 + Y ** 2) - 0.6, 0, 1) ** 2
    img = img * vig[..., None]
    img = img + rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write [H, W, 3] uint8 as an 8-bit RGB PNG (no filtering, zlib)."""
    h, w, _ = rgb.shape
    rows = np.concatenate(  # filter type 0 before every scanline
        [np.zeros((h, 1), np.uint8),
         np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def render(prompt: str, out_path: str) -> str:
    """Render SIZE x SIZE album art for ``prompt`` to ``out_path``."""
    write_png(out_path, pixels(prompt))
    return out_path


def activate() -> None:
    from ame_tpu_torch.creative import art
    art.register_provider("procedural", render, activate=True)

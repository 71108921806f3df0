"""Typed configuration for the mastering graph (PyTorch port).

Port of ``ame_tpu/config.py`` (``MasterSettings``, ``from_dict``,
``structure_key`` and the reference constants). It is a jax-free copy: every
``ame_tpu.*`` import runs ``ame_tpu/__init__.py``, which imports jax, so the
port cannot share the module by import.

The reference's de-facto config contract is a stringly-typed settings dict
read with ``settings.get(key, default)`` everywhere: unknown keys are
ignored and missing keys defaulted. ``MasterSettings.from_dict`` accepts that
dict verbatim.

Two kinds of fields:
  * *structure* fields (bools / None-ness) decide which graph stages exist;
  * *parameter* fields (gains, thresholds, ratios, width, lufs target) are
    plain numbers that only change the stages' coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# Reference constants (audio_mastering_engine.py):
#   EQ bands: low shelf 250 Hz, peak 1 kHz, peak 4 kHz, high shelf 8 kHz (:278-281)
#   analog character shelves: 120 Hz low, 12 kHz high (:264-265)
#   multiband crossovers: 250 / 4000 Hz (:299)
#   limiter: ceiling 0.98, attack 5 ms, release 50 ms (:223)
#   loudnorm: TP=-1.5 dBTP, LRA=11 (:229)
#   chunk length: 30 s (:178)
BASS_SHELF_HZ = 250.0
MID_PEAK_HZ = 1000.0
PRESENCE_PEAK_HZ = 4000.0
TREBLE_SHELF_HZ = 8000.0
ANALOG_LOW_SHELF_HZ = 120.0
ANALOG_HIGH_SHELF_HZ = 12000.0
PEAK_Q = 1.41
MB_LOW_CROSSOVER_HZ = 250.0
MB_HIGH_CROSSOVER_HZ = 4000.0
LIMITER_CEILING = 0.98
LIMITER_ATTACK_MS = 5.0
LIMITER_RELEASE_MS = 50.0
LOUDNORM_TP_DB = -1.5
LOUDNORM_LRA = 11.0
COMPAT_CHUNK_SECONDS = 30.0
COMP_ATTACK_MS = 5.0   # pydub compress_dynamic_range defaults (N7)
COMP_RELEASE_MS = 50.0

# Quality-mode multiband compressor stage defaults
MB_ATTACK_MS = 5.0
MB_RELEASE_MS = 50.0
MB_RMS_MS = 5.0


@dataclasses.dataclass(frozen=True)
class MasterSettings:
    """Typed mastering settings. Defaults mirror the reference GUI defaults
    (mastering_gui.py:46-55)."""

    # -- dynamic parameters -------------------------------------------------
    analog_character: float = 0.0   # [0..100] %
    bass_boost: float = 0.0         # dB, low shelf 250 Hz
    mid_cut: float = 0.0            # dB, applied NEGATED at 1 kHz (quirk Q3)
    presence_boost: float = 0.0     # dB, peak 4 kHz
    treble_boost: float = 0.0       # dB, high shelf 8 kHz
    width: float = 1.0              # stereo width [0..2]
    lufs: float | None = -14.0      # target integrated LUFS; None => skip
    target_tp: float = LOUDNORM_TP_DB
    target_lra: float = LOUDNORM_LRA
    low_thresh: float = -25.0       # multiband compressor params
    low_ratio: float = 6.0
    mid_thresh: float = -20.0
    mid_ratio: float = 3.0
    high_thresh: float = -15.0
    high_ratio: float = 4.0

    # G-band quality multiband: ``mb_edges=None`` keeps the classic 3-band
    # stage at 250/4000 Hz with the low/mid/high params above.
    mb_edges: tuple | None = None        # structure: G-1 ascending Hz
    mb_thresholds: tuple | None = None   # length G
    mb_ratios: tuple | None = None       # length G

    # -- structure flags ----------------------------------------------------
    multiband: bool = False
    # 'compat' reproduces the reference chain's behavioral quirks;
    # 'quality' is the fixed, product-grade chain.
    mode: str = "quality"
    # emulate the reference's 30 s chunk state-resets (quirk Q6); only
    # meaningful in compat mode.
    compat_chunked: bool = False

    # -- sidecar / io -------------------------------------------------------
    # Output bit depth: 16 (reference parity), 24 (PCM) or 32 (float).
    bits: int = 16
    input_file: str | None = None
    output_file: str | None = None
    create_mp3: bool = True
    art_prompt: str = ""
    auto_generate_prompt: bool = False

    def __post_init__(self):
        # Coerce list-valued band fields to tuples so the frozen settings
        # stay hashable, and validate the G-band contract eagerly.
        for f in ("mb_edges", "mb_thresholds", "mb_ratios"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(float(e) for e in v))
        if self.mb_edges is not None:
            e = self.mb_edges
            if len(e) < 1 or list(e) != sorted(set(e)):
                raise ValueError(
                    f"mb_edges must be >=1 strictly ascending Hz, got {e}")
            # mb_edges implies the multiband stage
            object.__setattr__(self, "multiband", True)
            G = len(e) + 1
            for f in ("mb_thresholds", "mb_ratios"):
                v = getattr(self, f)
                if v is not None and len(v) != G:
                    raise ValueError(
                        f"{f} must have {G} entries (one per band), "
                        f"got {len(v)}")
        elif self.mb_thresholds is not None or self.mb_ratios is not None:
            raise ValueError("mb_thresholds/mb_ratios need mb_edges")

    @classmethod
    def from_dict(cls, settings: Mapping[str, Any]) -> "MasterSettings":
        """Accept the reference settings dict (unknown keys ignored)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in settings.items() if k in fields}
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    # Structure key: everything that changes which stages run.
    def structure_key(self) -> tuple:
        return (
            self.mode,
            self.compat_chunked,
            bool(self.multiband),
            self.analog_character > 0,
            self.width != 1.0,
            self.lufs is not None,
            self.mb_edges,
        )

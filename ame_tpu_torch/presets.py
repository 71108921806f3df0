"""EQ presets — the port's copy of ``ame_tpu/presets.py``.

The five preset names and their four EQ parameters are part of the public
API contract (reference audio_mastering_engine.py:32-38; consumed by the GUI
preset dropdown, mastering_gui.py:64, 165-168). The values are configuration
data, kept numerically identical so a preset produces the same master.
"""

EQ_PRESETS = {
    "Vocal Clarity": {
        "bass_boost": -1.0, "mid_cut": 2.0, "presence_boost": 2.5, "treble_boost": 1.0,
    },
    "Bass Punch": {
        "bass_boost": 2.5, "mid_cut": 1.0, "presence_boost": -1.0, "treble_boost": 0.5,
    },
    "Vintage Warmth": {
        "bass_boost": 1.5, "mid_cut": 0.0, "presence_boost": -1.5, "treble_boost": -2.0,
    },
    "Lo-Fi Haze": {
        "bass_boost": -2.0, "mid_cut": 3.0, "presence_boost": -2.0, "treble_boost": -4.0,
    },
    "EDM Kick & Highs": {
        "bass_boost": 2.0, "mid_cut": 4.0, "presence_boost": 1.0, "treble_boost": 3.0,
    },
}

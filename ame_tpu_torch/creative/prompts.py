"""Creative prompt synthesis from a Musicologist technical brief (a copy
of ``ame_tpu/creative/prompts.py``; the port imports nothing of
``ame_tpu``).

Functional parity with the reference Art Director (C15,
audio_mastering_engine.py:64-91): a style library keyed by the same four
axes — mood (the 4 classes of the mood CNN), brightness, density, tempo —
one random phrase per axis composed into a single art prompt, with the same
quirky tempo-key extraction (split the human string "<n> BPM (fast)" on
spaces, keep alphabetic chars of the last token — quirk Q15) and the same
mood-only fallback on unknown keys. Phrase wording is this framework's own.
"""

from __future__ import annotations

import logging
import random

log = logging.getLogger("ame_tpu_torch.creative")

PROMPT_LIBRARY = {
    "mood": {
        "Happy/Excited": [
            "exuberant splash-color abstraction",
            "sun-drenched pop surrealism",
            "kinetic festival-poster art",
            "bright geometric celebration",
        ],
        "Calm/Content": [
            "quiet watercolor horizon study",
            "airy pastel minimalism",
            "misty morning large-format photography",
            "slow-breathing gradient field",
        ],
        "Angry/Anxious": [
            "jagged brutalist collage",
            "storm-lit expressionist canvas",
            "harsh neon-noir cityscape",
            "fractured glitch composition",
        ],
        "Sad/Depressed": [
            "rain-streaked window realism",
            "faded sepia portraiture",
            "lonely wide-shot cinematography",
            "ink-wash elegy",
        ],
    },
    "brightness": {
        "bright": [
            "flooded with white-gold light",
            "hard crystalline highlights",
            "a blazing high-key palette",
        ],
        "warm": [
            "amber late-afternoon glow",
            "honeyed mid-tones",
            "a soft tungsten warmth",
        ],
        "dark": [
            "ink-deep shadow pools",
            "a brooding low-key palette",
            "charcoal gloom with one light source",
        ],
    },
    "density": {
        "dense": [
            "an overgrown maximalist composition",
            "layers stacked on interlocking layers",
            "a wall of intricate detail",
        ],
        "moderate": [
            "a composed, well-weighted arrangement",
            "balanced figure and ground",
        ],
        "sparse": [
            "vast negative space around a lone subject",
            "a single mark on an empty field",
            "austere openness",
        ],
    },
    "tempo": {
        "fast": [
            "streaking long-exposure light trails",
            "furious gestural strokes",
            "motion tearing at the frame edges",
        ],
        "moderate": [
            "an even, walking-pace rhythm",
            "unhurried directional flow",
        ],
        "slow": [
            "heavy stillness",
            "geological patience",
            "a suspended, held-breath moment",
        ],
    },
}


def generate_creative_prompt(tech_brief: dict,
                             rng: random.Random | None = None) -> str:
    """Compose the art prompt; mood-only fallback on any failure
    (engine:86-91 contract)."""
    pick = (rng or random).choice
    log.info("building creative prompt from brief: %s", tech_brief)
    try:
        mood_key = str(tech_brief["mood"])
        raw_tempo_key = tech_brief["tempo"].split(" ")[-1]
        tempo_key = "".join(filter(str.isalpha, raw_tempo_key))  # Q15

        mood_style = pick(PROMPT_LIBRARY["mood"][mood_key])
        brightness_desc = pick(PROMPT_LIBRARY["brightness"][tech_brief["brightness"]])
        density_desc = pick(PROMPT_LIBRARY["density"][tech_brief["density"]])
        tempo_desc = pick(PROMPT_LIBRARY["tempo"][tempo_key])
        prompt = (f"An award-winning piece of {mood_style}, "
                  f"{brightness_desc}, featuring {density_desc} "
                  f"and {tempo_desc}.")
        log.info("creative prompt: %r", prompt)
        return prompt
    except Exception:
        log.exception("prompt synthesis failed; falling back to mood-only")
        return (f"An artistic representation of the mood: "
                f"{tech_brief.get('mood', 'unknown')}, detailed, "
                f"vibrant colors.")

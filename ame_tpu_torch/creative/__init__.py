"""Art Director: prompt synthesis from a Musicologist brief and pluggable
cover-art providers (port of ``ame_tpu/creative``; reference C15/C16,
audio_mastering_engine.py:40-91, 151-170)."""

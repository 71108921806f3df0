"""Creative prompt synthesis from a Musicologist brief (port of
``ame_tpu/creative``; art generation is not ported yet)."""

"""Plain references, one a configuration (``reference/<config>.py``):
numpy and scipy only, nothing of the program, of ``ame_tpu`` or of JAX."""

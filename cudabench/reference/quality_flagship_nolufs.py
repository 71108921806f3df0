"""Reference of the ``quality_flagship_nolufs`` configuration: the quality
chain of ``reference/quality.py`` at its settings (no loudness stage)."""

from cudabench.reference.quality import master  # noqa: F401

# The check's limit on the widest gap, in LSB, between a master the program
# wrote and the reference's (PERF.md gives the readings it was set from).
LIMITS = {"max_lsb": 6}

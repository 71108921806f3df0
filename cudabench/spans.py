"""Host spans of a traced run: thin wrappers around the program's own
functions at the layer boundaries that ``api.master_file`` and
``api.master_array`` import at call time.

  decode  ``ame_tpu_torch.io.read_audio``
  write   ``ame_tpu_torch.io.write_audio``
  chain   ``ame_tpu_torch.graph.chain.master_graph`` (the staged chain:
          its launches and the host reads inside it)

Each span is (name, call index, start, end) on ``time.perf_counter`` and
is also a ``torch.profiler.record_function`` range ``bench.<name>``, so
that the device trace can tell what the host was doing in a gap.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch

TARGETS = (("decode", "ame_tpu_torch.io", "read_audio"),
           ("write", "ame_tpu_torch.io", "write_audio"),
           ("chain", "ame_tpu_torch.graph.chain", "master_graph"))


class Spans:
    def __init__(self):
        self.records: list[tuple[str, int, float, float]] = []
        self.call = -1

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bench." + name):
                yield
        finally:
            self.records.append((name, self.call, t0, time.perf_counter()))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    @contextlib.contextmanager
    def installed(self):
        """The wrappers in place of the program's functions, restored on
        exit."""
        saved = []
        try:
            for name, module, attr in TARGETS:
                mod = importlib.import_module(module)
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

"""Where the masters go: a FIFO under the run's temporary directory,
drained by one harness thread, so that no master reaches the disk.

The program opens the FIFO as its output file (``write_wav`` opens the
path with ``"wb"`` and writes the header and the payload), the thread reads
it to end of file and keeps the bytes only of the tracks that the check
compares, each in a slot allocated and touched at set-up, so that the
harness allocates nothing while the window runs. One call at a time:
``expect`` before the call, ``collect`` after it returns.
"""

from __future__ import annotations

import errno
import fcntl
import os
import queue
import threading

import numpy as np

_CHUNK = 1 << 20
# The pipe's buffer, the largest the kernel grants: a master that fits
# goes into it as into a file's page cache, without waiting on the reader.
_PIPE_SIZES = (64 << 20, 16 << 20, 4 << 20, _CHUNK)


def _slot(size: int) -> memoryview:
    buf = bytearray(size)
    np.frombuffer(buf, np.uint8)[::4096] = 0     # fault every page in now
    return memoryview(buf)


class FifoSink:
    def __init__(self, directory: str, slot_bytes: int = 0, slots: int = 0,
                 name: str = "master.wav"):
        self.path = os.path.join(directory, name)
        os.mkfifo(self.path)
        self._slots = [_slot(slot_bytes) for _ in range(slots)]
        self.pipe_bytes = 0           # the pipe buffer the kernel granted
        self._requests: queue.Queue = queue.Queue()
        self._results: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="fifo-sink")
        self._thread.start()

    def _drain(self) -> None:
        scratch = memoryview(bytearray(_CHUNK))
        while True:
            slot = self._requests.get()
            if slot is False:
                return
            try:
                fd = os.open(self.path, os.O_RDONLY)
                for size in _PIPE_SIZES:
                    try:
                        self.pipe_bytes = fcntl.fcntl(
                            fd, fcntl.F_SETPIPE_SZ, size)
                        break
                    except OSError:
                        continue
                out = self._slots[slot] if slot is not None else scratch[:0]
                total = overflow = 0
                while True:
                    room = out[total:] if total < len(out) else scratch
                    n = os.readv(fd, [room])
                    if n == 0:
                        break
                    if total < len(out):
                        total += n
                    else:
                        overflow += n
                os.close(fd)
                if slot is None:
                    self._results.put(total + overflow)
                else:          # a master larger than its slot: unreadable
                    self._results.put(out[:0] if overflow else out[:total])
            except OSError as e:          # reported to the waiting caller
                self._results.put(e)

    def expect(self, slot: int | None) -> None:
        """The next writer's bytes go into slot ``slot``, or are only
        counted (``None``)."""
        self._requests.put(slot)

    def release(self) -> None:
        """After a call that failed: end the read if no writer came."""
        try:
            fd = os.open(self.path, os.O_WRONLY | os.O_NONBLOCK)
        except OSError as e:
            if e.errno != errno.ENXIO:    # ENXIO: the reader is not open
                raise
            return
        os.close(fd)

    def collect(self, timeout: float = 60.0):
        """A view of the kept bytes in their slot, or the byte count, of
        the last expected track."""
        out = self._results.get(timeout=timeout)
        if isinstance(out, OSError):
            raise out
        return out

    def close(self) -> None:
        self._requests.put(False)
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            raise RuntimeError("the FIFO reader did not stop")
        os.unlink(self.path)

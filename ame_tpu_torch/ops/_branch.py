"""Data-dependent branches that stay on the device: the port's counterpart
of ``lax.cond``.

``device_if(pred, body)`` runs ``body`` where the 0-d tensor ``pred`` is
true. While the current CUDA stream is capturing a graph it records a CUDA
conditional (IF) node around ``body`` (``csrc/graph_if.cu``, CUDA 12.4 and
later): a one-thread kernel reads ``pred`` at every replay and sets the
node's condition, and the body is captured from a stream of its own into
the node's body graph. The card decides; the host reads nothing. Otherwise
(eager on the card, and on the CPU) it reads ``pred`` once and runs
``body`` or not. ``device_if_else`` adds an else branch as a second IF node
on ``~pred``, computed before either node.

Bodies write in place: into tensors that exist before the node (``copy_``,
``out=``, indexed assignment), never by rebinding a name that the code after
the node reads. Under capture a body that does not run leaves those tensors
as they were, and a tensor a body allocates is only valid inside it. The
caller routes the bodies' allocations to a memory pool of the graph's
(``graph.chain._Fused``): the caching allocator sends only the capturing
stream's own allocations to the graph's pool.

``warm_all_branches()`` makes every branch run eagerly, whatever its
predicate, on the streams its body would be captured from, so that a
warm-up reaches every table, library, kernel and per-stream workspace a
later capture may record. ``holding()`` collects, while a graph is being
captured, the device tables that kernel wrappers take from caches outside
the graph (``hold``), so that the graph can keep them alive after the
caches drop them. Both, and the nesting depth of IF bodies, are state of
the calling thread: a server's workers mastering eagerly are not touched
by a capture on another thread. One thread at a time captures on a device,
since the body streams of a device are shared: ``graph.chain``'s lock per
device enforces it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch


class _State(threading.local):
    warm_all = False
    held: list | None = None
    depth = 0                # IF bodies open around the current code


_state = _State()
_body_streams: dict = {}     # (device, depth) -> the stream bodies run on
_streams_lock = threading.Lock()


def _capturing(pred: torch.Tensor) -> bool:
    return pred.is_cuda and torch.cuda.is_current_stream_capturing()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ame_tpu_torch.ops import _build
    lib = ctypes.CDLL(str(_build.build("graph_if")["path"]))
    lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
    lib.graph_if_end.argtypes = [ctypes.c_void_p]
    lib.graph_if_stream.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    for fn in (lib.graph_if_load, lib.graph_if_begin, lib.graph_if_end,
               lib.graph_if_stream):
        fn.restype = ctypes.c_int
    lib.graph_if_error.argtypes = [ctypes.c_int]
    lib.graph_if_error.restype = ctypes.c_char_p
    _check(lib, "graph_if_load", lib.graph_if_load())
    return lib


def _check(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.graph_if_error(err).decode()})")


def new_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking stream of the caller's own on ``device``, created by
    ``graph_if_stream``: never one of torch's pooled streams, which
    ``torch.cuda.Stream()`` hands out again to any thread that asks."""
    lib = _lib()
    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        _check(lib, "graph_if_stream",
               lib.graph_if_stream(ctypes.byref(handle)))
    return torch.cuda.ExternalStream(handle.value, device=device)


def _body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """The stream IF bodies at the current depth run on, created once (a
    capture's own stream cannot be a body's)."""
    key = (device, _state.depth)
    with _streams_lock:
        if key not in _body_streams:
            _body_streams[key] = new_stream(device)
        return _body_streams[key]


@contextlib.contextmanager
def _in_body(device: torch.device):
    """The body's code runs on its depth's stream, one level deeper."""
    stream = _body_stream(device)
    _state.depth += 1
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        _state.depth -= 1


def _if_node(pred: torch.Tensor, body) -> None:
    lib = _lib()
    pred = pred.to(torch.bool)
    outer = torch.cuda.current_stream(pred.device)
    with _in_body(pred.device) as stream:
        _check(lib, "graph_if_begin", lib.graph_if_begin(
            outer.cuda_stream, pred.data_ptr(), stream.cuda_stream))
        try:
            body()
        finally:
            _check(lib, "graph_if_end", lib.graph_if_end(stream.cuda_stream))


def _warm(pred: torch.Tensor, body) -> None:
    if not pred.is_cuda:
        body()
        return
    outer = torch.cuda.current_stream(pred.device)
    with _in_body(pred.device) as stream:
        stream.wait_stream(outer)
        body()
    outer.wait_stream(stream)


def device_if(pred: torch.Tensor, body) -> bool:
    """Run ``body()`` where the 0-d ``pred`` holds. Returns whether the body
    ran (eager) or may run (captured: True)."""
    if _capturing(pred):
        _if_node(pred, body)
        return True
    if _state.warm_all:
        _warm(pred, body)
        return True
    if bool(pred):                       # the branch's one host read
        body()
        return True
    return False


def device_if_else(pred: torch.Tensor, body, other) -> None:
    """``body()`` where ``pred`` holds, else ``other()``: one host read
    eagerly, two IF nodes (``pred``, ``~pred``) under capture."""
    if _capturing(pred):
        pred = pred.to(torch.bool)
        npred = torch.logical_not(pred)
        _if_node(pred, body)
        _if_node(npred, other)
    elif _state.warm_all:
        _warm(pred, body)
        _warm(pred, other)
    elif bool(pred):
        body()
    else:
        other()


@contextlib.contextmanager
def warm_all_branches():
    """Every ``device_if`` / ``device_if_else`` runs all its bodies while
    this is open (eager only: a warm-up, its results discarded)."""
    _state.warm_all = True
    try:
        yield
    finally:
        _state.warm_all = False


def hold(t: torch.Tensor) -> torch.Tensor:
    """Return ``t``; while ``holding()`` is open, also keep a reference."""
    if _state.held is not None:
        _state.held.append(t)
    return t


@contextlib.contextmanager
def holding():
    """Collect what ``hold`` sees; yields the list."""
    _state.held = []
    try:
        yield _state.held
    finally:
        _state.held = None

"""Headless GUI controller: every behaviour of the desktop app that is not
literally a Tk widget (reference C18, mastering_gui.py:108-137, 175-194).

The port's own copy of ``ame_tpu/gui_logic.py``, the same behaviour. The Tk
layer (``ame_tpu_torch/gui.py``) is a thin view; this module owns the logic
the reference buried inside widget callbacks and that its v5.6-era bugs
lived in (quirk Q12 cross-thread widget mutation, quirk Q13 status-prefix
parsing):

  * settings-dict construction for ``api.process_audio`` — the exact
    key contract (mastering_gui.py:175-194) plus ``shard_time``;
  * preset application ("None" zeroes the four EQ keys; named presets
    write their values through — mastering_gui.py:67-74);
  * the worker-thread event queue + pump: worker callbacks only enqueue,
    the UI thread drains (the Q12 fix);
  * the Q13 status-prefix contract: "Success:"/"Error:"/"Failed:"
    terminate the busy state, "Success:" also raises the done dialog;
  * reference-match (automaster) fitted-settings application.

Driven by any object implementing the small ``view`` surface below —
the Tk app in production, a plain recorder in tests — so the
start → callbacks → completion flow is testable headless. The worker
functions it runs (``api.process_audio``, ``gui._fit_files``) choose the
device; the controller itself is pure Python.

View surface (duck-typed):
    set_status(text)               set_progress(value, maximum)
    set_tag(text)                  show_art(path)
    set_busy(bool)                 set_match_busy(bool)
    show_info(title, message)      show_error(title, message)
    set_value(key, value)          enable_multiband()
"""

from __future__ import annotations

import os
import queue
import threading

#: keys _apply_preset("None") resets (mastering_gui.py:67-70)
PRESET_EQ_KEYS = ("bass_boost", "mid_cut", "presence_boost", "treble_boost")

#: substrings that end the busy state (quirk Q13 — the reference GUI
#: greps the status text for these; mastering_gui.py:108-118)
TERMINAL_MARKERS = ("Success:", "Error:", "Failed:")


def suggest_output_path(input_path: str) -> str:
    """``<dir>/<stem>_mastered.wav`` next to the input
    (mastering_gui.py:86-90)."""
    d, base = os.path.split(input_path)
    stem = os.path.splitext(base)[0]
    return os.path.join(d, f"{stem}_mastered.wav")


def build_settings(slider_values: dict, *, input_file: str,
                   output_file: str, multiband: bool, art_prompt: str,
                   auto_generate_prompt: bool, create_mp3: bool,
                   shard_time: bool = False) -> dict:
    """The ``process_audio`` settings dict, exactly the reference's key
    contract (mastering_gui.py:175-194) plus the shard_time extension."""
    settings = dict(slider_values)
    settings.update({
        "input_file": input_file,
        "output_file": output_file,
        "multiband": multiband,
        "art_prompt": art_prompt,
        "auto_generate_prompt": auto_generate_prompt,
        "create_mp3": create_mp3,
        "shard_time": shard_time,
    })
    return settings


def preset_updates(name: str, presets: dict | None = None) -> dict:
    """Slider writes for selecting ``name`` from the preset menu:
    "None" zeroes the four EQ keys; otherwise the preset's values pass
    through (mastering_gui.py:67-74). ``presets`` defaults to
    ``ame_tpu_torch.presets.EQ_PRESETS``. Unknown names behave like an
    empty preset (the reference indexes blindly; we degrade)."""
    if name == "None":
        return {key: 0 for key in PRESET_EQ_KEYS}
    if presets is None:
        from ame_tpu_torch.presets import EQ_PRESETS as presets
    return dict(presets.get(name, {}))


class GuiController:
    """The app's behavior, minus the widgets.

    Worker callbacks enqueue onto ``self.events``; the UI thread calls
    :meth:`drain` periodically (the Tk app does so from an ``after()``
    pump). Nothing here ever touches the view from a worker thread.
    """

    def __init__(self, view):
        self.view = view
        self.events: "queue.Queue[tuple]" = queue.Queue()
        self.busy = False

    # -- callbacks handed to the worker (enqueue only — quirk Q12 fix) ----
    def callbacks(self):
        """(status_cb, progress_cb, art_cb, tag_cb) for process_audio —
        the 4-callback contract of api.process_audio
        (audio_mastering_engine.py:94-137)."""
        put = self.events.put
        return (lambda m: put(("status", m)),
                lambda c, t: put(("progress", (c, t))),
                lambda p: put(("art", p)),
                lambda m: put(("tag", m)))

    # -- start ------------------------------------------------------------
    def start(self, settings: dict, process_fn, *, thread: bool = True):
        """Validate, flip to busy, run ``process_fn(settings, *callbacks)``
        on a worker thread. Returns the Thread (or None when validation
        fails; ``thread=False`` runs inline for tests)."""
        if not settings.get("input_file") or not settings.get("output_file"):
            self.view.show_error(
                "Error", "Please select both an input and an output file.")
            return None
        self.busy = True
        self.view.set_busy(True)
        self.view.set_progress(0, None)
        args = (settings,) + self.callbacks()
        if not thread:
            process_fn(*args)
            return None
        worker = threading.Thread(target=process_fn, args=args, daemon=True)
        worker.start()
        return worker

    # -- reference match ----------------------------------------------------
    def start_match(self, input_file: str, reference_file: str,
                    fit_multiband: bool, fit_fn, *, thread: bool = True):
        """Fit settings to a reference track on a worker thread
        (models/automaster.py); results arrive through the same event
        queue. ``fit_fn(src, ref, fit_multiband) -> fitted dict``."""
        self.view.set_match_busy(True)
        put = self.events.put

        def work():
            try:
                put(("status", "Fitting settings to the reference..."))
                fitted = fit_fn(input_file, reference_file, fit_multiband)
                put(("fitted", fitted))
                put(("status", f"Success: matched reference "
                               f"(loss {fitted['loss']:.2f})."))
            except Exception as e:  # noqa: BLE001 — surfaced as status
                put(("fitted", None))
                put(("status", f"Error: reference match failed: {e}"))

        if not thread:
            work()
            return None
        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        return worker

    # -- the pump -----------------------------------------------------------
    def drain(self):
        """One pump tick: dispatch every queued event to the view. Safe to
        call from the UI thread only. Returns the number of events
        handled (lets tests pump until quiescent)."""
        n = 0
        try:
            while True:
                kind, payload = self.events.get_nowait()
                n += 1
                if kind == "status":
                    self.handle_status(payload)
                elif kind == "progress":
                    cur, total = payload
                    if total > 0:
                        self.view.set_progress(cur, total)
                elif kind == "tag":
                    self.view.set_tag(f"Studio Notes: {payload}")
                elif kind == "art":
                    self.view.show_art(payload)
                elif kind == "fitted":
                    self.apply_fitted(payload)
        except queue.Empty:
            pass
        return n

    def handle_status(self, message: str):
        """Show the status; apply the Q13 prefix contract
        (mastering_gui.py:108-118): any terminal marker ends the busy
        state, "Success:" additionally raises the done dialog."""
        self.view.set_status(message)
        if any(marker in message for marker in TERMINAL_MARKERS):
            self.busy = False
            self.view.set_busy(False)
            if "Success:" in message:
                self.view.show_info("Success",
                                    "Your audio has been mastered.")

    # -- preset / fitted application -----------------------------------------
    def apply_preset(self, name: str, presets: dict | None = None):
        for key, value in preset_updates(name, presets).items():
            self.view.set_value(key, value)
        if name != "None":
            self.handle_status(f"Loaded '{name}' preset.")

    def apply_fitted(self, fitted):
        """Load automaster-fitted values into the sliders (rounded for
        display); enable multiband when the fit used it."""
        self.view.set_match_busy(False)
        if not fitted:
            return
        for key, value in fitted.items():
            if key in ("loss", "multiband"):
                continue
            self.view.set_value(key, round(float(value), 2))
        if fitted.get("multiband"):
            self.view.enable_multiband()

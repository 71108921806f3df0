"""The port's desktop-GUI logic (ame_tpu_torch.gui_logic, and gui.py's
wiring) against ame_tpu's on the same scripts: the same status, tag,
progress, busy and dialog sequences, headless through a recorder view
(tests/test_gui_logic.py and tests/test_presets_gui.py's contracts)."""

import inspect
import threading
import time

import numpy as np
import pytest

import ame_tpu.gui_logic as ref_logic
import ame_tpu_torch.gui_logic as port_logic
from ame_tpu_torch import gui
from ame_tpu_torch.io import wav as W
from ame_tpu_torch.presets import EQ_PRESETS
from tests.conftest import make_test_signal

SR = 44100


class FakeView:
    """Records every controller -> view call, in order."""

    def __init__(self):
        self.calls = []
        self.values = {}
        self.busy = None
        self.match_busy = None
        self.multiband = False

    def set_status(self, text):
        self.calls.append(("status", text))

    def set_progress(self, value, maximum):
        self.calls.append(("progress", value, maximum))

    def set_tag(self, text):
        self.calls.append(("tag", text))

    def show_art(self, path):
        self.calls.append(("art", path))

    def set_busy(self, busy):
        self.busy = busy
        self.calls.append(("busy", busy))

    def set_match_busy(self, busy):
        self.match_busy = busy
        self.calls.append(("match_busy", busy))

    def show_info(self, title, message):
        self.calls.append(("info", title, message))

    def show_error(self, title, message):
        self.calls.append(("error", title, message))

    def set_value(self, key, value):
        self.values[key] = value
        self.calls.append(("value", key, value))

    def enable_multiband(self):
        self.multiband = True
        self.calls.append(("multiband_on",))


def _settings(mod, **over):
    base = dict(input_file="in.wav", output_file="out.wav",
                multiband=False, art_prompt="", auto_generate_prompt=False,
                create_mp3=True)
    base.update(over)
    return mod.build_settings({"bass_boost": 2.0, "lufs": -14.0}, **base)


def _both(script):
    """Run script(mod, controller, view) against ame_tpu's controller and
    the port's; the port's view, after asserting both views recorded the
    same calls and values."""
    views = []
    for mod in (ref_logic, port_logic):
        view = FakeView()
        script(mod, mod.GuiController(view), view)
        views.append(view)
    ref, port = views
    assert port.calls == ref.calls
    assert port.values == ref.values
    assert (port.busy, port.match_busy, port.multiband) == (
        ref.busy, ref.match_busy, ref.multiband)
    return port


def _statuses(view):
    return [c[1] for c in view.calls if c[0] == "status"]


# -- settings construction (mastering_gui.py:175-194) -------------------------

def test_build_settings_key_contract():
    s = _settings(port_logic)
    assert s == _settings(ref_logic)
    assert s["bass_boost"] == 2.0 and s["lufs"] == -14.0
    for key in ("input_file", "output_file", "multiband", "art_prompt",
                "auto_generate_prompt", "create_mp3", "shard_time"):
        assert key in s
    assert s["shard_time"] is False


def test_suggest_output_path():
    for p in ("/a/b/song.flac", "x.wav", "/d/e.f/g"):
        assert port_logic.suggest_output_path(p) == \
            ref_logic.suggest_output_path(p)
    assert port_logic.suggest_output_path("/a/b/song.flac") == \
        "/a/b/song_mastered.wav"


# -- presets (mastering_gui.py:67-74) -----------------------------------------

def test_preset_none_zeroes_eq():
    up = port_logic.preset_updates("None", EQ_PRESETS)
    assert up == ref_logic.preset_updates("None", EQ_PRESETS) == {
        "bass_boost": 0, "mid_cut": 0, "presence_boost": 0,
        "treble_boost": 0}


@pytest.mark.parametrize("name", list(EQ_PRESETS) + ["Unknown"])
def test_preset_updates_read_the_port_presets(name):
    """Without a table the port reads ame_tpu_torch.presets; every name
    gives ame_tpu's updates from ame_tpu's own table."""
    from ame_tpu.presets import EQ_PRESETS as REF_PRESETS
    assert port_logic.preset_updates(name) == \
        ref_logic.preset_updates(name, REF_PRESETS)


def test_preset_applies_values_and_status():
    name = next(iter(EQ_PRESETS))
    view = _both(lambda mod, ctl, view: ctl.apply_preset(name, EQ_PRESETS))
    for key, value in EQ_PRESETS[name].items():
        assert view.values[key] == value
    assert ("status", f"Loaded '{name}' preset.") in view.calls
    assert view.busy is None


# -- start validation ---------------------------------------------------------

def test_start_requires_both_files():
    def script(mod, ctl, view):
        assert ctl.start(_settings(mod, input_file=""), lambda *a: None) \
            is None
        assert ctl.start(_settings(mod, output_file=""), lambda *a: None) \
            is None
        assert not ctl.busy

    view = _both(script)
    assert [c for c in view.calls if c[0] == "error"] == [
        ("error", "Error",
         "Please select both an input and an output file.")] * 2
    assert view.busy is None


# -- the full start -> callbacks -> completion flow ---------------------------

def _fake_process(settings, status_cb, progress_cb, art_cb, tag_cb):
    """A worker following api.process_audio's callback contract
    (audio_mastering_engine.py:94-137 / Q13 prefixes)."""
    status_cb("Loading audio file...")
    progress_cb(0, 4)
    for i in range(1, 5):
        progress_cb(i, 4)
    tag_cb("Energetic | 124.0 BPM")
    art_cb("/tmp/cover.png")
    status_cb("Success: saved to " + settings["output_file"])


def test_start_to_completion_flow():
    def script(mod, ctl, view):
        ctl.start(_settings(mod), _fake_process, thread=False)
        assert view.busy is True and ctl.busy
        ctl.drain()
        assert not ctl.busy

    view = _both(script)
    assert view.busy is False
    assert ("info", "Success", "Your audio has been mastered.") in view.calls
    assert ("progress", 0, None) == next(
        c for c in view.calls if c[0] == "progress")
    assert ("progress", 4, 4) in view.calls
    assert ("tag", "Studio Notes: Energetic | 124.0 BPM") in view.calls
    assert ("art", "/tmp/cover.png") in view.calls
    statuses = _statuses(view)
    assert statuses[0] == "Loading audio file..."
    assert statuses[-1].startswith("Success:")


@pytest.mark.parametrize("terminal", ["Error: decode failed",
                                      "Failed: no output written"])
def test_error_statuses_unbusy_without_dialog(terminal):
    def proc(settings, status_cb, *cbs):
        status_cb("Loading audio file...")
        status_cb(terminal)

    def script(mod, ctl, view):
        ctl.start(_settings(mod), proc, thread=False)
        ctl.drain()
        assert not ctl.busy

    view = _both(script)
    assert view.busy is False
    assert not [c for c in view.calls if c[0] == "info"]


def test_nonterminal_status_keeps_busy():
    def proc(settings, status_cb, *cbs):
        status_cb("Applying mastering chain...")

    def script(mod, ctl, view):
        ctl.start(_settings(mod), proc, thread=False)
        ctl.drain()
        assert ctl.busy

    assert _both(script).busy is True


def test_zero_total_progress_ignored():
    def proc(settings, status_cb, progress_cb, *cbs):
        progress_cb(1, 0)  # the reference guards total > 0

    def script(mod, ctl, view):
        ctl.start(_settings(mod), proc, thread=False)
        ctl.drain()

    view = _both(script)
    assert [c for c in view.calls if c[0] == "progress"] == [
        ("progress", 0, None)]


def _pump(ctl, view, done, timeout=10.0):
    """Drain like the Tk after() loop until done(view) or the timeout."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ctl.drain()
        if done(view):
            return
        time.sleep(0.01)


def test_pump_from_real_worker_thread():
    """Quirk Q12: callbacks fire on a worker thread; the view is only ever
    touched from drain() on the caller's thread."""
    ui_thread = threading.get_ident()
    touched_from = []

    class ThreadCheckView(FakeView):
        def __getattribute__(self, name):
            if name.startswith(("set_", "show_", "enable_")):
                touched_from.append(threading.get_ident())
            return super().__getattribute__(name)

    for mod in (ref_logic, port_logic):
        view = ThreadCheckView()
        ctl = mod.GuiController(view)
        worker = ctl.start(_settings(mod), _fake_process)
        worker.join(10)
        assert not worker.is_alive()
        _pump(ctl, view, lambda v: v.busy is False)
        assert view.busy is False
        assert _statuses(view)[-1].startswith("Success:")
    assert set(touched_from) == {ui_thread}


# -- reference match (Match Reference... button) ------------------------------

def test_match_flow_applies_fitted_and_unbusies():
    def fit(src, ref, fit_mb):
        assert (src, ref, fit_mb) == ("in.wav", "ref.wav", True)
        return {"bass_boost": 1.23456, "width": 1.4, "multiband": True,
                "loss": 0.42}

    def script(mod, ctl, view):
        ctl.start_match("in.wav", "ref.wav", True, fit, thread=False)
        assert view.match_busy is True
        ctl.drain()

    view = _both(script)
    assert view.match_busy is False
    assert view.values == {"bass_boost": 1.23, "width": 1.4}
    assert view.multiband is True
    assert _statuses(view)[-1] == "Success: matched reference (loss 0.42)."


def test_match_failure_reports_error_status():
    def fit(src, ref, fit_mb):
        raise RuntimeError("unreadable file")

    def script(mod, ctl, view):
        ctl.start_match("in.wav", "ref.wav", False, fit, thread=False)
        ctl.drain()

    view = _both(script)
    assert view.match_busy is False
    assert _statuses(view)[-1] == \
        "Error: reference match failed: unreadable file"
    assert view.values == {}


# -- the Tk app delegates to the controller -----------------------------------

def test_tk_app_wires_controller():
    """gui.MasteringApp delegates to GuiController and starts the port's
    process_audio and _fit_files with its device (checked structurally:
    there is no display here)."""
    src = inspect.getsource(gui.MasteringApp)
    assert "GuiController(self)" in src
    assert "self.controller.start(" in src
    assert "self.controller.start_match(" in src
    assert "self.controller.drain()" in src
    assert "self.controller.apply_preset(" in src
    assert "from ame_tpu_torch.api import process_audio" in src
    assert "device=self.device" in src
    assert "MasteringApp(device)" in inspect.getsource(gui.run_gui)
    for meth in ("set_status", "set_progress", "set_tag", "show_art",
                 "set_busy", "set_match_busy", "show_info", "show_error",
                 "set_value", "enable_multiband"):
        assert hasattr(gui.MasteringApp, meth), meth
    assert gui.GuiController is port_logic.GuiController


def test_gui_slider_schema_matches_reference():
    """tests/test_presets_gui.py's slider keys, ranges and defaults, equal
    to ame_tpu.gui's tables."""
    from ame_tpu import gui as ref_gui
    assert gui.MAIN_SLIDERS == ref_gui.MAIN_SLIDERS
    assert gui.MB_SLIDERS == ref_gui.MB_SLIDERS
    main = {key: (lo, hi, d) for (_, key, lo, hi, d) in gui.MAIN_SLIDERS}
    assert main["analog_character"] == (0, 100, 0.0)
    assert main["bass_boost"] == (-6, 6, 0.0)
    assert main["width"] == (0, 2, 1.0)
    assert main["lufs"] == (-20, -6, -14.0)
    mb = {key: (lo, hi, d) for (_, key, lo, hi, d) in gui.MB_SLIDERS}
    assert mb["low_thresh"] == (-40, 0, -25.0)
    assert mb["high_ratio"] == (1, 10, 4.0)


def test_fit_files_raises_without_card(tmp_path):
    """The match worker runs on the card by default: with no card it
    raises, and the controller reports the Error: status."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", 4096, SR) * 0.2, SR)
    with pytest.raises(RuntimeError, match="CUDA"):
        gui._fit_files(src, src, False)
    view = FakeView()
    ctl = port_logic.GuiController(view)
    ctl.start_match(src, src, False, gui._fit_files, thread=False)
    ctl.drain()
    assert _statuses(view)[-1].startswith("Error: reference match failed")
    assert view.match_busy is False


def test_real_process_flow_matches_reference(tmp_path, monkeypatch):
    """One real job through the controller on a worker thread: the port's
    process_audio on the CPU and ame_tpu's on the same 2^16-sample WAV
    give the same view sequence (statuses, progress, tag, art, busy, the
    done dialog); the two masters within 1 LSB."""
    import functools
    from ame_tpu.api import process_audio as ref_process_audio
    from ame_tpu.creative import art as ref_art
    from ame_tpu_torch.api import process_audio
    from ame_tpu_torch.creative import art
    for mod in (art, ref_art):
        monkeypatch.setattr(mod, "_try_register_vertex", lambda: None)
        monkeypatch.setattr(mod, "_providers", {})
        monkeypatch.setattr(mod, "_active", None)
    monkeypatch.delenv("AME_TPU_ART_PROVIDER", raising=False)
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", 1 << 16, SR) * 0.3, SR)
    sliders = {key: default for _, key, _, _, default in
               gui.MAIN_SLIDERS + gui.MB_SLIDERS}
    sliders.update(analog_character=20.0, bass_boost=2.0,
                   presence_boost=1.5, width=1.2)
    views = []
    for mod, fn, out in (
            (ref_logic, ref_process_audio, "r.wav"),
            (port_logic, functools.partial(process_audio, device="cpu"),
             "p.wav")):
        view = FakeView()
        ctl = mod.GuiController(view)
        settings = mod.build_settings(
            sliders, input_file=src, output_file=str(tmp_path / out),
            multiband=False, art_prompt="", auto_generate_prompt=False,
            create_mp3=False)
        ctl.start(settings, fn).join(300)
        _pump(ctl, view, lambda v: v.busy is False)
        assert not ctl.busy
        views.append(view)
    ref, port = views
    assert port.calls == ref.calls
    assert _statuses(port)[-1] == \
        "Success: Processing complete! (No art generated)"
    assert ("info", "Success", "Your audio has been mastered.") in port.calls
    y, _ = W.read_wav(str(tmp_path / "p.wav"), prefer_int16=True)
    y_ref, _ = W.read_wav(str(tmp_path / "r.wav"), prefer_int16=True)
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 1


def test_shard_time_box_runs_the_sharded_chain(tmp_path, monkeypatch):
    """The "Distribute this track across all chips" box (shard_time) takes
    a GUI job through process_audio onto the time-sharded chain (the CPU
    pool: one device), with no degrade warning, to the done dialog."""
    import functools
    from ame_tpu_torch.api import process_audio
    from ame_tpu_torch.creative import art
    monkeypatch.setattr(art, "_try_register_vertex", lambda: None)
    monkeypatch.setattr(art, "_providers", {})
    monkeypatch.setattr(art, "_active", None)
    monkeypatch.delenv("AME_TPU_ART_PROVIDER", raising=False)
    src = str(tmp_path / "in.wav")
    W.write_wav(src, make_test_signal("noise", 1 << 15, SR) * 0.3, SR)
    view = FakeView()
    ctl = port_logic.GuiController(view)
    settings = port_logic.build_settings(
        {"bass_boost": 2.0, "lufs": -14.0}, input_file=src,
        output_file=str(tmp_path / "out.wav"), multiband=False,
        art_prompt="", auto_generate_prompt=False, create_mp3=False,
        shard_time=True)
    ctl.start(settings, functools.partial(process_audio,
                                          device="cpu")).join(300)
    _pump(ctl, view, lambda v: v.busy is False)
    statuses = _statuses(view)
    assert ("Running time-sharded mastering graph over 1 devices..."
            in statuses), statuses
    assert not any(s.startswith("Warning") for s in statuses), statuses
    assert statuses[-1] == "Success: Processing complete! (No art generated)"
    assert ("info", "Success", "Your audio has been mastered.") in view.calls

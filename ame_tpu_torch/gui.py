"""Desktop GUI (reference C18, mastering_gui.py), the port's Tk view.

Port of ``ame_tpu/gui.py``, the same capability set: file pickers with an
auto-suggested ``<name>_mastered.wav`` output, EQ preset dropdown, the 7
main sliders + 6 multiband sliders with live value labels, multiband
show/hide, art-prompt entry with auto-generate toggle, MP3 checkbox
(default on), progress bar, status line, Studio Notes tag line, cover-art
display, and Match Reference... (``_fit_files``).

Jobs run on the card unless the app is built with ``device="cpu"``:
Start Processing runs the port's ``api.process_audio`` and Match
Reference runs ``models/automaster.fit_settings`` on ``device``, each on a
worker thread whose callbacks only enqueue; an ``after()`` pump on the Tk
main loop drains them (the reference mutates widgets cross-thread, quirk
Q12). ttkthemes / PIL are optional: the GUI degrades to stock ttk and
skips image rendering without them, and the module imports without a
display or tkinter.

All behaviour lives in ``ame_tpu_torch/gui_logic.GuiController``
(headless); this module is the Tk rendering of its view surface.
"""

from __future__ import annotations

import functools

from ame_tpu_torch.gui_logic import (GuiController, build_settings,
                                     suggest_output_path)

try:
    import tkinter as tk
    from tkinter import ttk, filedialog, messagebox
except ImportError:  # pragma: no cover - headless build
    tk = None

try:
    from ttkthemes import ThemedTk as _Root
    _THEMED = True
except ImportError:
    _THEMED = False
    if tk is not None:
        _Root = tk.Tk

try:
    from PIL import Image, ImageTk
except ImportError:
    Image = None


def _fit_files(src: str, ref: str, fit_multiband: bool,
               device="cuda") -> dict:
    """Worker-side reference match: read both files, resample the
    reference to the source rate, fit settings (models/automaster.py, 120
    Adam steps as the reference uses) on ``device``. Called by
    GuiController.start_match on a worker thread."""
    import numpy as np
    import torch
    from ame_tpu_torch.device import resolve_device
    from ame_tpu_torch.io import force_stereo, read_audio
    from ame_tpu_torch.models.automaster import fit_settings
    from ame_tpu_torch.ops.resample import resample
    dev = resolve_device(device, "fit_settings")
    x, sr_x = read_audio(src)
    t, sr_t = read_audio(ref)
    x = torch.from_numpy(np.ascontiguousarray(force_stereo(x), np.float32))
    t = torch.from_numpy(np.ascontiguousarray(force_stereo(t), np.float32))
    x, t = x.to(dev), t.to(dev)
    if sr_t != sr_x:
        t = resample(t, sr_t, sr_x)
    return fit_settings(x, sr_x, t, steps=120,
                        optimize_multiband=fit_multiband, device=dev)


MAIN_SLIDERS = [
    ("Analog Character (%)", "analog_character", 0, 100, 0.0),
    ("Bass (dB)", "bass_boost", -6, 6, 0.0),
    ("Mid Cut (dB)", "mid_cut", 0, 6, 0.0),
    ("Presence (dB)", "presence_boost", -6, 6, 0.0),
    ("Treble (dB)", "treble_boost", -6, 6, 0.0),
    ("Stereo Width", "width", 0, 2, 1.0),
    ("Target LUFS", "lufs", -20, -6, -14.0),
]
MB_SLIDERS = [
    ("Low Thresh (dB)", "low_thresh", -40, 0, -25.0),
    ("Low Ratio", "low_ratio", 1, 10, 6.0),
    ("Mid Thresh (dB)", "mid_thresh", -40, 0, -20.0),
    ("Mid Ratio", "mid_ratio", 1, 10, 3.0),
    ("High Thresh (dB)", "high_thresh", -40, 0, -15.0),
    ("High Ratio", "high_ratio", 1, 10, 4.0),
]


class MasteringApp(_Root if tk else object):
    """Tk application. Construct then .mainloop()."""

    POLL_MS = 80

    def __init__(self, device="cuda"):
        if _THEMED:
            super().__init__(theme="equilux")
        else:
            super().__init__()
        self.title("ame_tpu_torch Mastering Studio")
        self.geometry("760x1020")
        self.device = device
        self.controller = GuiController(self)
        self._photo = None

        from ame_tpu_torch.presets import EQ_PRESETS
        self._presets = EQ_PRESETS

        outer = ttk.Frame(self, padding=16)
        outer.pack(fill=tk.BOTH, expand=True)
        outer.grid_columnconfigure(0, weight=1)
        row = 0

        # file pickers
        files = ttk.Frame(outer)
        files.grid(row=row, column=0, sticky="ew", pady=(0, 10)); row += 1
        files.grid_columnconfigure(1, weight=1)
        self.input_var = tk.StringVar()
        self.output_var = tk.StringVar()
        for r, (label, var, cmd) in enumerate((
                ("Input:", self.input_var, self._pick_input),
                ("Output:", self.output_var, self._pick_output))):
            ttk.Label(files, text=label, width=10).grid(row=r, column=0,
                                                        sticky="w")
            ttk.Entry(files, textvariable=var,
                      state="readonly").grid(row=r, column=1, sticky="ew",
                                             padx=4)
            ttk.Button(files, text="Browse...",
                       command=cmd).grid(row=r, column=2)

        # presets + automaster
        prow = ttk.Frame(outer)
        prow.grid(row=row, column=0, sticky="ew", pady=4); row += 1
        prow.grid_columnconfigure(0, weight=1)
        self.preset_var = tk.StringVar(value="None")
        preset_menu = ttk.OptionMenu(
            prow, self.preset_var, "None", "None", *self._presets,
            command=self._apply_preset)
        preset_menu.grid(row=0, column=0, sticky="ew")
        self.match_btn = ttk.Button(prow, text="Match Reference...",
                                    command=self._match_reference)
        self.match_btn.grid(row=0, column=1, padx=(8, 0))

        # sliders
        self.vars: dict[str, tk.DoubleVar] = {}
        params = ttk.Frame(outer)
        params.grid(row=row, column=0, sticky="ew", pady=6); row += 1
        params.grid_columnconfigure(1, weight=1)
        for r, (label, key, lo, hi, default) in enumerate(MAIN_SLIDERS):
            self._slider(params, r, label, key, lo, hi, default)

        self.multiband_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(outer, text="Use Multiband Compressor",
                        variable=self.multiband_var,
                        command=self._toggle_mb).grid(
            row=row, column=0, sticky="w", pady=(8, 2)); row += 1
        self.mb_frame = ttk.Frame(outer)
        self.mb_frame.grid(row=row, column=0, sticky="ew"); row += 1
        self.mb_frame.grid_columnconfigure(1, weight=1)
        for r, (label, key, lo, hi, default) in enumerate(MB_SLIDERS):
            self._slider(self.mb_frame, r, label, key, lo, hi, default)

        # art + mp3
        art = ttk.Frame(outer)
        art.grid(row=row, column=0, sticky="ew", pady=8); row += 1
        art.grid_columnconfigure(1, weight=1)
        ttk.Label(art, text="Manual Art Prompt:").grid(row=0, column=0,
                                                       sticky="w")
        self.prompt_var = tk.StringVar()
        self.prompt_entry = ttk.Entry(art, textvariable=self.prompt_var)
        self.prompt_entry.grid(row=0, column=1, sticky="ew", padx=6)
        self.auto_prompt_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(art, text="Auto-generate prompt from analysis",
                        variable=self.auto_prompt_var,
                        command=self._toggle_prompt).grid(
            row=1, column=1, sticky="w", padx=6)
        self.mp3_var = tk.BooleanVar(value=True)
        ttk.Checkbutton(art, text="Also export a high-quality MP3",
                        variable=self.mp3_var).grid(row=2, column=1,
                                                    sticky="w", padx=6)
        self.shard_var = tk.BooleanVar(value=False)
        ttk.Checkbutton(art, text="Distribute this track across all cards "
                                  "(long tracks)",
                        variable=self.shard_var).grid(row=3, column=1,
                                                      sticky="w", padx=6)

        self.tag_label = ttk.Label(outer, text="Studio Notes: ready.",
                                   relief=tk.SUNKEN, padding=4,
                                   wraplength=700)
        self.tag_label.grid(row=row, column=0, sticky="ew", pady=6); row += 1

        self.start_btn = ttk.Button(outer, text="Start Processing",
                                    command=self._start)
        self.start_btn.grid(row=row, column=0, sticky="ew", pady=6); row += 1
        self.progress = ttk.Progressbar(outer, orient="horizontal",
                                        mode="determinate")
        self.progress.grid(row=row, column=0, sticky="ew"); row += 1
        self.status_label = ttk.Label(outer, text="Ready.",
                                      relief=tk.SUNKEN, padding=4)
        self.status_label.grid(row=row, column=0, sticky="ew",
                               pady=4); row += 1

        self.art_label = ttk.Label(outer, text="Cover art appears here",
                                   anchor="center", relief=tk.SUNKEN)
        self.art_label.grid(row=row, column=0, sticky="nsew", pady=8)
        outer.grid_rowconfigure(row, weight=1)

        self._toggle_mb()
        self.after(self.POLL_MS, self._drain_events)

    # -- widgets --------------------------------------------------------------
    def _slider(self, parent, r, label, key, lo, hi, default):
        var = tk.DoubleVar(value=default)
        self.vars[key] = var
        ttk.Label(parent, text=label).grid(row=r, column=0, sticky="w",
                                           padx=4, pady=1)
        ttk.Scale(parent, from_=lo, to=hi, variable=var,
                  orient=tk.HORIZONTAL).grid(row=r, column=1, sticky="ew",
                                             padx=8)
        val = ttk.Label(parent, text=f"{default:.1f}", width=7)
        val.grid(row=r, column=2, sticky="e")
        var.trace_add("write",
                      lambda *a, v=var, w=val: w.config(text=f"{v.get():.1f}"))

    def _pick_input(self):
        path = filedialog.askopenfilename(filetypes=[
            ("Audio Files", "*.wav *.mp3 *.flac *.aiff"),
            ("All files", "*.*")])
        if path:
            self.input_var.set(path)
            self.output_var.set(suggest_output_path(path))

    def _pick_output(self):
        path = filedialog.asksaveasfilename(
            filetypes=[("WAV file", "*.wav")], defaultextension=".wav")
        if path:
            self.output_var.set(path)

    def _apply_preset(self, name):
        self.controller.apply_preset(name, self._presets)

    def _match_reference(self):
        """Fit EQ/width/character (and multiband when enabled) so the
        input spectrally matches a chosen reference track
        (models/automaster.py), then load the fitted values into the
        sliders. Runs on a worker thread; results arrive via the event
        queue like all other callbacks."""
        if not self.input_var.get():
            messagebox.showerror("Error", "Select an input file first.")
            return
        ref = filedialog.askopenfilename(
            title="Reference track to match",
            filetypes=[("Audio Files", "*.wav *.mp3 *.flac *.aiff"),
                       ("All files", "*.*")])
        if not ref:
            return
        self.controller.start_match(
            self.input_var.get(), ref, self.multiband_var.get(),
            functools.partial(_fit_files, device=self.device))

    def _toggle_mb(self):
        if self.multiband_var.get():
            self.mb_frame.grid()
        else:
            self.mb_frame.grid_remove()

    def _toggle_prompt(self):
        state = tk.DISABLED if self.auto_prompt_var.get() else tk.NORMAL
        self.prompt_entry.config(state=state)

    # -- worker ---------------------------------------------------------------
    def _start(self):
        settings = build_settings(
            {k: v.get() for k, v in self.vars.items()},
            input_file=self.input_var.get(),
            output_file=self.output_var.get(),
            multiband=self.multiband_var.get(),
            art_prompt=self.prompt_var.get(),
            auto_generate_prompt=self.auto_prompt_var.get(),
            create_mp3=self.mp3_var.get(),
            shard_time=self.shard_var.get())
        from ame_tpu_torch.api import process_audio
        self.controller.start(settings, functools.partial(
            process_audio, device=self.device))

    def _drain_events(self):
        self.controller.drain()
        self.after(self.POLL_MS, self._drain_events)

    # -- GuiController view surface -------------------------------------------
    def set_status(self, message):
        self.status_label.config(text=message)

    def set_progress(self, value, maximum):
        if maximum is not None:
            self.progress["maximum"] = maximum
        self.progress["value"] = value

    def set_tag(self, text):
        self.tag_label.config(text=text)

    def set_busy(self, busy):
        self.start_btn.config(state=tk.DISABLED if busy else tk.NORMAL)

    def set_match_busy(self, busy):
        self.match_btn.config(state=tk.DISABLED if busy else tk.NORMAL)

    def show_info(self, title, message):
        messagebox.showinfo(title, message)

    def show_error(self, title, message):
        messagebox.showerror(title, message)

    def set_value(self, key, value):
        if key in self.vars:
            self.vars[key].set(value)

    def enable_multiband(self):
        self.multiband_var.set(True)
        self._toggle_mb()

    def show_art(self, image_path):
        if not image_path or Image is None:
            return
        try:
            img = Image.open(image_path)
            w = self.art_label.winfo_width() or 400
            h = self.art_label.winfo_height() or 400
            ratio = img.width / img.height
            if ratio > w / h:
                size = (w, int(w / ratio))
            else:
                size = (int(h * ratio), h)
            img = img.resize(size, Image.LANCZOS)
            self._photo = ImageTk.PhotoImage(img)
            self.art_label.config(image=self._photo, text="")
        except Exception as e:
            self.art_label.config(text=f"Could not display image: {e}")


def run_gui(device="cuda"):  # pragma: no cover - needs a display
    if tk is None:
        raise RuntimeError("tkinter is not available in this environment")
    app = MasteringApp(device)
    app.mainloop()


if __name__ == "__main__":  # pragma: no cover
    run_gui()

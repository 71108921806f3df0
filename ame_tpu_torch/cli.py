"""Command-line interface of the port (counterpart of ``ame_tpu/cli.py``).

    python -m ame_tpu_torch master in.wav out.wav --lufs -14 --bass 2.5 ...
    python -m ame_tpu_torch analyze song.wav [more.wav ...]
    python -m ame_tpu_torch measure song.wav [--input-only]
    python -m ame_tpu_torch automaster in.wav ref.wav [out.wav] --steps 200
    python -m ame_tpu_torch serve --port 8080
    python -m ame_tpu_torch gui
    python -m ame_tpu_torch profile song.wav --runs 10 [--trace DIR]
    python -m ame_tpu_torch fleet in_dir/ out_dir/ [--manifest M.json]

Every subcommand runs on the card (``--device cuda``, the default; it
raises where there is none) unless ``--device cpu`` asks for the host.
``fleet`` exits with 2 when a track failed (the manifest records which).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

def _float_list(s: str) -> tuple:
    """argparse type for comma-separated floats ("150,1000,6000")."""
    return tuple(float(v) for v in s.split(",") if v.strip())


def _add_chain_args(p: argparse.ArgumentParser) -> None:
    """The chain knobs shared by master, fleet and profile."""
    p.add_argument("--analog-character", type=float, default=0.0)
    p.add_argument("--bass", type=float, default=0.0, dest="bass_boost")
    p.add_argument("--mid-cut", type=float, default=0.0, dest="mid_cut")
    p.add_argument("--presence", type=float, default=0.0,
                   dest="presence_boost")
    p.add_argument("--treble", type=float, default=0.0, dest="treble_boost")
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--lufs", type=float, default=-14.0)
    p.add_argument("--no-lufs", action="store_true",
                   help="skip loudness normalization")
    p.add_argument("--multiband", action="store_true")
    p.add_argument("--low-thresh", type=float, default=-25.0)
    p.add_argument("--low-ratio", type=float, default=6.0)
    p.add_argument("--mid-thresh", type=float, default=-20.0)
    p.add_argument("--mid-ratio", type=float, default=3.0)
    p.add_argument("--high-thresh", type=float, default=-15.0)
    p.add_argument("--high-ratio", type=float, default=4.0)
    p.add_argument("--mode", choices=["quality", "compat"],
                   default="quality")


def _add_master_args(p: argparse.ArgumentParser) -> None:
    from ame_tpu_torch.presets import EQ_PRESETS  # pure data
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--preset", choices=list(EQ_PRESETS), default=None,
                   help="EQ preset")
    _add_chain_args(p)
    p.add_argument("--tp", type=float, default=-1.5, dest="target_tp",
                   help="loudnorm true-peak ceiling in dBTP "
                        "(reference: -1.5)")
    p.add_argument("--lra", type=float, default=11.0, dest="target_lra",
                   help="loudnorm target loudness range in LU "
                        "(reference: 11)")
    p.add_argument("--mb-edges", type=_float_list, default=None,
                   help="comma-separated crossover Hz for G-band quality "
                        "multiband (e.g. 150,1000,6000 = 4 bands); "
                        "implies --multiband, quality mode only")
    p.add_argument("--mb-thresholds", type=_float_list, default=None,
                   help="per-band thresholds dB (G values; default -20)")
    p.add_argument("--mb-ratios", type=_float_list, default=None,
                   help="per-band ratios (G values; default 3.0)")
    p.add_argument("--compat-chunked", action="store_true",
                   help="emulate the reference's 30s chunk state resets")
    p.add_argument("--bits", type=int, choices=[16, 24, 32], default=16,
                   help="output bit depth (32 = float WAV; default 16 for "
                        "reference parity)")
    p.add_argument("--mp3", action="store_true", help="also export MP3")
    p.add_argument("--shard-time", action="store_true",
                   help="distribute this track over every card "
                        "(AME_TPU_SP_DEVICES caps them; a track the sharded "
                        "chain cannot take masters on one card after a "
                        "warning)")


def _settings_from_args(args) -> dict:
    from ame_tpu_torch.presets import EQ_PRESETS
    s = {
        "input_file": args.input,
        "output_file": args.output,
        "analog_character": args.analog_character,
        "bass_boost": args.bass_boost,
        "mid_cut": args.mid_cut,
        "presence_boost": args.presence_boost,
        "treble_boost": args.treble_boost,
        "width": args.width,
        "lufs": None if args.no_lufs else args.lufs,
        "target_tp": args.target_tp,
        "target_lra": args.target_lra,
        "multiband": args.multiband or args.mb_edges is not None,
        "low_thresh": args.low_thresh, "low_ratio": args.low_ratio,
        "mid_thresh": args.mid_thresh, "mid_ratio": args.mid_ratio,
        "high_thresh": args.high_thresh, "high_ratio": args.high_ratio,
        "mb_edges": args.mb_edges,
        "mb_thresholds": args.mb_thresholds,
        "mb_ratios": args.mb_ratios,
        "mode": args.mode,
        "compat_chunked": args.compat_chunked,
        "bits": args.bits,
        "create_mp3": args.mp3,
    }
    if args.preset:
        s.update(EQ_PRESETS.get(args.preset, {}))
    return s


def _stderr(tag: str):
    return lambda *a: print(f"[{tag}] " + "/".join(map(str, a)),
                            file=sys.stderr)


def _parser() -> argparse.ArgumentParser:
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="run on the card (default; fails without one) "
                          "or, on request, the host")
    parser = argparse.ArgumentParser(prog="ame_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("master", parents=[dev], help="master an audio file")
    _add_master_args(pm)

    pa = sub.add_parser("analyze", parents=[dev],
                        help="Musicologist technical brief")
    pa.add_argument("input", nargs="+",
                    help="one or more tracks; several run as one batched "
                         "device pass")

    pl = sub.add_parser(
        "measure", parents=[dev],
        help="BS.1770 loudness report: the full loudnorm pass-1 JSON "
             "analog (input_*/output_* stats incl. input_thresh and "
             "target_offset)")
    pl.add_argument("input")
    pl.add_argument("--lufs", type=float, default=-14.0,
                    help="pass-1 target I (drives the output_* stats)")
    pl.add_argument("--input-only", action="store_true",
                    help="skip the dynamic-normalizer simulation; report "
                         "only the input-side stats")

    ps = sub.add_parser("serve", parents=[dev], help="HTTP mastering service")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8080)
    ps.add_argument("--workdir", default=None)
    ps.add_argument("--workers", type=int, default=None,
                    help="job worker pool size (default max(2, cards) or "
                         "AME_TPU_SERVE_WORKERS)")

    pu = sub.add_parser(
        "automaster", parents=[dev],
        help="fit mastering settings so INPUT spectrally matches REF "
             "(differentiable chain, gradient descent on the device)")
    pu.add_argument("input")
    pu.add_argument("ref", help="reference track to match")
    pu.add_argument("output", nargs="?", default=None,
                    help="when given, master INPUT with the fitted "
                         "settings and write the result here")
    pu.add_argument("--steps", type=int, default=200)
    pu.add_argument("--lr", type=float, default=0.05)
    pu.add_argument("--multiband", action="store_true",
                    help="also fit the 6 multiband compressor parameters")
    pu.add_argument("--multi-resolution", action="store_true",
                    help="spectral loss over multiple FFT windows")
    pu.add_argument("--stereo-field", type=float, default=0.0,
                    metavar="W",
                    help="weight of the per-band side/mid stereo-field "
                         "term (makes width identifiable)")
    pu.add_argument("--tp-limit", type=float, default=None, metavar="DBTP",
                    help="penalize fits whose output true peak exceeds "
                         "this ceiling")
    pu.add_argument("--lufs", type=float, default=-14.0)
    pu.add_argument("--no-lufs", action="store_true")

    sub.add_parser("gui", parents=[dev],
                   help="desktop GUI (jobs on --device)")

    pp = sub.add_parser(
        "profile", parents=[dev],
        help="performance report for the mastering graph on the device: "
             "cold start (kernel builds included), steady-state x-realtime "
             "(CUDA events), per-stage breakdown, memory peaks; optionally "
             "a torch.profiler Chrome trace")
    pp.add_argument("input")
    pp.add_argument("--runs", type=int, default=10,
                    help="steady-state timing runs (median reported)")
    pp.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage breakdown")
    pp.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace into DIR")
    _add_chain_args(pp)

    pf = sub.add_parser("fleet", parents=[dev],
                        help="master a directory (resumable)")
    pf.add_argument("input_dir")
    pf.add_argument("output_dir")
    pf.add_argument("--manifest", default=None)
    _add_chain_args(pf)
    return parser


def _master(args) -> int:
    from ame_tpu_torch.api import export_mp3_sidecar, master_file
    settings = _settings_from_args(args)
    status = _stderr("status")
    info = master_file(args.input, args.output, settings, status,
                       _stderr("progress"), device=args.device,
                       shard_time=args.shard_time)
    if settings["create_mp3"]:
        export_mp3_sidecar(args.output, status)
    print(json.dumps(info))
    return 0


def _analyze(args) -> int:
    from ame_tpu_torch.analysis import musicologist
    if len(args.input) == 1:
        print(json.dumps(musicologist.analyze_song(args.input[0],
                                                   device=args.device)))
    else:
        briefs = musicologist.analyze_batch(args.input, device=args.device)
        print(json.dumps(dict(zip(args.input, briefs))))
    return 0


def _stereo_tensor(path: str, device: str):
    import numpy as np
    import torch
    from ame_tpu_torch.io import force_stereo, read_audio
    audio, sr = read_audio(path)
    x = torch.from_numpy(np.ascontiguousarray(force_stereo(audio),
                                              np.float32))
    return x.to(device), sr


def _measure(args) -> int:
    x, sr = _stereo_tensor(args.input, args.device)
    if args.input_only:
        from ame_tpu_torch.ops.loudness import measure
        stats = measure(x, sr)
    else:
        from ame_tpu_torch.ops.loudnorm import loudnorm_pass1
        stats = loudnorm_pass1(x, sr, target_i=args.lufs)
        stats["normalization_type"] = "dynamic"
    out = {k: (round(float(v), 2) if not isinstance(v, str) else v)
           for k, v in stats.items()}
    print(json.dumps(out | {"sample_rate": sr}))
    return 0


def _automaster(args) -> int:
    from ame_tpu_torch.models.automaster import fit_settings
    from ame_tpu_torch.ops.resample import resample
    x, sr_x = _stereo_tensor(args.input, args.device)
    t, sr_t = _stereo_tensor(args.ref, args.device)
    if sr_t != sr_x:
        t = resample(t, sr_t, sr_x)
    fitted = fit_settings(x, sr_x, t, steps=args.steps, lr=args.lr,
                          optimize_multiband=args.multiband,
                          multi_resolution=args.multi_resolution,
                          stereo_weight=args.stereo_field,
                          true_peak_weight=(0.0 if args.tp_limit is None
                                            else 1.0),
                          tp_target=(args.tp_limit
                                     if args.tp_limit is not None else -1.0),
                          verbose=True, device=args.device)
    print(json.dumps(fitted))
    if args.output:
        from ame_tpu_torch.api import master_file
        settings = dict(fitted)
        settings.pop("loss", None)
        settings["lufs"] = None if args.no_lufs else args.lufs
        info = master_file(args.input, args.output, settings,
                           _stderr("status"), device=args.device)
        print(json.dumps(info))
    return 0


def _serve(args) -> int:
    from ame_tpu_torch.serve.server import run_server
    run_server(host=args.host, port=args.port, workdir=args.workdir,
               workers=args.workers, device=args.device)
    return 0


_CHAIN_KEYS = ("analog_character", "bass_boost", "mid_cut", "presence_boost",
               "treble_boost", "width", "multiband", "low_thresh",
               "low_ratio", "mid_thresh", "mid_ratio", "high_thresh",
               "high_ratio", "mode")


def _chain_settings(args) -> dict:
    """The settings dict of fleet and profile (ame_tpu/cli.py's keys)."""
    settings = {k: getattr(args, k) for k in _CHAIN_KEYS}
    settings["lufs"] = None if args.no_lufs else args.lufs
    return settings


def _gui(args) -> int:
    from ame_tpu_torch.gui import run_gui
    run_gui(device=args.device)
    return 0


def _profile(args) -> int:
    from ame_tpu_torch.io import force_stereo, read_audio
    from ame_tpu_torch.utils.profiler import profile_master
    audio, sr = read_audio(args.input)
    report = profile_master(force_stereo(audio), sr, _chain_settings(args),
                            runs=args.runs, stages=not args.no_stages,
                            trace_dir=args.trace, device=args.device)
    print(json.dumps(report))
    return 0


def _fleet(args) -> int:
    from ame_tpu_torch.parallel.fleet import run_fleet
    summary = run_fleet(args.input_dir, args.output_dir,
                        _chain_settings(args), args.manifest,
                        _stderr("fleet"), device=args.device)
    print(json.dumps(summary))
    return 0 if summary["failed"] == 0 else 2


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - [%(funcName)s] - %(message)s")
    args = _parser().parse_args(argv)
    return {"master": _master, "analyze": _analyze, "measure": _measure,
            "automaster": _automaster, "serve": _serve, "gui": _gui,
            "profile": _profile, "fleet": _fleet}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())

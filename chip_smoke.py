#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ame_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and the repository checkout;
it imports nothing of JAX or of the ame_tpu package. Phases, in order — any
failure raises and the script exits non-zero without the final line:

  1. device: the card's name and nvidia-smi's name / power limit line;
  2. build: compiles ame_tpu_torch/csrc/cascade_scan.cu from the checkout;
  3. kernel vs plain: the chain's three cascades (analog shelves k=2,
     4-band EQ k=4, K-weighting k=2) on [2^23 + 1234, 2] noise with a
     non-zero zi, kernel against the plain tile-conv version on the card
     (max abs error <= 1e-4 for y and zf), with both times;
  4. main path: master_file on a 2^23-sample 44.1 kHz stereo WAV with the
     flagship settings; checks the written master (length, finite, ceiling,
     loudness within 0.5 LU of -14) and that the main path made exactly 3
     kernel launches; device-chain and file-to-file times as x realtime;
  5. card vs CPU: master_graph on the first 2^20 samples on both devices
     (max abs difference <= 2e-4, gain difference <= 0.01 dB);
  6. a {"kernels": [...]} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Times are medians of 3 warm runs, taken with torch.cuda.Event (device work)
or the host clock after a synchronize (file to file).
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SR = 44100
N_KERNEL = (1 << 23) + 1234       # ragged: not a multiple of the kernel block
N_MAIN = 1 << 23                  # 3:10 at 44.1 kHz
N_PARITY = 1 << 20
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)
KERNEL_TOL = 1e-4     # tests/test_pallas_scan.py holds K5 to 1e-4
PARITY_TOL = 2e-4
GAIN_TOL_DB = 0.01
LUFS_TOL = 0.5
CEILING = 0.98 + 1e-5
REPS = 3


def _cuda_ms(fn) -> float:
    """Median device time of REPS warm runs of fn, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_s(fn) -> float:
    """Median host seconds of REPS warm runs of fn (fn synchronizes)."""
    fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on an NVIDIA card only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    return name


def phase_build() -> None:
    from ame_tpu_torch.ops import _build
    info = _build.build("cascade_scan")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["ptxas"])]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill",
                                            info["ptxas"]))
    print(f"build: {info['path'].name} in {info['seconds']:.2f} s; ptxas: "
          f"{len(regs)} kernels, at most {max(regs, default=0)} registers, "
          f"{spills} bytes spilled")


def phase_kernel() -> dict:
    from ame_tpu_torch.dsp import design
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.eq import eq_quality_sos
    from ame_tpu_torch.ops.saturate import analog_sos
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv

    s = FLAGSHIP
    cascades = {
        "analog_shelves_k2": analog_sos(SR, s["analog_character"]),
        "eq_k4": eq_quality_sos(SR, s["bass_boost"], 0.0,
                                s["presence_boost"], 0.0),
        "k_weighting_k2": design.k_weighting_sos(SR),
    }
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (0.3 * rng.standard_normal((N_KERNEL, 2))).astype(np.float32)).cuda()
    pre = torch.from_numpy(
        (0.3 * rng.standard_normal((4096, 2))).astype(np.float32)).cuda()
    rows = []
    for name, sos in cascades.items():
        # a non-zero, reachable start state: the plain filter's end state
        # after a pre-roll of noise
        _, zi = sosfilt_tileconv(sos, pre)
        zi = zi.contiguous()
        y_k, zf_k = sosfilt_cuda(sos, x, zi)
        y_p, zf_p = sosfilt_tileconv(sos, x, zi)
        torch.cuda.synchronize()
        err_y = (y_k - y_p).abs().max().item()
        err_zf = (zf_k - zf_p).abs().max().item()
        if not (err_y <= KERNEL_TOL and err_zf <= KERNEL_TOL):
            raise AssertionError(f"{name}: kernel vs plain y {err_y:.3e}, "
                                 f"zf {err_zf:.3e} > {KERNEL_TOL}")
        ms = _cuda_ms(lambda: sosfilt_cuda(sos, x, zi))
        plain_ms = _cuda_ms(lambda: sosfilt_tileconv(sos, x, zi))
        rows.append({"cascade": name, "k": int(sos.shape[0]),
                     "max_abs_err_y": err_y, "max_abs_err_zf": err_zf,
                     "ms": ms, "plain_ms": plain_ms})
        print(f"kernel {name}: |y| err {err_y:.3e}, |zf| err {err_zf:.3e}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"[{N_KERNEL}, 2]")
    return {"rows": rows}


def phase_main(tmp: str) -> dict:
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav, write_wav
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.loudness import measure

    rng = np.random.default_rng(0)
    src = os.path.join(tmp, "in.wav")
    dst = os.path.join(tmp, "out.wav")
    write_wav(src, 0.1 * rng.standard_normal((N_MAIN, 2)), SR)
    settings = MasterSettings(**FLAGSHIP)

    torch.cuda.synchronize()
    sosfilt_cuda.launches = 0
    info = master_file(src, dst, settings, device="cuda")
    launches = sosfilt_cuda.launches
    if launches != 3:
        raise AssertionError(f"main path made {launches} kernel launches, "
                             f"expected 3")

    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad master: sr {sr}, shape {out.shape}")
    pcm, _ = read_wav(src, prefer_int16=True)
    x = torch.from_numpy(pcm).cuda().to(torch.float32) * (1.0 / 32768.0)
    y, _ = master_graph(x, SR, settings)
    peak = y.abs().max().item()
    if peak > CEILING:
        raise AssertionError(f"master peaks at {peak} > {CEILING}")
    out_i = measure(torch.from_numpy(out).cuda(), SR)["input_i"].item()
    if abs(out_i + 14.0) > LUFS_TOL:
        raise AssertionError(f"master measures {out_i} LUFS, target -14")

    chain_ms = _cuda_ms(lambda: master_graph(x, SR, settings))
    file_s = _host_s(lambda: master_file(src, dst, settings, device="cuda"))
    stages: dict = {}
    master_graph(x, SR, settings, timer=stages)
    duration = N_MAIN / SR
    print(f"main path: {launches} kernel launches; master peak {peak:.6f}, "
          f"measures {out_i:.4f} LUFS (info output_i "
          f"{info['output_i']:.4f}, gain {info['gain_db']:.4f} dB)")
    print(f"device chain {chain_ms:.3f} ms = "
          f"{duration / (chain_ms / 1e3):.1f}x realtime; file to file "
          f"{file_s * 1e3:.1f} ms = {duration / file_s:.1f}x realtime "
          f"({duration:.2f} s track)")
    print("stages (ms): " + ", ".join(f"{k} {v * 1e3:.3f}"
                                      for k, v in stages.items()))
    return {"launches": launches, "chain_ms": chain_ms, "file_s": file_s,
            "out_i": out_i, "peak": peak, "stages": stages}


def phase_parity() -> dict:
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph

    rng = np.random.default_rng(0)
    x = np.trunc(np.clip(0.1 * rng.standard_normal((N_MAIN, 2)), -1, 1)
                 * 32767.0)[:N_PARITY].astype(np.float32) / 32768.0
    settings = MasterSettings(**FLAGSHIP)
    y_c, i_c = master_graph(torch.from_numpy(x).cuda(), SR, settings)
    y_h, i_h = master_graph(torch.from_numpy(x), SR, settings)
    diff = (y_c.cpu() - y_h).abs().max().item()
    gain = abs(i_c["gain_db"].item() - i_h["gain_db"].item())
    print(f"card vs CPU [{N_PARITY}, 2]: max |y| diff {diff:.3e}, "
          f"gain diff {gain:.3e} dB")
    if not (diff <= PARITY_TOL and gain <= GAIN_TOL_DB):
        raise AssertionError(f"card vs CPU: {diff} > {PARITY_TOL} or "
                             f"{gain} dB > {GAIN_TOL_DB}")
    return {"max_abs_diff": diff, "gain_diff_db": gain}


def main() -> int:
    kind = phase_device()
    phase_build()
    kern = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        main_run = phase_main(tmp)
    phase_parity()
    rows = kern["rows"]
    print(json.dumps({"kernels": [{
        "name": "cascade_scan",
        "route": "cuda",
        "source": "ame_tpu_torch/csrc/cascade_scan.cu",
        "replaces": "ame_tpu/ops/pallas_scan.py:65",
        "launches": main_run["launches"],
        "max_abs_err": max(max(r["max_abs_err_y"], r["max_abs_err_zf"])
                           for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "per_cascade": rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ame_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and the repository checkout;
it imports nothing of JAX or of the ame_tpu package. Phases, in order — any
failure raises and the script exits non-zero without the final line:

  1. device: the card's name and nvidia-smi's name / power limit line;
  2. build: compiles ame_tpu_torch/csrc/{cascade_scan,wedge_env,pydub_gain,
     sos_grad}.cu from the checkout, one nvcc each, all started together;
     prints each
     kernel's registers and spills, and the opcodes in the hot loop of
     gain_p1's walker and of its floor kernel (cuobjdump -sass);
  3. K5 kernel vs plain: the ten main-path cascades (quality: analog
     shelves k=2, 4-band EQ k=4, K-weighting k=2; compat: k=1 shelf cores,
     the k=4 presence band, the k=2 crossovers, the k=3 dynamic-mode
     K-weighting) and the Q14 Nyquist-clamped order-4 bandpass at 8 kHz,
     on [2^23 + 1234, 2] noise from a non-zero zi, kernel against the
     plain tile-conv version on the card (max abs error <= 1e-4 for y and
     zf); kernel and plain times, the kernel's share of its bound, and its
     time split over its launches (torch.profiler); then K5 on chunk
     columns: the six cascades the chunked compat path runs per chunk, on
     [1 323 000, 14] (the 2^23 track's 7 chunks of 30 s as columns, channel
     groups 4 + 4 + 4 + 2) from a non-zero zi, within 1e-4, timed; then K5
     on the quality multiband paths' cascades, each distinct one: the
     3-band split's bands and the pieces of at most 8 sections of the
     16-band tree's bands on [2^23 + 1234, 2], the k=1 attack smoother on
     [2^23 + 1234, 3] and [2^23 + 1234, 16], from a non-zero zi, within
     1e-4, timed with their bounds;
  4. main path: master_file on a 2^23-sample 44.1 kHz stereo WAV with the
     flagship settings; checks the written master (length, finite, ceiling,
     loudness within 0.5 LU of -14) and that the main path made exactly 3
     kernel launches; device-chain and file-to-file times as x realtime;
  5. card vs CPU: master_graph on the first 2^20 samples on both devices
     (max abs difference <= 2e-4, gain difference <= 0.01 dB);
  6. quality multiband: master_file with the flagship settings and
     multiband=True (K5 3 + 4 launches and nothing else, -14 LUFS within
     0.5 LU, times), master_graph with 16 bands (mb_edges, 15 edges from
     60 Hz to 16 kHz: the K5 launches once every band's cascade of up to
     30 sections is cut into pieces of at most 8, a finite output, its
     device chain); both card vs CPU on 2^20 samples (2e-4, 0.01 dB);
  7. the wedge envelope (K1) vs its plain 12-scan form on the card, both
     directions, on the compat depths of [2^23 + 1234, 2] noise at 0.5
     (envelope within 1e-5, limited output within 1/32768); its time and
     its split over its three launches (torch.profiler);
  8. compat main path: master_file (mode="compat", multiband) on a 2^23
     gated noise + 100 Hz WAV that takes every band over its threshold;
     K1 must launch twice, K5 seven times, K2 at least once and K3 / K4
     never (the relaxation converges); the master's peak (<= 1.0,
     auto-level) and loudness (within 1.0 LU of the auto-levelled -14);
     stage times; then the same with compat_chunked=True (quirk Q6, 7
     chunks of 30 s): K1 twice, K5 seven times (six at C = 14), K2 only
     through its reset route, K3 / K4 never, the same master checks and
     times; then chunked on steady 0.5 noise: K3 with the chunk flags and
     K4 must launch, times;
  9. gain kernels (K2 Jacobi sweep, K3 pass 1, K4 pass 2) vs the plain
     sequential walk on the card, bit for bit: (a) K2 on 2^17 bursts and
     freeze runs,
     (b) K3+K4 on translation-only content, where K2 must report no
     convergence, (d) K3 with reset flags at groups 40, 200, 1000 and
     3000 against its plain version at [3, 2^17], (e) K2's reset route
     against gain_jacobi_plain with the flags at [3, 2^17], chunks of 1500
     (one boundary inside a silent run after a non-zero state), 16
     segments of 258.5 groups, from three sets of carries, (f) on the
     chunked path's band max-attenuations at 2^23: the reset-route Jacobi
     engine against K3 (flags) + K4, the reset route against its plain
     version, its carry and full sweeps timed (beside the unchunked route
     on the same input), (c) K2 against K3+K4 on
     the compat main path's band
     max-attenuations at 2^23, and on those inputs each kernel against its
     plain version: K2's full sweep from the relaxed carries, K4, and K3's
     start states against the plain sweep's states at the group bounds;
     K2's carry sweep (no att written) against its plain version too, and
     its carry and full sweeps timed apart; K3's floor (gain_floor: the
     same step 2^23 times a chain from registers) with the SM clock
     sampled while it runs; K4 also on random m and starts at
     [3, 2^23 + 1234] (rows not 16-byte aligned, a ragged last group: its
     4-byte copy route) and [3, 2^17 + 7], bit for bit, and timed beside a
     device copy of m (the practical ceiling for its bytes); then the
     unchunked fallback path: master_file on steady 0.5 noise, whose low
     band does not converge, so K3 and K4 must launch, and its device
     chain timed with its busy time;
 10. compat card vs CPU on the first 2^20 samples, chunked compat on the
     first 2^21 (a chunk boundary inside): relative L2 < 3e-3 or max abs
     <= 2/32768, loudnorm gain_db / output_i within 0.01 dB;
 11. the Musicologist (no kernel of its own: torch.fft, cuBLAS, cuDNN):
     (a) the package's mood CNN checkpoint loaded on the card (trained, 10
     finite tensors); (b) card vs CPU on three 30 s 22 050 Hz inputs (0.1
     N(0,1) seed 2, a 128 BPM click-tone, the compat input's mono mixdown
     resampled; the resample itself within 1e-5): image max abs <= 1e-5,
     logits <= 1e-3, centroid and RMS relative <= 1e-4, mood / key /
     brightness / density equal, tempo equal unless the CPU's two best
     tempo scores are within 1e-4 relative (a near-tie cuFFT may flip:
     printed, not failed); (c) analyze_song on phase 4's 2^23-sample WAV
     (five keys, no kernel launch, peak device memory printed); (d)
     analyze_batch over eight paths (mixed rates and lengths, one missing)
     equal to the per-track briefs, an error entry for the missing one;
     (e) process_audio on phase 4's WAV with auto_generate_prompt: one
     "Mood: " tag, a Success: status, no Error: / Failed:, 3 K5 launches;
     (f) analyze_waveform on 30 s (CUDA events and host clock, x
     realtime), analyze_song on the 2^23 WAV and analyze_batch a path
     (host clock), and the analysis's busy time and idle share under
     torch.profiler in a process of its own (``--musicologist-profile``:
     one that ran no plain gain walk);
 12. streaming (streaming.py): (a) the 2^23-sample quality track with a
     hot section streamed in blocks of 4096 (flagship settings, gain -2 dB;
     plain, 3-band and 16-band multiband): every sample emitted, within
     1e-4 / 2e-4 of the port's offline composition on the card, K5 exactly
     2 / 6 / 57 times a block and no other kernel, card vs CPU on the first
     2^20 samples within 2e-4, its time; (b) K5 at stream shapes (N = 1,
     63, 440, 512, 4097, 48 000 at C = 2; the attack smoother at C = 3 and
     16) against its plain version from a non-zero zi, and 2048 blocks
     chained zf -> zi against one call (1e-4, no drift); K1's reverse
     direction at n = 1, 31, 2000, 3520, 8193 (1e-5); (c) the compat
     input's 2^23 track pushed in 100 000-sample pieces through
     StreamingCompatMaster (gain 0, multiband) against the offline chunked
     chain (max <= 8/32768, 99.9th percentile <= 1/32768 + 1e-6, median 0):
     per block one K1 (reverse) launch, six K5, K2 and no reset route, each
     K1 launch held to its plain version (1e-5); steady 0.5 noise (K3 and
     K4 launch); remainders of 1 and 31 samples after one block; K2 and
     K3 + K4 at n = 1, 31, 1000 bit for bit against the plain walk; (d) block
     latency as benchmarks/bench_streaming.py measures it (48 kHz, blocks of
     512, 1024, 4096, 48 000; 3 warm, 200 timed) for quality plain, 3-band
     and 16-band, launches per block, host us a sosfilt_cuda call, and the
     busy time and idle share at 4096 under torch.profiler in a process of
     its own (``--streaming-profile``);
 13. fitting (models/automaster.py): (a) K5's REVERSE direction on the ten
     main-path cascades at [2^23 + 1234, 2] from zero state against flip ∘
     plain ∘ flip (y and zf within 1e-4), timed beside the forward, with
     its bound; (b) sos_grad against sos_grad_plain on [2^23 + 1234, 2]
     (v and w the halves of one [N, 4] tensor), relative error within
     1e-9 and the same bits twice, timed with its bound (3·N·C·4 bytes);
     (c) dL/dtheta of _perceptual_loss on the phase-4 track with every
     term on (multiband parameters, two FFT resolutions, band dynamics,
     stereo field, true peak), through the kernels against every cascade
     on the plain traced tile-conv on the card, within 1e-3 of each
     leaf's largest entry; (d) fit_settings with those terms for 10
     steps against a target made with +4 dB bass, -2 dB presence and
     width 1.3: the loss falls, the bass gain rises, and K5 makes exactly
     25 forward and 19 reverse launches and sos_grad 6 a step (plus the
     target's and the final loss's forward launches), nothing else; a
     step's time (CUDA events, host clock), the host time to prepare a
     tensor sos's tables, and its busy time and idle share under
     torch.profiler in a process of its own (``--fit-profile``);
 14. training (models/train_mood.py): synth_corpus.generate (4 classes x
     8 tracks x 30 s), train_mood.main for 2 epochs at batch 32 with a
     checkpoint directory, then to 3 epochs resumed from it: the loss is
     finite and falls, three checkpoints, the written msgpack loads
     through load_params, analyze_song runs on it; a step's time;
 15. the run's seconds, a {"chains": ...} line, a {"kernels": [...]} line,
     a {"musicologist": ...} line, a {"streaming": ...} line, a {"fit":
     ...} line, a {"train": ...} line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run alone, without the repository's ame_tpu_torch package beside it, the
script stops after phase 1 with a non-zero exit and prints no result.

``python3 chip_smoke.py --kernel-times [ROOT]`` runs phase 3, K1's check
and times, K2's sweep times, K3's check, time and floor and K4's checks
and times (with the copy yardstick) at [3, 2^23], K4 at [3, 2^23 + 1234],
K2's reset route (f) and the device chains (quality, compat, compat
fallback, compat chunked and its fallback, quality multiband 3 and 16
bands) and analyze_waveform on 30 s only, with the ame_tpu_torch package
under ROOT (default: this checkout; e.g. an unpacked parent commit, which
may lack chunked compat, multiband or the Musicologist: those parts are
then left out), so that two trees can be timed in turns on one card.

Every kernel's launch count is set to 0 just before each main path and read
just after it. Times are medians of 3 warm runs, taken with
torch.cuda.Event (device work) or the host clock after a synchronize (file
to file). Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s f32.
"""

import concurrent.futures
import json
import logging
import math
import os
import re
import shutil
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
N_GAIN_PLAIN = 1 << 17            # the plain sequential walk's length
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)
COMPAT = dict(FLAGSHIP, mode="compat", multiband=True)
KERNEL_TOL = 1e-4     # tests/test_pallas_scan.py holds K5 to 1e-4
WEDGE_TOL = 1e-5
LSB = 1.0 / 32768.0
PARITY_TOL = 2e-4
GAIN_TOL_DB = 0.01
LUFS_TOL = 0.5
COMPAT_LUFS_TOL = 1.0          # tests/test_chain.py:176's allowance
COMPAT_TARGET = -14.0 + 20.0 * math.log10(1.0 / 0.98)   # auto-levelled
CEILING = 0.98 + 1e-5
REPS = 3
KERNEL_CALLS = 10              # calls in a row per timed kernel run
HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS = 67e12              # H100 SXM, f32 outside the tensor cores
ATTACK, RELEASE = 220.5, 2205.0   # the compressor's 5 / 50 ms at 44.1 kHz
RESET_GROUPS = (40, 200, 1000, 3000)   # flagged 32-sample groups, K3 (d)
CHUNK_LEN = int(30.0 * SR)     # COMPAT_CHUNK_SECONDS at 44.1 kHz: 1 323 000
RESET_CHUNK = 1500             # K2's reset route on [3, 2^17], (e)
N_CHUNK_PARITY = 1 << 21       # holds the first chunk boundary
COMPAT_CHUNKED = dict(COMPAT, compat_chunked=True)
QUALITY_MB = dict(FLAGSHIP, multiband=True)
EDGES_16 = tuple(float(e) for e in np.geomspace(60.0, 16000.0, 15).round(1))
QUALITY_MB16 = dict(FLAGSHIP, mb_edges=EDGES_16)


def _cuda_ms(fn, calls: int = 1) -> float:
    """Median over REPS warm runs of the device time of `calls` calls of fn
    in a row, per call, in ms. With calls > 1 the host enqueues the next
    call while the card runs the last one, so a kernel's time is not
    stretched by its wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _host_us(fn, calls: int = KERNEL_CALLS) -> float:
    """Host microseconds per call of fn (its enqueue time: no sync inside),
    over `calls` calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _host_s(fn) -> float:
    """Median host seconds of REPS warm runs of fn (fn synchronizes)."""
    fn()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _bound(nbytes: float, flops: float):
    """(least ms, what bounds it) for moving nbytes and doing flops f32
    operations at the card's published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _counters():
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.wedge_env import wedge_env_cuda
    out = {"wedge_env": wedge_env_cuda, "gain_jacobi": pg.gain_jacobi_cuda,
           "gain_p1": pg.gain_p1_cuda, "gain_p2": pg.gain_p2_cuda,
           "cascade_scan": sosfilt_cuda}
    try:                          # a tree from before the fit has no sos_grad
        from ame_tpu_torch.ops.sos_grad import sos_grad_cuda
        out["sos_grad"] = sos_grad_cuda
    except ImportError:
        pass
    return out


def _reset_counters() -> dict:
    """The counts kept under other names than ``launches``, where the
    package keeps them: K2's reset route and K3 with flags (within
    gain_jacobi's and gain_p1's counts), and K5's reverse launches (apart
    from its forward ones)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    return {k: (fn, attr) for k, fn, attr in (
        ("gain_jacobi_resets", pg.gain_jacobi_cuda, "reset_launches"),
        ("gain_p1_resets", pg.gain_p1_cuda, "reset_launches"),
        ("cascade_scan_reverse", sosfilt_cuda, "reverse_launches"))
        if hasattr(fn, attr)}


def _zero_counts() -> None:
    torch.cuda.synchronize()
    for fn in _counters().values():
        fn.launches = 0
    for fn, attr in _reset_counters().values():
        setattr(fn, attr, 0)


def _read_counts() -> dict:
    torch.cuda.synchronize()
    return {**{k: fn.launches for k, fn in _counters().items()},
            **{k: getattr(fn, attr)
               for k, (fn, attr) in _reset_counters().items()}}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on an NVIDIA card only")
    name = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit").splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(smi)
    return name


def phase_build() -> None:
    from ame_tpu_torch.ops import _build
    names = tuple(n for n in ("cascade_scan", "wedge_env", "pydub_gain",
                              "sos_grad")
                  if (_build._CSRC / f"{n}.cu").exists())
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        infos = list(pool.map(_build.build, names))
    for info in infos:
        print(f"build: {info['path'].name} in {info['seconds']:.2f} s")
        for name, regs, spills in _ptxas_report(info["ptxas"]):
            print(f"  ptxas {name}: {regs} registers, {spills} bytes "
                  f"spilled")
    for kernel in ("gain_p1", "gain_floor"):
        for loop in _sass_hot_loops(infos[2]["path"], kernel) or [None]:
            print(f"  sass {kernel} loop: " + json.dumps(loop))


SASS_OPS = ("LDG", "LDS", "STS", "STG", "FFMA", "FMUL", "FADD", "FMNMX",
            "FSEL", "FSETP")


def _sass_hot_loops(so, kernel: str):
    """The innermost loops of `kernel` that hold FMNMX (a loop is a
    backward branch in cuobjdump's SASS of the library): each one's address
    range, instruction count and the count of each opcode in SASS_OPS.
    None when cuobjdump or the kernel is not found."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True).stdout
    body = None
    for chunk in text.split("Function : ")[1:]:
        mangled = chunk.split(None, 1)[0]
        m = re.match(r"_Z(\d+)", mangled)
        if m and mangled[m.end():m.end() + int(m.group(1))] == kernel:
            body = chunk
    if body is None:
        return None
    insns, labels, pending = [], {}, []
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2), m.group(3)))
    loops = []
    for addr, op, args in insns:
        t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
        if not op.startswith("BRA") or t is None:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        if target is not None and target <= addr:
            ops = [o.split(".")[0] for a, o, _ in insns if target <= a <= addr]
            if "FMNMX" in ops:
                loops.append((target, addr, ops))
    return [{"range": f"{t:#x}-{a:#x}", "instructions": len(ops),
             **{k: ops.count(k) for k in SASS_OPS}}
            for t, a, ops in loops
            if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a)
                       for t2, a2, _ in loops)]


def _ptxas_report(text: str) -> list:
    """(kernel, registers, spill store + load bytes) from nvcc -Xptxas -v:
    the kernel's mangled name shortened to name<template int>."""
    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        m = re.match(r"_Z(\d+)", mangled)
        name = (mangled[m.end():m.end() + int(m.group(1))] if m
                else mangled)
        name += "".join(f"<{a}>" for a in re.findall(r"L[ib](\d+)E",
                                                     mangled))
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", chunk)
        out.append((name, int(regs.group(1)) if regs else 0,
                    int(spills.group(1)) + int(spills.group(2))
                    if spills else 0))
    return out


def _quality_cascades() -> dict:
    """The quality main path's three cascades (flagship settings)."""
    from ame_tpu_torch.dsp import design
    from ame_tpu_torch.ops.eq import eq_quality_sos
    from ame_tpu_torch.ops.saturate import analog_sos
    s = FLAGSHIP
    return {
        "analog_shelves_k2": analog_sos(SR, s["analog_character"]),
        "eq_k4": eq_quality_sos(SR, s["bass_boost"], 0.0,
                                s["presence_boost"], 0.0),
        "k_weighting_k2": design.k_weighting_sos(SR),
    }


def _compat_cascades() -> dict:
    """The compat main path's seven cascades (the seven launches of a compat
    master): k=1 shelf cores, the k=4 presence band, the k=2 crossovers,
    the k=3 dynamic-mode K-weighting."""
    from ame_tpu_torch import config as C
    from ame_tpu_torch.dsp import design

    def shelf(hz, kind):
        return design.ba_to_sos_biquad(*design.butter_ba(2, hz / (SR / 2),
                                                         kind))
    return {
        "analog_low_shelf_k1": shelf(C.ANALOG_LOW_SHELF_HZ, "low"),
        "analog_high_shelf_k1": shelf(C.ANALOG_HIGH_SHELF_HZ, "high"),
        "bass_shelf_k1": shelf(C.BASS_SHELF_HZ, "low"),
        "presence_band_k4": design.reference_peak_band_sos(
            SR, C.PRESENCE_PEAK_HZ),
        "crossover_low_k2": design.butter_sos(4, C.MB_LOW_CROSSOVER_HZ,
                                              "lowpass", fs=SR),
        "crossover_high_k2": design.butter_sos(4, C.MB_HIGH_CROSSOVER_HZ,
                                               "highpass", fs=SR),
        "k_weighting_dynamic_k3": design.k_weighting_dynamic_sos(SR),
    }


def _profile(fn, calls: int) -> dict:
    """{kernel name: (device ms summed, records)} that torch.profiler kept
    over `calls` warm calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and t > 0:
            name = re.sub(r"^void |\(.*$", "", e.key)
            ms, k = out.get(name, (0.0, 0))
            out[name] = (ms + t / 1e3, k + e.count)
    return out


def _profile_ms(fn) -> dict:
    """Device ms per call of fn, by kernel name, from torch.profiler over
    REPS warm calls (empty when the profiler sees no device time)."""
    return {k: ms / REPS for k, (ms, _) in _profile(fn, REPS).items()}


def _launch_ms(fn, calls: int = 20):
    """(device ms of one launch, records kept) for fn, which launches one
    kernel: the mean over the records torch.profiler kept of `calls` calls.
    After a long stream of small launches outside a session it drops the
    session's first records (PERF.md section 7), so the mean of what it
    kept stands for a launch and a total over `calls` would not."""
    kept = list(_profile(fn, calls).values())
    if len(kept) != 1:
        return None, sum(k for _, k in kept)
    return kept[0][0] / kept[0][1], kept[0][1]


def _chain_busy(name: str, fn, chain_ms: float) -> dict:
    """The device's busy time in one chain run (kernel time summed by
    torch.profiler), its idle share of the event-timed chain_ms, and the
    five kernels that take most of it."""
    per_kernel = _profile_ms(fn)
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"{name} chain on the device: busy {busy_ms:.3f} ms of "
          f"{chain_ms:.3f} ms (idle share {1 - busy_ms / chain_ms:.3f}); "
          f"top kernels (ms): "
          + ", ".join(f"{k[:60]} {v:.4f}" for k, v in top))
    return {"busy_ms": busy_ms, "idle_share": 1 - busy_ms / chain_ms,
            "top": top}


def _cascade_bound(k: int, n: int, c: int):
    return _bound(2 * n * c * 4, 12 * k * n * c)     # x in, y out


def phase_cascades() -> list:
    """K5 on the ten main-path cascades (3 quality, 7 compat) and the Q14
    band: kernel vs plain tile-conv on [2^23 + 1234, 2] noise from a
    non-zero zi (y and zf within 1e-4), kernel and plain times, and the
    kernel's time split over its launches (torch.profiler)."""
    from ame_tpu_torch.dsp import design
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv

    cascades = {**_quality_cascades(), **_compat_cascades(),
                # quirk Q14: the presence band's upper edge clamps next to
                # Nyquist at 8 kHz, so its top pole pair sits within ~1e-6
                # of z = -1
                "q14_bandpass_k4_8khz": design.reference_peak_band_sos(
                    8000.0, 4000.0)}
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
        del y_k, y_p
        ms = _cuda_ms(lambda: sosfilt_cuda(sos, x, zi), KERNEL_CALLS)
        one_ms = _cuda_ms(lambda: sosfilt_cuda(sos, x, zi))
        host_us = _host_us(lambda: sosfilt_cuda(sos, x, zi))
        plain_ms = _cuda_ms(lambda: sosfilt_tileconv(sos, x, zi))
        phases = _profile_ms(lambda: sosfilt_cuda(sos, x, zi))
        k = int(sos.shape[0])
        bound = _cascade_bound(k, N_KERNEL, 2)
        rows.append({"cascade": name, "k": k, "max_abs_err_y": err_y,
                     "max_abs_err_zf": err_zf, "ms": ms,
                     "one_call_ms": one_ms, "host_us": host_us,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_share": bound[0] / ms, "phase_ms": phases})
        print(f"kernel {name}: |y| err {err_y:.3e}, |zf| err {err_zf:.3e}; "
              f"kernel {ms:.4f} ms ({bound[0] / ms:.1%} of its bound; one "
              f"call alone {one_ms:.4f} ms, host {host_us:.1f} us a call), "
              f"plain {plain_ms:.4f} ms [{N_KERNEL}, 2]; launches (ms): "
              + ", ".join(f"{n} {t:.4f}" for n, t in phases.items()))
    return rows


def phase_cascades_chunked() -> list:
    """K5 on chunk columns: the six cascades that the chunked compat path
    runs per chunk (all compat cascades but the K-weighting), on
    [CHUNK_LEN, 2 * n_chunks] = [1 323 000, 14] noise (the 2^23 track's 7
    chunks as columns: channel groups 4 + 4 + 4 + 2) from a non-zero zi,
    kernel vs plain (y and zf within 1e-4), kernel and plain times."""
    cols = 2 * -(-N_MAIN // CHUNK_LEN)
    x, pre = _noise_input(CHUNK_LEN, cols, 2)
    return [_cascade_row(name, sos, x, pre)
            for name, sos in list(_compat_cascades().items())[:6]]


def _noise_input(n: int, cols: int, seed: int):
    """[n, cols] 0.3 N(0,1) noise on the card, and a [4096, cols] pre-roll
    of the same noise for start states."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((0.3 * rng.standard_normal((n, cols)))
                         .astype(np.float32)).cuda()
    pre = torch.from_numpy((0.3 * rng.standard_normal((4096, cols)))
                           .astype(np.float32)).cuda()
    return x, pre


def _cascade_row(name: str, sos, x: torch.Tensor, pre: torch.Tensor,
                 **extra) -> dict:
    """K5 on x [N, C] against its plain tile-conv version from a non-zero
    zi (the plain filter's end state after the pre-roll), y and zf within
    KERNEL_TOL; then the kernel's time (10 calls in a row), the plain
    version's and the bound."""
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
    sos = np.ascontiguousarray(np.asarray(sos, np.float64))
    N, C = x.shape
    _, zi = sosfilt_tileconv(sos, pre)
    zi = zi.contiguous()
    y_k, zf_k = sosfilt_cuda(sos, x, zi)
    y_p, zf_p = sosfilt_tileconv(sos, x, zi)
    torch.cuda.synchronize()
    err = max((y_k - y_p).abs().max().item(),
              (zf_k - zf_p).abs().max().item())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{name} at [{N}, {C}]: kernel vs plain "
                             f"{err:.3e} > {KERNEL_TOL}")
    del y_k, y_p
    ms = _cuda_ms(lambda: sosfilt_cuda(sos, x, zi), KERNEL_CALLS)
    plain_ms = _cuda_ms(lambda: sosfilt_tileconv(sos, x, zi))
    k = int(sos.shape[0])
    bound = _cascade_bound(k, N, C)
    print(f"kernel {name} k={k} [{N}, {C}]: err {err:.3e}; kernel "
          f"{ms:.4f} ms ({bound[0] / ms:.1%} of its bound {bound[0]:.4f} "
          f"ms), plain {plain_ms:.4f} ms")
    return {"cascade": name, "k": k, "shape": [N, C], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_share": bound[0] / ms, **extra}


def _mb_cascades() -> dict:
    """The K5 inputs of the quality multiband paths, each distinct one
    once: {name: (sos, C, {path: runs per master})}. The three band
    cascades of the 3-band split and the pieces of at most 8 sections that
    sosfilt cuts the 16-band tree's band cascades into (a piece shared by
    several bands, as the low edges' highpasses are, once), at C = 2; the
    k=1 attack smoother on the bands as columns, C = 3 and 16."""
    from ame_tpu_torch import config as C
    from ame_tpu_torch.graph import multiband as mb
    from ame_tpu_torch.ops.cascade_scan import _MAX_SECTIONS
    from ame_tpu_torch.ops.compressor import attack_sos
    out, seen = {}, {}
    for path, cascades in (("quality_mb", mb._band_cascades_3(SR)),
                           ("quality_mb16", mb._band_cascades_n(SR,
                                                                EDGES_16))):
        for b, sos in enumerate(cascades):
            sos = np.asarray(sos, np.float64)
            for i in range(0, sos.shape[0], _MAX_SECTIONS):
                piece = np.ascontiguousarray(sos[i:i + _MAX_SECTIONS])
                name = seen.setdefault(
                    piece.tobytes(),
                    f"{path}_band{b}" + (f"_sections{i}-{i + len(piece) - 1}"
                                         if len(sos) > _MAX_SECTIONS else ""))
                entry = out.setdefault(name, (piece, 2, {}))
                entry[2][path] = entry[2].get(path, 0) + 1
    smoother = attack_sos(SR, C.MB_ATTACK_MS)
    for path, G in (("quality_mb", 3), ("quality_mb16", len(EDGES_16) + 1)):
        out[f"attack_smoother_C{G}"] = (smoother, G, {path: 1})
    return out


def phase_cascades_mb() -> list:
    """K5 on the quality multiband paths' cascades (_mb_cascades): each
    distinct one on [2^23 + 1234, C] noise from a non-zero zi, kernel vs
    plain (y and zf within 1e-4), kernel and plain times, its bound."""
    rows, inputs = [], {}
    for name, (sos, C, uses) in _mb_cascades().items():
        if C not in inputs:
            inputs[C] = _noise_input(N_KERNEL, C, 3)
        rows.append(_cascade_row(name, sos, *inputs[C], uses=uses))
    return rows


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

    _zero_counts()
    info = master_file(src, dst, settings, device="cuda")
    counts = _read_counts()
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
    busy = _chain_busy("quality", lambda: master_graph(x, SR, settings),
                       chain_ms)
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
    return {"launches": launches, "counts": counts, "chain_ms": chain_ms,
            "busy": busy,
            "file_s": file_s, "out_i": out_i, "peak": peak, "stages": stages}


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


# ---------------------------------------------------------------------------
# Compat chain: K1 (wedge_env), K2 (gain_jacobi), K3 (gain_p1), K4 (gain_p2)
# ---------------------------------------------------------------------------

def _wedge_input():
    """[2^23 + 1234, 2] 0.5 N(0,1) noise on the card and its compat depths
    (alimiter_compat's formula: limit 0.98)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (0.5 * rng.standard_normal((N_KERNEL, 2))).astype(np.float32)).cuda()
    peak = x.abs().amax(dim=1)
    dep = torch.clamp(1.0 - 0.98 / torch.clamp(peak, min=1e-9), min=0.0)
    return x, dep


def _wedge_kernel(dep: torch.Tensor) -> dict:
    """K1 on dep in both directions (the compat limiter's 5 / 50 ms pieces)
    against its plain version (envelope within WEDGE_TOL), then timed:
    both directions 10 calls in a row, one call alone, the plain version,
    and the split over its launches (torch.profiler)."""
    from ame_tpu_torch.ops.limiter import _wedge_pieces
    from ame_tpu_torch.ops.wedge_env import wedge_env_cuda, wedge_env_plain
    sides = {"release": (_wedge_pieces(RELEASE), False),
             "attack": (_wedge_pieces(float(round(5.0 * SR / 1000.0))),
                        True)}
    env_p, err = {}, 0.0
    for side, (pieces, reverse) in sides.items():
        env_k = wedge_env_cuda(dep, pieces, reverse)
        env_p[side] = wedge_env_plain(dep, pieces, reverse)
        e = (env_k - env_p[side]).abs().max().item()
        print(f"wedge_env {side}: |env| err {e:.3e} [{dep.shape[0]}]")
        err = max(err, e)
    if not err <= WEDGE_TOL:
        raise AssertionError(f"wedge_env vs plain {err:.3e} > {WEDGE_TOL}")

    def both(env):
        return lambda: [env(dep, p, r) for p, r in sides.values()]
    ms = _cuda_ms(both(wedge_env_cuda), KERNEL_CALLS)
    one_ms = _cuda_ms(both(wedge_env_cuda))
    plain_ms = _cuda_ms(both(wedge_env_plain))
    phases = _profile_ms(both(wedge_env_cuda))
    P = len(sides["release"][0])
    n = dep.shape[0]
    bound = _bound(2 * 2 * n * 4, 2 * 4 * P * n)
    print(f"wedge_env both directions: kernel {ms:.4f} ms ({bound[0] / ms:.1%}"
          f" of its bound {bound[0]:.4f} ms; one call alone {one_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms; launches (ms): "
          + ", ".join(f"{k} {t:.4f}" for k, t in phases.items()))
    return {"env_p": env_p, "max_abs_err": err, "ms": ms,
            "one_call_ms": one_ms, "plain_ms": plain_ms, "bound": bound,
            "phase_ms": phases}


def phase_wedge() -> dict:
    from ame_tpu_torch.ops.limiter import alimiter_compat

    x, dep = _wedge_input()
    k1 = _wedge_kernel(dep)
    env_p = k1.pop("env_p")
    # the limited output: the kernel path against the plain envelopes
    y_k = alimiter_compat(x, SR)
    d_p = torch.maximum(env_p["release"], env_p["attack"])
    y_p = x * ((1.0 - d_p) * float(np.float32(1.0) / np.float32(0.98)))[:,
                                                                        None]
    err_y = (y_k - y_p).abs().max().item()
    print(f"alimiter_compat kernel vs plain envelopes: |y| err {err_y:.3e}")
    if not err_y <= LSB:
        raise AssertionError(f"limited output differs by {err_y} > 1/32768")
    return {**k1, "max_abs_err": max(k1["max_abs_err"], err_y)}


def _gain_bounds(G: int, n: int):
    ng = -(-n // 32)
    flops = 5 * G * n
    return {"gain_jacobi": _bound(2 * G * n * 4, flops),
            "gain_p1": _bound(G * n * 4 + G * ng * 4, flops),
            "gain_p2": _bound(2 * G * n * 4 + G * ng * 4, flops)}


def _compat_input(n: int) -> np.ndarray:
    """The compat main path's input: 0.3 N(0,1) noise + 0.3 sin(2 pi 100 t),
    gated by a 0.5 Hz on/off envelope with 10 ms ramps, clipped."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / SR
    period, ramp = 2.0, 0.010
    ph = t % period
    env = np.clip(np.minimum(ph / ramp, (period / 2 - ph) / ramp), 0.0, 1.0)
    env[ph >= period / 2] = 0.0
    x = (0.3 * rng.standard_normal((n, 2))
         + 0.3 * np.sin(2 * np.pi * 100.0 * t)[:, None]) * env[:, None]
    return np.clip(x, -1.0, 1.0)


def _band_max_att(x: torch.Tensor) -> torch.Tensor:
    """[3, N] detector max-attenuations of the compat chain's three bands,
    as the multiband stage computes them from the graph's input x."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    from ame_tpu_torch.graph.multiband import _crossover_compat
    from ame_tpu_torch.ops import compressor, quantize

    p = chain.params_from_settings(MasterSettings(**COMPAT), x.device)
    y = chain._stage_analog_compat(x, p["analog"], SR)
    y = chain._stage_eq_width_compat(y, p["bass"], p["mid_cut"],
                                     p["presence"], p["treble"], SR, True,
                                     p["width"])
    bands = _crossover_compat(y, SR)
    return torch.stack([
        compressor.pydub_detector(quantize.float_to_int16(b), SR, th, ra)[1]
        for b, th, ra in zip(bands, p["threshs"].tolist(),
                             p["ratios"].tolist())]).contiguous()


def phase_gain(m_main: torch.Tensor, m_chunked: torch.Tensor) -> dict:
    from ame_tpu_torch.ops import pydub_gain as pg

    ia, ir = pg._scal(ATTACK, RELEASE)

    def walk(m, ia, ir):          # the plain sequential walk, on the card
        return pg._gain_scan(m.T.contiguous(), ia, ir).T

    # (a) K2 on a burst and a freeze run per chain, between silences
    # (tests/test_compressor.py:221-223, three chains)
    rng = np.random.default_rng(7)
    m = np.zeros((3, N_GAIN_PLAIN), np.float32)
    for g in range(3):
        m[g, 5000:60000] = (4 - g) * np.abs(rng.standard_normal(55000))
        m[g, 100000:120000] = 2.0 + g
    m = torch.from_numpy(m).cuda()
    z3 = torch.zeros(3, device="cuda")
    att_j, ok, sweeps = pg._jacobi(m, z3, ia, ir)
    ref = walk(m, ia, ir)
    if not all(ok) or not torch.equal(att_j, ref):
        raise AssertionError(f"(a) gain_jacobi: converged {ok}, max diff "
                             f"{(att_j - ref).abs().max().item()}")
    err_a = (att_j - ref).abs().max().item()
    walk_ms = _cuda_ms(lambda: walk(m, ia, ir))
    print(f"gain (a) gain_jacobi == plain walk bit for bit "
          f"[3, {N_GAIN_PLAIN}], {sweeps} sweeps; plain walk "
          f"{walk_ms:.1f} ms at {N_GAIN_PLAIN} samples")

    # (b) translation-only content: K2 must not converge, K3+K4 are exact
    ia_t, ir_t = pg._scal(1e9, RELEASE)
    mt = torch.full((1, N_GAIN_PLAIN), 10.0, device="cuda")
    z1 = torch.zeros(1, device="cuda")
    _, ok_t, sweeps_t = pg._jacobi(mt, z1, ia_t, ir_t)
    tp = pg._two_pass(mt, z1, ia_t, ir_t)
    ref_t = walk(mt, ia_t, ir_t)
    if any(ok_t) or not torch.equal(tp, ref_t):
        raise AssertionError(f"(b) converged {ok_t}; two-pass max diff "
                             f"{(tp - ref_t).abs().max().item()}")
    err_b = (tp - ref_t).abs().max().item()
    print(f"gain (b) translation-only: gain_jacobi gave up after {sweeps_t} "
          f"sweeps; gain_p1 + gain_p2 == plain walk bit for bit")

    # (d) K3 with reset flags at a handful of group starts, from a non-zero
    # state, on the main path's bands cut to 2^17 (4096 groups)
    m17 = m_main[:, :N_GAIN_PLAIN].contiguous()
    resets = torch.zeros(-(-N_GAIN_PLAIN // pg._K), device="cuda")
    resets[list(RESET_GROUPS)] = 1.0
    init = torch.tensor([0.0, 1.5, 7.0], device="cuda")
    st_k = pg.gain_p1_cuda(m17, resets, init, ia, ir)
    st_p = pg.gain_p1_plain(m17, resets, init, ia, ir)
    if not torch.equal(st_k, st_p):
        raise AssertionError(f"(d) gain_p1 with resets vs plain: max diff "
                             f"{(st_k - st_p).abs().max().item()}")
    if not (st_k[:, list(RESET_GROUPS)] == 0).all().item():
        raise AssertionError("(d) a flagged group does not start at 0")
    print(f"gain (d) gain_p1 with resets at groups {list(RESET_GROUPS)} == "
          f"gain_p1_plain bit for bit [3, {N_GAIN_PLAIN}]")

    # (e), (f) K2's reset route
    reset = {"small": _reset_small(), **_reset_main(m_chunked)}

    # (c) the compat main path's bands at 2^23: two algorithms, one answer
    G, n = m_main.shape
    att_c, ok_c, sweeps_c = pg._jacobi(m_main, z3, ia, ir)
    tp_c = pg._two_pass(m_main, z3, ia, ir)
    if not all(ok_c) or not torch.equal(att_c, tp_c):
        raise AssertionError(f"(c) converged {ok_c}; jacobi vs two-pass max "
                             f"diff {(att_c - tp_c).abs().max().item()}")
    err_c = (att_c - tp_c).abs().max().item()
    print(f"gain (c) main-path bands [{G}, {n}]: gain_jacobi converged in "
          f"{sweeps_c} sweeps, == gain_p1 + gain_p2 bit for bit")

    # each kernel against its plain version on the main path's inputs at
    # 2^23: the full Jacobi sweep from the relaxed carries, pass 1, pass 2
    m_t, S, c_first, c_fix, _ = _jacobi_inputs(m_main)
    seg_len = m_t.shape[0]
    c = c_fix.reshape(-1).contiguous()
    # the carry sweep (no att written) from the first sweep's carries
    co_k, _ = pg.gain_jacobi_cuda(m_t, c_first, ia, ir, False)
    co_p, _ = pg.gain_jacobi_plain(m_t, c_first, ia, ir, False)
    if not torch.equal(co_k, co_p):
        raise AssertionError(f"gain_jacobi carry sweep vs plain at [{G}, "
                             f"{n}]: max diff "
                             f"{(co_k - co_p).abs().max().item()}")
    co_k, att_tk = pg.gain_jacobi_cuda(m_t, c, ia, ir, True)
    co_p, att_tp = pg.gain_jacobi_plain(m_t, c, ia, ir, True)
    if not (torch.equal(co_k, co_p) and torch.equal(att_tk, att_tp)):
        raise AssertionError(f"gain_jacobi vs plain at [{G}, {n}]: max diff "
                             f"{(att_tk - att_tp).abs().max().item()}")
    # the plain sweep is one continuous walk (each segment starts where the
    # one before it ended), so it is the sequential walk and its states at
    # the 32-sample group boundaries are pass 1's plain answer
    att_p = att_tp.reshape(seg_len, G, S).permute(1, 2, 0).reshape(
        G, seg_len * S)
    if not torch.equal(c_fix[:, 1:], att_p[:, seg_len - 1::seg_len][:, :-1]):
        raise AssertionError("the relaxed carries are not the plain walk's")
    del att_p
    k3 = _p1_kernel(m_main, _sweep_starts(att_tp, G, S, n))
    starts = k3.pop("starts")
    k4 = _p2_kernel(m_main, starts)
    print(f"gain main-path inputs [{G}, {n}]: gain_jacobi (carry sweep and "
          f"full sweep), gain_p1 and gain_p2 == their plain versions bit for "
          f"bit")
    # K4 where the rows of chains 1 and 2 are not 16-byte aligned (its
    # 4-byte route) and the last group is ragged
    k4["ragged"] = _p2_kernel(*_p2_random(N_KERNEL, 3))
    _p2_check(*_p2_random(N_GAIN_PLAIN + 7, 4))

    # times at 2^23; the plain versions of K2 and K4 at 2^23, of K3 at 2^17
    ms = {
        "gain_jacobi": _cuda_ms(lambda: pg.gain_jacobi_cuda(m_t, c, ia, ir,
                                                            True),
                                KERNEL_CALLS),
        "gain_p1": k3["ms"],
        "gain_p2": k4["ms"],
    }
    plain_ms = {
        "gain_jacobi": _cuda_ms(lambda: pg.gain_jacobi_plain(m_t, c, ia, ir,
                                                             True)),
        "gain_p1": _cuda_ms(lambda: pg.gain_p1_plain(m17, None, z3, ia, ir)),
        "gain_p2": _cuda_ms(lambda: pg.gain_p2_plain(m_main, starts, ia,
                                                     ir)),
    }
    engine_ms = _cuda_ms(lambda: pg._gain_engine(m_main, z3, ia, ir))
    plain_n = {"gain_jacobi": n, "gain_p1": N_GAIN_PLAIN, "gain_p2": n}
    bounds = _gain_bounds(G, n)
    for k in ms:
        print(f"{k}: kernel {ms[k]:.4f} ms [{G}, {n}], plain "
              f"{plain_ms[k]:.4f} ms [{G}, {plain_n[k]}] (bound "
              f"{bounds[k][0]:.4f} ms, {bounds[k][0] / ms[k]:.1%})")
    carry = _jacobi_times(m_t, c_first, c)["carry"]
    print(f"gain engine (converged Jacobi, {sweeps_c} sweeps + full sweep) "
          f"{engine_ms:.4f} ms [{G}, {n}]")
    errs = {"gain_jacobi": max(err_a, err_c), "gain_p1": max(err_b, err_c),
            "gain_p2": max(err_b, err_c)}
    return {"ms": ms, "plain_ms": plain_ms, "plain_n": plain_n, "n": n,
            "errs": errs, "reset": reset,
            "bounds": bounds, "engine_ms": engine_ms, "sweeps": sweeps_c,
            "walk_ms": walk_ms, "carry": carry, "p1": k3, "p2": k4}


def _sweep_starts(att_t: torch.Tensor, G: int, S: int, n: int):
    """Pass 1's answer from a full Jacobi sweep from the relaxed carries
    (the sequential walk, time-major [seg_len, G*S], from zero state): the
    state before every 32-sample group."""
    from ame_tpu_torch.ops import pydub_gain as pg
    seg_len = att_t.shape[0]
    att = att_t.reshape(seg_len, G, S).permute(1, 2, 0).reshape(G, -1)
    return torch.cat([att.new_zeros(G, 1), att[:, pg._K - 1:n - 1:pg._K]], 1)


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _p1_kernel(m: torch.Tensor, starts_ref: torch.Tensor) -> dict:
    """K3 on m [G, N] from zero state, bit for bit against starts_ref, then
    timed (one call between events), with its floor: gain_floor, the same
    step N times a chain from registers, no memory traffic (when the
    package's library has it), and the SM clock sampled while the card runs
    floor walks."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    G, n = m.shape
    z = torch.zeros(G, device=m.device)
    starts = pg.gain_p1_cuda(m, None, z, ia, ir)
    if not torch.equal(starts, starts_ref):
        raise AssertionError(f"gain_p1 vs the plain walk at [{G}, {n}]: max "
                             f"diff {(starts - starts_ref).abs().max().item()}")
    ms = _cuda_ms(lambda: pg.gain_p1_cuda(m, None, z, ia, ir))
    out = {"starts": starts, "ms": ms, "floor": None}
    lib = pg._lib()
    if hasattr(lib, "gain_floor_f32"):
        final = torch.empty(G, device=m.device)

        def floor():
            pg._launch("gain_floor_f32", lib.gain_floor_f32, m.data_ptr(),
                       final.data_ptr(), n, G, ia, ir)
        floor_ms = _cuda_ms(floor)
        for _ in range(8):                 # ~0.4 s of floor walks queued
            floor()
        clock = _smi("clocks.sm,clocks.max.sm")
        torch.cuda.synchronize()
        ns = floor_ms * 1e6 / (n // pg._K * pg._K)
        mhz = re.match(r"\s*(\d+)", clock)
        out["floor"] = {"ms": floor_ms, "ns_per_step": ns, "sm_clock": clock,
                        "cycles_per_step": (ns * int(mhz.group(1)) / 1e3
                                            if mhz else None),
                        "p1_multiple": ms / floor_ms}
        print(f"gain_p1 floor (gain_floor, the same step from registers): "
              f"{floor_ms:.4f} ms [{G}, {n}] = {ns:.3f} ns a step "
              f"(SM clock, current / max: {clock}); gain_p1 {ms:.4f} ms = "
              f"{ms / floor_ms:.3f}x the floor")
    return out


def _p2_random(n: int, seed: int):
    """[3, n] random max-attenuations (|4 N(0,1)| on about half the samples,
    0 elsewhere and on a run of n/10) and random non-negative starts
    [3, ceil(n/32)], on the card."""
    rng = np.random.default_rng(seed)
    m = np.maximum(0.0, 4.0 * rng.standard_normal((3, n))).astype(np.float32)
    m[:, n // 3:n // 3 + n // 10] = 0.0
    starts = (8.0 * rng.random((3, -(-n // 32)))).astype(np.float32)
    return torch.from_numpy(m).cuda(), torch.from_numpy(starts).cuda()


def _p2_check(m: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """K4 on m [G, N] from starts, bit for bit against gain_p2_plain."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    att = pg.gain_p2_cuda(m, starts, ia, ir)
    want = pg.gain_p2_plain(m, starts, ia, ir)
    if not torch.equal(att, want):
        raise AssertionError(f"gain_p2 vs plain at {list(m.shape)}: max diff "
                             f"{(att - want).abs().max().item()}")
    print(f"gain_p2 == gain_p2_plain bit for bit {list(m.shape)}")
    return att


def _p2_kernel(m: torch.Tensor, starts: torch.Tensor) -> dict:
    """K4 on m [G, N] checked (_p2_check), then timed: 10 calls in a row,
    one call alone, its device time (torch.profiler: the mean launch of 20
    calls), and beside it a
    device copy of m into a fresh tensor (about K4's bytes: the practical
    ceiling)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    G, n = m.shape
    _p2_check(m, starts)

    def run():
        return pg.gain_p2_cuda(m, starts, ia, ir)
    ms = _cuda_ms(run, KERNEL_CALLS)
    bound = _gain_bounds(G, n)["gain_p2"]
    device_ms, records = _launch_ms(run)
    out = {"n": n, "ms": ms, "one_call_ms": _cuda_ms(run),
           "device_ms": device_ms, "device_records": records,
           "copy_ms": _cuda_ms(lambda: m.clone(), KERNEL_CALLS),
           "bound_ms": bound[0], "bound_share": bound[0] / ms}
    dev = ("not measured" if device_ms is None
           else f"{device_ms:.4f} ms, {records} of 20 launches recorded")
    print(f"gain_p2 [{G}, {n}]: kernel {ms:.4f} ms ({bound[0] / ms:.1%} of "
          f"its bound {bound[0]:.4f} ms; one call alone "
          f"{out['one_call_ms']:.4f} ms, device time (torch.profiler) {dev}); "
          f"device copy of m {out['copy_ms']:.4f} ms")
    return out


def _jacobi_inputs(m_main: torch.Tensor, resets=None):
    """K2's inputs for chains m_main [G, N] (and group flags resets
    [ceil(N/32)], or None): the time-major m_t, S, the first sweep's
    carries (init, then zeros), the relaxed carries and the flags padded
    to the engine's length (or None)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    G, n = m_main.shape
    ia, ir = pg._scal(ATTACK, RELEASE)
    npad = pg._pad_block(n)
    S = pg._select_S(npad)
    seg_len = npad // S
    m_t = torch.nn.functional.pad(m_main, (0, npad - n)).reshape(
        G, S, seg_len).permute(2, 0, 1).reshape(seg_len, G * S).contiguous()
    z3 = torch.zeros(G, device=m_main.device)
    if resets is None:
        c_fix, _, _ = pg._jacobi_carries(m_t, G, S, z3, ia, ir)
    else:
        resets = torch.nn.functional.pad(resets, (0, npad // pg._K
                                                  - resets.shape[0]))
        c_fix, _, _ = pg._jacobi_carries(m_t, G, S, z3, ia, ir, resets)
    return (m_t, S, torch.zeros(G * S, device=m_main.device), c_fix,
            resets)


def _jacobi_times(m_t: torch.Tensor, c_first: torch.Tensor,
                  c_fix: torch.Tensor, resets=None) -> dict:
    """K2's carry sweep (from the first sweep's carries) and full sweep
    (from the relaxed carries), kernel ms and bound at m_t's shape; with
    group flags, those of its reset route (the flags' bytes in the
    bound)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    c_fix = c_fix.reshape(-1).contiguous()
    seg_len, lanes = m_t.shape
    flops = 5 * seg_len * lanes
    kw = {} if resets is None else {"resets": resets}
    flag_bytes = 0 if resets is None else resets.shape[0] * 4
    route = "" if resets is None else " (reset route)"
    out = {}
    for sweep, full, c in (("carry", False, c_first), ("full", True, c_fix)):
        def sweep_fn():
            return pg.gain_jacobi_cuda(m_t, c, ia, ir, full, **kw)
        ms = _cuda_ms(sweep_fn, KERNEL_CALLS)
        one_ms = _cuda_ms(sweep_fn)
        bound = _bound((2 if full else 1) * seg_len * lanes * 4 + flag_bytes,
                       flops)
        out[sweep] = {"ms": ms, "one_call_ms": one_ms, "bound_ms": bound[0],
                      "bound_by": bound[1], "bound_share": bound[0] / ms}
        print(f"gain_jacobi{route} {sweep} sweep: kernel {ms:.4f} ms (one "
              f"call alone {one_ms:.4f} ms) [{seg_len}, {lanes}] (bound "
              f"{bound[0]:.4f} ms, {bound[0] / ms:.1%})")
    return out


def _jacobi_check(m_t, carries: dict, resets, label: str) -> float:
    """K2 (with the group flags: its reset route) against gain_jacobi_plain
    from each of `carries` ({name: [lanes] carry-ins}), the carry sweep and
    the full sweep, bit for bit. Returns the max abs difference (0.0)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    err = 0.0
    for cname, c in carries.items():
        c = c.reshape(-1).contiguous()
        for full in (False, True):
            co_k, att_k = pg.gain_jacobi_cuda(m_t, c, ia, ir, full, resets)
            co_p, att_p = pg.gain_jacobi_plain(m_t, c, ia, ir, full, resets)
            same = torch.equal(co_k, co_p) and (
                not full or torch.equal(att_k, att_p))
            if not same:
                raise AssertionError(
                    f"{label}: gain_jacobi reset route ({cname} carries, "
                    f"{'full' if full else 'carry'} sweep) vs plain: max diff "
                    f"{(co_k - co_p).abs().max().item()}")
            err = max(err, (co_k - co_p).abs().max().item(),
                      (att_k - att_p).abs().max().item() if full else 0.0)
            del att_k, att_p
    return err


def _reset_small() -> dict:
    """(e) K2's reset route on [3, 2^17] with chunk boundaries every
    RESET_CHUNK samples, bit for bit against gain_jacobi_plain with the
    flags: a silent run (m == 0, samples 40 000..60 000) follows a non-zero
    state and holds boundaries. The chain is cut into S = 16 segments of
    8272 samples (258.5 groups), so half the lanes' group starts sit at
    row 16 of a group, as at 2^23 (S = 2048, 4528 samples a segment).
    Carry-ins: the first sweep's, random ones and the relaxed ones."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    rng = np.random.default_rng(11)
    m = np.zeros((3, N_GAIN_PLAIN), np.float32)
    for g in range(3):
        m[g, 1000:40000] = (g + 1) * np.abs(rng.standard_normal(39000))
        m[g, 60000:120000] = (g + 2) * np.abs(rng.standard_normal(60000))
    m1, flags = pg._chunk_layout(torch.from_numpy(m).cuda(), RESET_CHUNK)
    G, npad = m1.shape
    S = 16
    seg_len = npad // S
    if seg_len % pg._K == 0 or S * seg_len != npad:
        raise AssertionError(f"(e) layout {npad} / {S}: want ragged groups")
    m_t = m1.reshape(G, S, seg_len).permute(2, 0, 1).reshape(
        seg_len, G * S).contiguous()
    z = torch.zeros(G, device="cuda")
    c_fix, ok, sweeps = pg._jacobi_carries(m_t, G, S, z, ia, ir, flags)
    if not ok.all().item():
        raise AssertionError(f"(e) relaxation did not converge: {ok}")
    carries = {"first": torch.cat([z[:, None], z.new_zeros(G, S - 1)], 1),
               "random": torch.from_numpy((8.0 * rng.random((G, S))).astype(
                   np.float32)).cuda(),
               "relaxed": c_fix}
    err = _jacobi_check(m_t, carries, flags, f"(e) [{G}, {N_GAIN_PLAIN}]")
    # the state just before the silent run's first boundary is non-zero,
    # and the boundary zeroes it
    _, att_t = pg.gain_jacobi_cuda(m_t, c_fix.reshape(-1).contiguous(), ia,
                                   ir, True, flags)
    att = att_t.reshape(seg_len, G, S).permute(1, 2, 0).reshape(G, npad)
    b = -(-40000 // RESET_CHUNK)              # first chunk start >= 40 000
    t0 = b * (-(-RESET_CHUNK // pg._K) * pg._K)   # where it lies in m1
    if not ((att[:, t0 - 1] > 0).all() and (att[:, t0] == 0).all()):
        raise AssertionError("(e) the boundary in the silent run did not "
                             "zero a non-zero state")
    print(f"gain (e) gain_jacobi reset route == gain_jacobi_plain bit for "
          f"bit [{G}, {N_GAIN_PLAIN}], chunks of {RESET_CHUNK}, S = {S} x "
          f"{seg_len} samples, carry and full sweeps from first / random / "
          f"relaxed carries ({sweeps} sweeps)")
    return {"sweeps": sweeps, "max_abs_err": err}


def _reset_main(m_chunked: torch.Tensor) -> dict:
    """(f) the chunked compat path's band max-attenuations at 2^23 in the
    engine's chunk layout: the Jacobi engine with K2's reset route against
    K3 (with the flags) + K4, bit for bit; the reset route against its
    plain version from the first and the relaxed carries; its carry and
    full sweeps timed apart (and the unchunked route on the same m_t)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    m1, flags = pg._chunk_layout(m_chunked, CHUNK_LEN)
    G, n = m1.shape
    z = torch.zeros(G, device="cuda")
    att_j, ok, sweeps = pg._jacobi(m1, z, ia, ir, flags)
    tp = pg._two_pass(m1, z, ia, ir, flags)
    if not all(ok) or not torch.equal(att_j, tp):
        raise AssertionError(f"(f) converged {ok}; reset-route Jacobi vs "
                             f"K3 + K4 max diff "
                             f"{(att_j - tp).abs().max().item()}")
    del att_j, tp
    m_t, S, c_first, c_fix, fl = _jacobi_inputs(m1, flags)
    err = _jacobi_check(m_t, {"first": c_first, "relaxed": c_fix}, fl,
                        f"(f) [{G}, {n}]")
    seg_len = m_t.shape[0]
    c = c_fix.reshape(-1).contiguous()
    plain_ms = _cuda_ms(lambda: pg.gain_jacobi_plain(m_t, c, ia, ir, True,
                                                     fl))
    print(f"gain (f) chunked main-path bands [{G}, {n}] (7 chunks padded "
          f"to groups): reset-route Jacobi converged in {sweeps} sweeps, == "
          f"K3 (flags) + K4 bit for bit; the reset route == its plain "
          f"version [{seg_len}, {G * S}], S = {S}")
    return {"sweeps": sweeps, "shape": [seg_len, G * S],
            "plain_ms": plain_ms, "max_abs_err": err,
            "reset": _jacobi_times(m_t, c_first, c_fix, fl),
            "no_resets": _jacobi_times(m_t, c_first, c_fix)}


def _compat_x(tmp: str):
    """The compat main path's input WAV, its int16 samples, and what
    master_array hands the graph in compat mode (on the card)."""
    from ame_tpu_torch.io.wav import read_wav, write_wav
    from ame_tpu_torch.ops.quantize import int16_roundtrip
    src = os.path.join(tmp, "compat_in.wav")
    write_wav(src, _compat_input(N_MAIN), SR)
    pcm, _ = read_wav(src, prefer_int16=True)
    x = int16_roundtrip(torch.from_numpy(pcm).cuda().to(torch.float32)
                        * (1.0 / 32768.0))
    return src, pcm, x


def phase_compat_main(tmp: str) -> dict:
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.ops.loudness import integrated_lufs

    src, pcm, x = _compat_x(tmp)
    dst = os.path.join(tmp, "compat_out.wav")
    settings = MasterSettings(**COMPAT)
    m_main = _band_max_att(x)
    band_peaks = m_main.amax(dim=1).tolist()
    if not all(v > 0.0 for v in band_peaks):
        raise AssertionError(f"a band never crosses its threshold: max "
                             f"attenuations {band_peaks}")

    _zero_counts()
    info = master_file(src, dst, settings, device="cuda")
    counts = _read_counts()
    print("compat main path launches: " + json.dumps(counts))
    if (counts["wedge_env"] != 2 or counts["gain_jacobi"] < 1
            or counts["cascade_scan"] != 7 or counts["gain_p1"] != 0
            or counts["gain_p2"] != 0):
        raise AssertionError(f"compat main path launches {counts}: expected "
                             f"2 wedge_env, 7 cascade_scan, at least 1 "
                             f"gain_jacobi and no gain_p1 / gain_p2 (the "
                             f"Jacobi relaxation converges on every band)")

    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad compat master: sr {sr}, shape "
                             f"{out.shape}")
    y, _ = master_graph(x, SR, settings)
    peak = y.abs().max().item()
    out_i = integrated_lufs(torch.from_numpy(out).cuda(), SR).item()
    print(f"compat main path: band max attenuations "
          f"{[round(v, 4) for v in band_peaks]} dB; master peak "
          f"{peak:.6f}, measures {out_i:.4f} LUFS (target "
          f"{COMPAT_TARGET:.4f}); linear_mode {info['linear_mode']:.0f}, "
          f"gain {info['gain_db']:.4f} dB, output_i {info['output_i']:.4f}")
    if not (peak <= 1.0 + 1e-5 and torch.isfinite(y).all().item()):
        raise AssertionError(f"compat master peaks at {peak} > 1.0 + 1e-5")
    if abs(out_i - COMPAT_TARGET) > COMPAT_LUFS_TOL:
        raise AssertionError(f"compat master measures {out_i:.4f} LUFS, "
                             f"target {COMPAT_TARGET:.4f}")

    chain_ms = _cuda_ms(lambda: master_graph(x, SR, settings))
    busy = _chain_busy("compat", lambda: master_graph(x, SR, settings),
                       chain_ms)
    file_s = _host_s(lambda: master_file(src, dst, settings, device="cuda"))
    stages: dict = {}
    master_graph(x, SR, settings, timer=stages)
    duration = N_MAIN / SR
    print(f"compat device chain {chain_ms:.3f} ms = "
          f"{duration / (chain_ms / 1e3):.1f}x realtime; file to file "
          f"{file_s * 1e3:.1f} ms = {duration / file_s:.1f}x realtime "
          f"({duration:.2f} s track)")
    print("compat stages (ms): " + ", ".join(f"{k} {v * 1e3:.3f}"
                                             for k, v in stages.items()))
    return {"counts": counts, "m_main": m_main, "pcm": pcm,
            "chain_ms": chain_ms, "busy": busy, "file_s": file_s,
            "out_i": out_i,
            "peak": peak, "stages": stages}


def _steady_x(tmp: str):
    """The fallback path's input WAV (steady 0.5 N(0,1) noise, seed 1) and
    what master_array hands the graph in compat mode (on the card)."""
    from ame_tpu_torch.io.wav import read_wav, write_wav
    from ame_tpu_torch.ops.quantize import int16_roundtrip
    src = os.path.join(tmp, "steady_in.wav")
    rng = np.random.default_rng(1)
    write_wav(src, np.clip(0.5 * rng.standard_normal((N_MAIN, 2)), -1, 1),
              SR)
    pcm, _ = read_wav(src, prefer_int16=True)
    x = int16_roundtrip(torch.from_numpy(pcm).cuda().to(torch.float32)
                        * (1.0 / 32768.0))
    return src, x


def phase_compat_fallback(tmp: str) -> dict:
    """The compat path on steady 0.5 noise: the low band's max-attenuation
    hovers over its threshold without ever saturating the recurrence, the
    Jacobi relaxation stalls there, and the engine takes K3 + K4. Then its
    device chain is timed as the main paths' are."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav

    src, x = _steady_x(tmp)
    dst = os.path.join(tmp, "steady_out.wav")
    _zero_counts()
    master_file(src, dst, COMPAT, device="cuda")
    counts = _read_counts()
    print("compat fallback path launches: " + json.dumps(counts))
    if (counts["gain_p1"] < 1 or counts["gain_p2"] < 1
            or counts["wedge_env"] != 2 or counts["gain_jacobi"] < 1):
        raise AssertionError(f"compat fallback path launches {counts}")
    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad fallback master: shape {out.shape}")
    settings = MasterSettings(**COMPAT)
    chain_ms = _cuda_ms(lambda: master_graph(x, SR, settings))
    busy = _chain_busy("compat_fallback",
                       lambda: master_graph(x, SR, settings), chain_ms)
    file_s = _host_s(lambda: master_file(src, dst, settings, device="cuda"))
    duration = N_MAIN / SR
    print(f"compat fallback device chain {chain_ms:.3f} ms = "
          f"{duration / (chain_ms / 1e3):.1f}x realtime; file to file "
          f"{file_s * 1e3:.1f} ms")
    return {"counts": counts, "chain_ms": chain_ms, "busy": busy,
            "file_s": file_s}


def _time_path(name: str, src: str, dst: str, x: torch.Tensor,
               settings) -> dict:
    """A path's device chain (master_graph on x, CUDA events), its busy
    time under torch.profiler, file to file (master_file) and stage
    times."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.graph.chain import master_graph
    chain_ms = _cuda_ms(lambda: master_graph(x, SR, settings))
    busy = _chain_busy(name, lambda: master_graph(x, SR, settings), chain_ms)
    file_s = _host_s(lambda: master_file(src, dst, settings, device="cuda"))
    stages: dict = {}
    master_graph(x, SR, settings, timer=stages)
    duration = x.shape[0] / SR
    print(f"{name} device chain {chain_ms:.3f} ms = "
          f"{duration / (chain_ms / 1e3):.1f}x realtime; file to file "
          f"{file_s * 1e3:.1f} ms = {duration / file_s:.1f}x realtime; "
          f"stages (ms): " + ", ".join(f"{k} {v * 1e3:.3f}"
                                       for k, v in stages.items()))
    return {"chain_ms": chain_ms, "busy": busy, "file_s": file_s,
            "stages": stages}


def _band_max_att_chunked(x: torch.Tensor) -> torch.Tensor:
    """[3, N] max-attenuations of the chunked compat chain's bands, as its
    multiband stage computes them (filters and detector windows restarted
    every CHUNK_LEN samples)."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    from ame_tpu_torch.graph.multiband import _crossover_compat
    from ame_tpu_torch.ops import compressor, quantize
    p = chain.params_from_settings(MasterSettings(**COMPAT_CHUNKED),
                                   x.device)
    y = chain._stage_analog_compat(x, p["analog"], SR, CHUNK_LEN)
    y = chain._stage_eq_width_compat(y, p["bass"], p["mid_cut"],
                                     p["presence"], p["treble"], SR, True,
                                     p["width"], CHUNK_LEN)
    bands = _crossover_compat(y, SR, CHUNK_LEN)
    return torch.stack([
        compressor._max_att_chunked(quantize.float_to_int16(b), SR, th, ra,
                                    CHUNK_LEN, 5.0)
        for b, th, ra in zip(bands, p["threshs"].tolist(),
                             p["ratios"].tolist())]).contiguous()


def phase_compat_chunked(tmp: str) -> dict:
    """The chunked compat path (compat_chunked=True, quirk Q6: the 2^23
    track is 7 chunks of 30 s): master_file on the gated input. K1 twice;
    K5 7 times, 6 of them on the 7 chunks as 14 columns (the K-weighting
    runs continuous); K2 through its reset route only; K3 / K4 never (the
    relaxation converges). The master as the compat one: peak, loudness;
    then its times."""
    from unittest import mock

    from ame_tpu_torch import config
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.ops import scan_iir
    from ame_tpu_torch.ops.loudness import integrated_lufs

    if int(config.COMPAT_CHUNK_SECONDS * SR) != CHUNK_LEN:
        raise AssertionError("the package's chunk is not CHUNK_LEN")
    src, pcm, x = _compat_x(tmp)
    dst = os.path.join(tmp, "chunked_out.wav")
    settings = MasterSettings(**COMPAT_CHUNKED)
    cols = 2 * -(-N_MAIN // CHUNK_LEN)
    _zero_counts()
    # sosfilt_chunked calls sosfilt through scan_iir's module name; every
    # other stage holds its own reference, so the spy sees the chunked
    # cascades only (one K5 launch each, k <= 4)
    with mock.patch.object(scan_iir, "sosfilt",
                           wraps=scan_iir.sosfilt) as spy:
        info = master_file(src, dst, settings, device="cuda")
    counts = _read_counts()
    widths = [int(c.args[1].shape[1]) for c in spy.call_args_list]
    del spy
    wide = widths.count(cols)
    print(f"compat_chunked path launches: {json.dumps(counts)}; K5 at C = "
          f"{cols}: {wide} (chunked cascades' widths {widths})")
    if (counts["wedge_env"] != 2 or counts["cascade_scan"] != 7
            or widths != [cols] * 6 or counts["gain_jacobi"] < 1
            or counts["gain_jacobi_resets"] != counts["gain_jacobi"]
            or counts["gain_p1"] != 0 or counts["gain_p2"] != 0):
        raise AssertionError(f"compat_chunked launches {counts}, {wide} at "
                             f"C = {cols}: expected 2 wedge_env, 7 "
                             f"cascade_scan (6 at C = {cols}), gain_jacobi "
                             f"through its reset route only, no gain_p1 / "
                             f"gain_p2")
    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad chunked master: shape {out.shape}")
    y, _ = master_graph(x, SR, settings)
    peak = y.abs().max().item()
    out_i = integrated_lufs(torch.from_numpy(out).cuda(), SR).item()
    print(f"compat_chunked master: peak {peak:.6f}, measures {out_i:.4f} "
          f"LUFS (target {COMPAT_TARGET:.4f}); linear_mode "
          f"{info['linear_mode']:.0f}, gain {info['gain_db']:.4f} dB")
    if not (peak <= 1.0 + 1e-5 and torch.isfinite(y).all().item()):
        raise AssertionError(f"chunked master peaks at {peak} > 1.0 + 1e-5")
    if abs(out_i - COMPAT_TARGET) > COMPAT_LUFS_TOL:
        raise AssertionError(f"chunked master measures {out_i:.4f} LUFS, "
                             f"target {COMPAT_TARGET:.4f}")
    del y
    times = _time_path("compat_chunked", src, dst, x, settings)
    return {"counts": counts, "widths": widths, "pcm": pcm,
            "m_chunked": _band_max_att_chunked(x), "out_i": out_i,
            "peak": peak, **times}


def phase_compat_chunked_fallback(tmp: str) -> dict:
    """The chunked compat path on the steady 0.5 noise: a band's carries
    stall within its chunks, and the engine takes K3 (with the chunk
    flags) + K4 for it; then its times."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.io.wav import read_wav

    src, x = _steady_x(tmp)
    dst = os.path.join(tmp, "chunked_steady_out.wav")
    settings = MasterSettings(**COMPAT_CHUNKED)
    _zero_counts()
    master_file(src, dst, settings, device="cuda")
    counts = _read_counts()
    print("compat_chunked_fallback path launches: " + json.dumps(counts))
    if (counts["gain_p1"] < 1 or counts["gain_p1_resets"] != counts["gain_p1"]
            or counts["gain_p2"] < 1 or counts["wedge_env"] != 2
            or counts["gain_jacobi"] < 1
            or counts["gain_jacobi_resets"] != counts["gain_jacobi"]):
        raise AssertionError(f"compat_chunked_fallback launches {counts}: "
                             f"expected K3 with flags and K4")
    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad chunked fallback master: {out.shape}")
    return {"counts": counts,
            **_time_path("compat_chunked_fallback", src, dst, x, settings)}


def _mb_launches(edges) -> int:
    """K5 launches of the quality multiband stage: one a piece of at most
    8 sections of each band's cascade (3 bands: 2, 4, 4 sections), and the
    attack smoother."""
    from ame_tpu_torch.graph import multiband as mb
    from ame_tpu_torch.ops.cascade_scan import _MAX_SECTIONS
    ks = [c.shape[0] for c in (mb._band_cascades_3(SR) if edges is None
                               else mb._band_cascades_n(SR, tuple(edges)))]
    return sum(-(-k // _MAX_SECTIONS) for k in ks) + 1


def phase_quality_mb(tmp: str) -> dict:
    """Quality multiband paths. master_file with the flagship settings and
    multiband=True on the quality main path's WAV: 3 + 4 K5 launches and
    nothing else, the master at -14 LUFS within 0.5 LU, its times. Then
    master_graph with 16 bands (mb_edges: 15 edges from 60 Hz to 16 kHz):
    its K5 launches once the bands' cascades (up to 30 sections) are cut
    into pieces of at most 8, a finite output, its device chain."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.ops.loudness import measure

    src = os.path.join(tmp, "in.wav")          # phase_main's input
    dst = os.path.join(tmp, "mb_out.wav")
    pcm, _ = read_wav(src, prefer_int16=True)
    x = torch.from_numpy(pcm).cuda().to(torch.float32) * (1.0 / 32768.0)
    settings = MasterSettings(**QUALITY_MB)
    _zero_counts()
    info = master_file(src, dst, settings, device="cuda")
    counts = _read_counts()
    want = 3 + _mb_launches(None)
    print(f"quality_mb path launches: {json.dumps(counts)} (K5 expected "
          f"{want})")
    if counts["cascade_scan"] != want or any(
            v for k, v in counts.items() if k != "cascade_scan"):
        raise AssertionError(f"quality_mb launches {counts}")
    out, sr = read_wav(dst)
    if sr != SR or out.shape != (N_MAIN, 2) or not np.isfinite(out).all():
        raise AssertionError(f"bad quality_mb master: {out.shape}")
    out_i = measure(torch.from_numpy(out).cuda(), SR)["input_i"].item()
    print(f"quality_mb master measures {out_i:.4f} LUFS (gain "
          f"{info['gain_db']:.4f} dB)")
    if abs(out_i + 14.0) > LUFS_TOL:
        raise AssertionError(f"quality_mb master measures {out_i} LUFS")
    mb3 = {"counts": counts, "out_i": out_i,
           **_time_path("quality_mb", src, dst, x, settings)}

    s16 = MasterSettings(**QUALITY_MB16)
    _zero_counts()
    y, _ = master_graph(x, SR, s16)
    counts16 = _read_counts()
    want16 = 3 + _mb_launches(EDGES_16)
    print(f"quality_mb16 path launches: {json.dumps(counts16)} (K5 expected "
          f"{want16})")
    if counts16["cascade_scan"] != want16 or not torch.isfinite(y).all():
        raise AssertionError(f"quality_mb16: launches {counts16}, finite "
                             f"{torch.isfinite(y).all().item()}")
    del y
    chain_ms = _cuda_ms(lambda: master_graph(x, SR, s16))
    busy = _chain_busy("quality_mb16", lambda: master_graph(x, SR, s16),
                       chain_ms)
    print(f"quality_mb16 device chain {chain_ms:.3f} ms = "
          f"{N_MAIN / SR / (chain_ms / 1e3):.1f}x realtime")
    return {"mb3": mb3, "mb16": {"counts": counts16, "chain_ms": chain_ms,
                                 "busy": busy}}


def phase_quality_mb_parity() -> dict:
    """Card vs CPU on the first 2^20 samples of the quality input, 3-band
    and 16-band multiband: max |y| diff <= 2e-4, gain within 0.01 dB."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph

    rng = np.random.default_rng(0)
    x = np.trunc(np.clip(0.1 * rng.standard_normal((N_MAIN, 2)), -1, 1)
                 * 32767.0)[:N_PARITY].astype(np.float32) / 32768.0
    out = {}
    for name, s in (("quality_mb", QUALITY_MB), ("quality_mb16",
                                                 QUALITY_MB16)):
        settings = MasterSettings(**s)
        y_c, i_c = master_graph(torch.from_numpy(x).cuda(), SR, settings)
        y_h, i_h = master_graph(torch.from_numpy(x), SR, settings)
        diff = (y_c.cpu() - y_h).abs().max().item()
        gain = abs(i_c["gain_db"].item() - i_h["gain_db"].item())
        print(f"{name} card vs CPU [{N_PARITY}, 2]: max |y| diff "
              f"{diff:.3e}, gain diff {gain:.3e} dB")
        if not (diff <= PARITY_TOL and gain <= GAIN_TOL_DB):
            raise AssertionError(f"{name} card vs CPU: {diff} > "
                                 f"{PARITY_TOL} or {gain} dB")
        out[name] = {"max_abs_diff": diff, "gain_diff_db": gain}
    return out


def phase_compat_parity(pcm: np.ndarray, settings_dict=COMPAT,
                        n: int = N_PARITY, name: str = "compat") -> dict:
    """Card vs CPU on the first n samples of the compat input: relative L2
    < 3e-3 or max abs <= 2/32768, gain_db and output_i within 0.01 dB.
    The chunked path is held on 2^21 samples, so that its first chunk
    boundary (1 323 000) falls inside."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.ops.quantize import int16_roundtrip

    x = int16_roundtrip(torch.from_numpy(pcm[:n]).to(torch.float32)
                        * (1.0 / 32768.0))
    settings = MasterSettings(**settings_dict)
    y_c, i_c = master_graph(x.cuda(), SR, settings)
    y_h, i_h = master_graph(x, SR, settings)
    y_c = y_c.cpu().double()
    y_h = y_h.double()
    rel = ((y_c - y_h).norm() / (y_h.norm() + 1e-12)).item()
    mx = (y_c - y_h).abs().max().item()
    d_gain = abs(i_c["gain_db"].item() - i_h["gain_db"].item())
    d_oi = abs(i_c["output_i"].item() - i_h["output_i"].item())
    print(f"{name} card vs CPU [{n}, 2]: relative L2 {rel:.3e}, max "
          f"|y| diff {mx:.3e}; gain_db {i_c['gain_db'].item():.4f} vs "
          f"{i_h['gain_db'].item():.4f}, output_i "
          f"{i_c['output_i'].item():.4f} vs {i_h['output_i'].item():.4f}")
    if not ((rel < 3e-3 or mx <= 2 * LSB) and d_gain <= GAIN_TOL_DB
            and d_oi <= GAIN_TOL_DB):
        raise AssertionError(f"{name} card vs CPU: rel {rel}, max {mx}, "
                             f"gain {d_gain} dB, output_i {d_oi} dB")
    return {"rel_l2": rel, "max_abs_diff": mx}


# ---------------------------------------------------------------------------
# The Musicologist (analysis/musicologist.py): torch.fft, cuBLAS, cuDNN; no
# kernel of the repo's own
# ---------------------------------------------------------------------------
ASR = 22050                      # the Musicologist's analysis rate
N_WINDOW = int(30.0 * ASR)       # its 30 s window
MUS_IMG_TOL = 1e-5
MUS_LOGIT_TOL = 1e-3
MUS_REL_TOL = 1e-4
TEMPO_TIE = 1e-4                 # relative gap of a near-tie in the tempo
BRIEF_KEYS = {"mood", "tempo", "brightness", "density", "key"}


def _click_tone(bpm: float = 128.0, n: int = N_WINDOW) -> np.ndarray:
    """Clicks at bpm, each a Hann burst with a 1 kHz tone under it."""
    y = np.zeros(n, np.float32)
    t = np.arange(80) / ASR
    burst = (np.hanning(80) * (0.5 + 0.4 * np.sin(2 * np.pi * 1000 * t))
             ).astype(np.float32)
    for i in range(0, n - 80, int(60.0 / bpm * ASR)):
        y[i:i + 80] += burst
    return y


def _analysis_inputs() -> dict:
    """The three 30 s, 22 050 Hz inputs of the card-vs-CPU check: bench.py's
    0.1 N(0,1) (seed 2), a 128 BPM click-tone, and the compat input's mono
    mixdown resampled on the CPU (its card resample is held to 1e-5)."""
    from ame_tpu_torch.ops.resample import input_needed, resample
    noise = (0.1 * np.random.default_rng(2).standard_normal(N_WINDOW)
             ).astype(np.float32)
    mono = np.mean(_compat_input(input_needed(N_WINDOW, SR, ASR)),
                   axis=1).astype(np.float32)
    y_h = resample(torch.from_numpy(mono), SR, ASR)[:N_WINDOW]
    y_c = resample(torch.from_numpy(mono).cuda(), SR, ASR)[:N_WINDOW]
    err = (y_c.cpu() - y_h).abs().max().item()
    print(f"musicologist resample 44.1 -> 22.05 kHz, card vs CPU: max abs "
          f"{err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"resample card vs CPU {err} > 1e-5")
    return {"noise": noise, "click128": _click_tone(),
            "compat": y_h.numpy()}, err


def _analysis_parity(name: str, y: np.ndarray) -> dict:
    """One input through each stage on the card and on the CPU."""
    from ame_tpu_torch.analysis import features as F
    from ame_tpu_torch.analysis import musicologist as M
    from ame_tpu_torch.models import mood_cnn

    out = {}
    for dev in ("cuda", "cpu"):
        y_d = torch.from_numpy(y).to(dev)
        model, _ = mood_cnn.load_params(device=dev)
        img = M.spectrogram_image(y_d)
        with torch.no_grad():
            logits = model(img[None])[0]
        feats = [v.item() for v in F.extract_all(y_d, float(ASR))]
        out[dev] = {"img": img.cpu(), "logits": logits.cpu(),
                    "feats": feats, "brief": M.analyze_waveform(y_d)}
    c, h = out["cuda"], out["cpu"]
    img_err = (c["img"] - h["img"]).abs().max().item()
    logit_err = (c["logits"] - h["logits"]).abs().max().item()
    rel = [abs(c["feats"][i] - h["feats"][i]) / abs(h["feats"][i])
           for i in (1, 2)]
    _, score = F.tempo_scores(
        F.onset_envelope(torch.from_numpy(y), float(ASR)), float(ASR))
    top = torch.topk(score, 2).values
    gap = ((top[0] - top[1]) / top[0].abs()).item()
    tie = gap <= TEMPO_TIE
    row = {"image_max_abs": img_err, "logits_max_abs": logit_err,
           "centroid_rel": rel[0], "rms_rel": rel[1],
           "tempo_card": c["feats"][0], "tempo_cpu": h["feats"][0],
           "tempo_top2_gap": gap, "brief_card": c["brief"],
           "brief_cpu": h["brief"]}
    print(f"musicologist card vs CPU [{name}]: image {img_err:.3e}, logits "
          f"{logit_err:.3e}, centroid rel {rel[0]:.3e}, rms rel "
          f"{rel[1]:.3e}, tempo {c['feats'][0]:.3f} / {h['feats'][0]:.3f} "
          f"BPM (top-2 score gap {gap:.3e}); brief {c['brief']}")
    if tie and c["feats"][0] != h["feats"][0]:
        print(f"  tempo near-tie on the CPU (gap {gap:.3e} <= {TEMPO_TIE}): "
              f"the card took the other lag")
    fields = ("mood", "brightness", "density", "key") + (
        () if tie else ("tempo",))
    bad = [k for k in fields if c["brief"][k] != h["brief"][k]]
    if not tie and c["feats"][0] != h["feats"][0]:
        bad.append("tempo_bpm")
    if (bad or not img_err <= MUS_IMG_TOL or not logit_err <= MUS_LOGIT_TOL
            or not max(rel) <= MUS_REL_TOL):
        raise AssertionError(f"musicologist card vs CPU [{name}]: {row}, "
                             f"unequal {bad}")
    return row


def _musicologist_paths(tmp: str) -> list:
    """Eight paths for analyze_batch: the 2^23 quality and compat WAVs,
    five of mixed rates and lengths (groups of 661 500, 441 000 and
    264 600 samples at 22.05 kHz) and one that does not exist."""
    from ame_tpu_torch.io.wav import write_wav
    rng = np.random.default_rng(7)
    paths = [os.path.join(tmp, "in.wav"), os.path.join(tmp, "compat_in.wav")]
    for i, (secs, sr, ch) in enumerate([(40.0, 48000, 2), (30.0, ASR, 1),
                                        (20.0, ASR, 1), (12.0, SR, 2),
                                        (20.0, SR, 2)]):
        n = int(secs * sr)
        x = (0.05 * (i + 1) * rng.standard_normal((n, ch))
             + 0.3 * np.sin(2 * np.pi * (110.0 * (i + 1))
                            * np.arange(n) / sr)[:, None])
        p = os.path.join(tmp, f"mus_{i}.wav")
        write_wav(p, np.clip(x, -1, 1), sr)
        paths.append(p)
    paths.insert(4, os.path.join(tmp, "missing.wav"))
    return paths


def _profile_analysis() -> dict:
    """The analysis's busy time and idle share, from torch.profiler in a
    process of its own: one that has run no plain gain walk, after which
    the profiler drops records (PERF.md section 7)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--musicologist-profile"], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"musicologist profile failed: {r.stderr}")
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def musicologist_profile() -> int:
    """``--musicologist-profile``: analyze_waveform on the 30 s noise,
    event-timed and under torch.profiler; prints one JSON line."""
    from ame_tpu_torch.analysis import musicologist as M
    y = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal(
        N_WINDOW)).astype(np.float32)).cuda()
    ms = _cuda_ms(lambda: M.analyze_waveform(y))
    busy = _chain_busy("musicologist analyze_waveform",
                       lambda: M.analyze_waveform(y), ms)
    records = sum(k for _, k in _profile(lambda: M.analyze_waveform(y),
                                         REPS).values())
    print(json.dumps({"event_ms": ms, "device_records_per_call":
                      records / REPS, **busy}))
    return 0


def phase_musicologist(tmp: str) -> dict:
    """(a) the shipped weights on the card; (b) card vs CPU on three 30 s
    inputs; (c) analyze_song on the 2^23 WAV; (d) analyze_batch over eight
    paths; (e) process_audio with auto_generate_prompt; (f) times."""
    from ame_tpu_torch.analysis import musicologist as M
    from ame_tpu_torch.api import process_audio
    from ame_tpu_torch.models import mood_cnn

    # (a)
    model, trained = mood_cnn.load_params(device="cuda")
    state = model.state_dict()
    if not (trained and len(state) == 10 and all(
            t.is_cuda and torch.isfinite(t).all().item()
            for t in state.values())):
        raise AssertionError(f"mood CNN weights on the card: trained "
                             f"{trained}, {len(state)} tensors")
    print(f"musicologist weights: trained, {len(state)} finite tensors, "
          f"{sum(t.numel() for t in state.values())} parameters")
    # (b)
    inputs, resample_err = _analysis_inputs()
    parity = {name: _analysis_parity(name, y) for name, y in inputs.items()}
    # (c)
    src = os.path.join(tmp, "in.wav")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    brief = M.analyze_song(src)
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"musicologist analyze_song on the 2^23-sample WAV: {brief}; "
          f"peak device memory {peak} B ({peak - base} B over the "
          f"{base} B held before the call); launches {counts}")
    if set(brief) != BRIEF_KEYS or any(counts.values()):
        raise AssertionError(f"analyze_song: {brief}, launches {counts}")
    # (d)
    paths = _musicologist_paths(tmp)
    briefs = M.analyze_batch(paths)
    singles = [M.analyze_song(p) for p in paths]
    if briefs != singles or set(briefs[4]) != {"error"} or any(
            set(b) != BRIEF_KEYS for i, b in enumerate(briefs) if i != 4):
        raise AssertionError(f"analyze_batch {briefs} != per-track "
                             f"{singles}")
    print(f"musicologist analyze_batch over {len(paths)} paths equals the "
          f"per-track briefs; missing file: {briefs[4]}")
    # (e)
    status, tags = [], []
    _zero_counts()
    process_audio({"input_file": src,
                   "output_file": os.path.join(tmp, "mus_out.wav"),
                   "auto_generate_prompt": True, **FLAGSHIP},
                  status.append, lambda *a: None, lambda *a: None,
                  tags.append)
    pa_counts = _read_counts()
    print(f"musicologist process_audio: tags {tags}; statuses {status}; "
          f"launches {pa_counts}")
    if (len(tags) != 1 or not tags[0].startswith("Mood: ")
            or not any(s.startswith("Success:") for s in status)
            or any(s.startswith(("Error:", "Failed:")) for s in status)
            or pa_counts["cascade_scan"] != 3):
        raise AssertionError(f"process_audio: tags {tags}, statuses "
                             f"{status}, launches {pa_counts}")
    # (f)
    y_c = torch.from_numpy(inputs["noise"]).cuda()
    wave_ms = _cuda_ms(lambda: M.analyze_waveform(y_c))
    wave_s = _host_s(lambda: M.analyze_waveform(y_c))
    song_s = _host_s(lambda: M.analyze_song(src))
    batch_s = _host_s(lambda: M.analyze_batch(paths))
    busy = _profile_analysis()
    print(f"musicologist analyze_waveform (30 s): {wave_ms:.3f} ms events "
          f"= {30.0 / (wave_ms / 1e3):.1f}x realtime, host "
          f"{wave_s * 1e3:.3f} ms = {30.0 / wave_s:.1f}x realtime; "
          f"analyze_song (2^23 WAV) {song_s * 1e3:.1f} ms; analyze_batch "
          f"{batch_s * 1e3 / len(paths):.1f} ms a path ({len(paths)} paths)")
    return {"weights_trained": trained, "resample_max_abs": resample_err,
            "parity": parity, "song_brief": brief, "song_counts": counts,
            "song_peak_bytes": peak, "song_peak_over_base_bytes":
            peak - base, "batch_paths": len(paths), "process_audio_tags": tags,
            "process_audio_counts": pa_counts,
            "analyze_waveform_ms": wave_ms,
            "analyze_waveform_host_ms": wave_s * 1e3,
            "analyze_waveform_x_realtime": 30.0 / (wave_ms / 1e3),
            "analyze_waveform_host_x_realtime": 30.0 / wave_s,
            "analyze_song_ms": song_s * 1e3,
            "analyze_batch_ms_per_path": batch_s * 1e3 / len(paths),
            "profile": busy}


# ---------------------------------------------------------------------------
# Streaming (streaming.py): the quality stream's cascades on K5 with zi
# carried block to block; the compat stream's blocks on K5, K1 (reverse:
# the streaming limiter's attack side), K2, and K3 + K4 on steady input
# ---------------------------------------------------------------------------
STREAM_BLOCK = 4096
STREAM_GAIN_DB = -2.0
STREAM_QUALITY = {k: v for k, v in FLAGSHIP.items() if k != "lufs"}
STREAM_PATHS = {"stream_quality": (STREAM_QUALITY, 1e-4),
                "stream_quality_mb": (dict(STREAM_QUALITY, multiband=True),
                                      2e-4),
                "stream_quality_mb16": (dict(STREAM_QUALITY,
                                             mb_edges=EDGES_16), 2e-4)}
N_STREAM = N_MAIN
N_STREAM_PARITY = N_PARITY
STREAM_PUSH = 100_000          # compat pushes, not aligned to the block
STREAM_TAILS = (1, 31)         # compat flush remainders after one block
COMPAT_STREAM = dict(COMPAT_CHUNKED, lufs=None)
STREAM_K5_N = (1, 63, 440, 512, 4097, 48000)
STREAM_K1_N = (1, 31, 2000, 3520, 8193)
STREAM_GAIN_N = (1, 31, 1000)  # compat remainders: the gain kernels' tails
STREAM_CHAIN_BLOCKS = 2048
BENCH_SR = 48000               # benchmarks/bench_streaming.py's set-up
BENCH_BLOCKS = (512, 1024, 4096, 48000)
BENCH_SETTINGS = {"bass_boost": 2.0, "width": 1.2, "analog_character": 15.0}
BENCH_GAIN_DB = -1.0
BENCH_WARM, BENCH_REPS = 3, 200
BENCH_PATHS = {"quality": BENCH_SETTINGS,
               "quality_mb": dict(BENCH_SETTINGS, multiband=True),
               "quality_mb16": dict(BENCH_SETTINGS, mb_edges=EDGES_16)}
PROFILE_BLOCKS = 50


def _stream_input(n: int) -> np.ndarray:
    """The quality cell's track (0.1 N(0,1), seed 0) with a hot section
    (x9 over its middle sixth, as tests/test_streaming.py's program) that
    drives the limiter, clipped to [-1, 1]."""
    x = 0.1 * np.random.default_rng(0).standard_normal((n, 2))
    x[n // 3:n // 2] *= 9.0
    return np.clip(x, -1.0, 1.0).astype(np.float32)


def _stream(sm, x: np.ndarray, block: int) -> np.ndarray:
    """x through the streamer in blocks of `block` (numpy in, numpy out, as
    a caller on the host feeds it), then the flush."""
    outs = [sm.process(x[i:i + block]) for i in range(0, x.shape[0], block)]
    outs.append(sm.flush())
    return np.concatenate(outs, axis=0)


def _stream_offline(x: torch.Tensor, settings: dict, gain_db: float):
    """The port's offline quality composition on x's device:
    analog_character_quality -> apply_eq_quality -> stereo_width_quality ->
    multiband -> static gain -> lookahead_limiter."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    from ame_tpu_torch.graph import multiband as mb
    from ame_tpu_torch.ops import eq, saturate, stereo
    from ame_tpu_torch.ops.limiter import lookahead_limiter
    s = MasterSettings(**settings)
    p = chain.params_from_settings(s, x.device)
    y = x
    if s.analog_character:
        y = saturate.analog_character_quality(y, SR, s.analog_character)
    y = eq.apply_eq_quality(y, SR, s.bass_boost, s.mid_cut,
                            s.presence_boost, s.treble_boost)
    if s.width != 1.0:
        y = stereo.stereo_width_quality(y, s.width)
    if s.mb_edges is not None:
        y = mb.multiband_quality_n(y, SR, s.mb_edges, p["threshs"],
                                   p["ratios"])
    elif s.multiband:
        y = mb.multiband_quality(y, SR, p["threshs"], p["ratios"])
    return lookahead_limiter(y * 10.0 ** (gain_db / 20.0), SR)


def _stream_k5_per_block(settings: dict) -> int:
    """K5 launches of one quality stream block: the analog shelves and the
    EQ, and with multiband one a band piece of at most 8 sections plus the
    attack smoother."""
    s = settings
    n = (1 if s.get("analog_character", 0) else 0) + 1
    if s.get("mb_edges") is not None:
        n += _mb_launches(s["mb_edges"])
    elif s.get("multiband"):
        n += _mb_launches(None)
    return n


def _stream_quality() -> dict:
    """(a) The 2^23-sample track streamed in blocks of 4096 (flagship,
    gain -2 dB; plain, 3-band and 16-band multiband): every sample emitted,
    within 1e-4 (plain) / 2e-4 (multiband) of the offline composition on
    the card; K5 exactly its per-block count a block and no other kernel;
    card against CPU on the first 2^20 samples within 2e-4."""
    from ame_tpu_torch.streaming import StreamingMaster
    x_np = _stream_input(N_STREAM)
    x = torch.from_numpy(x_np).cuda()
    blocks = -(-N_STREAM // STREAM_BLOCK)
    out = {}
    for name, (settings, tol) in STREAM_PATHS.items():
        want = _stream_offline(x, settings, STREAM_GAIN_DB).cpu().numpy()
        sm = StreamingMaster(SR, settings, gain_db=STREAM_GAIN_DB,
                             device="cuda")
        _zero_counts()
        t0 = time.perf_counter()
        got = _stream(sm, x_np, STREAM_BLOCK)
        secs = time.perf_counter() - t0
        counts = _read_counts()
        per_block = _stream_k5_per_block(settings)
        err = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float("inf")
        n_par = N_STREAM_PARITY
        card = _stream(StreamingMaster(SR, settings, gain_db=STREAM_GAIN_DB,
                                       device="cuda"), x_np[:n_par],
                       STREAM_BLOCK)
        host = _stream(StreamingMaster(SR, settings, gain_db=STREAM_GAIN_DB,
                                       device="cpu"), x_np[:n_par],
                       STREAM_BLOCK)
        cpu_err = float(np.abs(card - host).max())
        print(f"{name}: [{N_STREAM}, 2] in {blocks} blocks of "
              f"{STREAM_BLOCK}: {secs:.3f} s = {N_STREAM / SR / secs:.1f}x "
              f"realtime; emitted {got.shape[0]}; vs offline {err:.3e} "
              f"(<= {tol}); card vs CPU [{n_par}, 2] {cpu_err:.3e}; "
              f"launches {json.dumps(counts)} ({per_block} K5 a block)")
        if got.shape != x_np.shape or not err <= tol:
            raise AssertionError(f"{name}: emitted {got.shape}, vs offline "
                                 f"{err} > {tol}")
        if not cpu_err <= PARITY_TOL:
            raise AssertionError(f"{name}: card vs CPU {cpu_err}")
        if counts["cascade_scan"] != blocks * per_block or any(
                v for k, v in counts.items() if k != "cascade_scan"):
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{per_block} K5 a block and nothing else")
        out[name] = {"counts": counts, "blocks": blocks,
                     "k5_per_block": per_block, "seconds": secs,
                     "x_realtime": N_STREAM / SR / secs,
                     "max_abs_err": err, "card_vs_cpu": cpu_err,
                     "peak": float(np.abs(got).max())}
    return out


def _stream_k5() -> dict:
    """(b) K5 at stream shapes against its plain version on the card, from
    a non-zero zi (y and zf within 1e-4), timed: the quality stream's
    cascades (analog k=2, EQ k=4, a 16-band piece of 8 sections) at C = 2
    on N in STREAM_K5_N, the attack smoother at C = 3 and 16; then the EQ
    over 2048 blocks of 4096 with zf -> zi against one call on the whole
    2^23 samples (within 1e-4, no drift)."""
    from ame_tpu_torch import config as C
    from ame_tpu_torch.graph import multiband as mb
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.compressor import attack_sos
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
    q = _quality_cascades()
    piece8 = np.asarray(mb._band_cascades_n(SR, EDGES_16)[-1])[:8]
    smoother = attack_sos(SR, C.MB_ATTACK_MS)
    rows = []
    for name, sos, c in (("analog_shelves_k2", q["analog_shelves_k2"], 2),
                         ("eq_k4", q["eq_k4"], 2),
                         ("mb16_piece_k8", piece8, 2),
                         ("attack_smoother_C3", smoother, 3),
                         ("attack_smoother_C16", smoother, 16)):
        for n in STREAM_K5_N:
            rows.append(_cascade_row(name, sos, *_noise_input(n, c, 5),
                                     stream_n=n))
    sos = q["eq_k4"]
    nb = STREAM_CHAIN_BLOCKS
    x, pre = _noise_input(nb * STREAM_BLOCK, 2, 6)
    _, zi0 = sosfilt_tileconv(sos, pre)
    zi0 = zi0.contiguous()
    y_one, zf_one = sosfilt_cuda(sos, x, zi0)
    zi, ys = zi0, []
    for b in range(nb):
        y, zi = sosfilt_cuda(sos, x[b * STREAM_BLOCK:(b + 1) * STREAM_BLOCK],
                             zi)
        ys.append(y)
    err = (torch.cat(ys) - y_one).abs().amax(dim=1)
    first = err[:STREAM_BLOCK].max().item()
    last = err[-STREAM_BLOCK:].max().item()
    chain_err = max(err.max().item(), (zi - zf_one).abs().max().item())
    print(f"K5 at stream shapes: {len(rows)} shapes, max err "
          f"{max(r['max_abs_err'] for r in rows):.3e}; eq_k4 over {nb} "
          f"blocks of {STREAM_BLOCK} with zf -> zi vs one call: {chain_err:.3e}"
          f" (first block {first:.3e}, last {last:.3e})")
    if not (chain_err <= KERNEL_TOL and last <= max(4 * first, 1e-6)):
        raise AssertionError(f"K5 block chain vs one call {chain_err}, "
                             f"last block {last} vs first {first}")
    return {"rows": rows, "chain": {"blocks": nb, "max_abs_err": chain_err,
                                    "first_block": first,
                                    "last_block": last}}


def _stream_k1() -> list:
    """K1's reverse direction (the streaming limiter's attack side) at
    short lengths, against its plain version on the card (1e-5), timed."""
    from ame_tpu_torch.ops.limiter import _wedge_pieces
    from ame_tpu_torch.ops.wedge_env import wedge_env_cuda, wedge_env_plain
    pieces = _wedge_pieces(float(round(5.0 * SR / 1000.0)))
    rows = []
    for n in STREAM_K1_N:
        peak = torch.from_numpy(np.abs(0.5 * np.random.default_rng(n)
                                       .standard_normal(n)).astype(
                                           np.float32)).cuda()
        peak[n // 2] = 2.0                     # one deep sample at least
        dep = torch.clamp(1.0 - 0.98 / torch.clamp(peak, min=1e-9), min=0.0)
        env_k = wedge_env_cuda(dep, pieces, True)
        env_p = wedge_env_plain(dep, pieces, True)
        err = (env_k - env_p).abs().max().item()
        if not err <= WEDGE_TOL:
            raise AssertionError(f"K1 reverse at n = {n}: {err} > "
                                 f"{WEDGE_TOL}")
        ms = _cuda_ms(lambda: wedge_env_cuda(dep, pieces, True),
                      KERNEL_CALLS)
        plain_ms = _cuda_ms(lambda: wedge_env_plain(dep, pieces, True))
        bound = _bound(2 * n * 4, 4 * len(pieces) * n)
        rows.append({"n": n, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0]})
        print(f"K1 reverse n = {n}: err {err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms")
    return rows


def _stream_gain_tails() -> list:
    """K2, and K3 + K4, at the lengths of a compat flush's remainder
    (shorter than one 32-sample group, and ragged), from random
    max-attenuations and a non-zero entering state: the engine's Jacobi
    half (K2; the chains it reports converged) and its two-pass half
    (K3 + K4) against the plain sequential walk on the card, bit for
    bit."""
    from ame_tpu_torch.ops import pydub_gain as pg
    ia, ir = pg._scal(ATTACK, RELEASE)
    rows = []
    for n in STREAM_GAIN_N:
        m, _ = _p2_random(n, n)
        init = torch.tensor([0.0, 1.5, 6.0], device=m.device)
        want = pg._gain_scan(m.T.contiguous(), ia, ir, init).T
        _zero_counts()
        att_j, ok, sweeps = pg._jacobi(m, init, ia, ir)
        att_t = pg._two_pass(m, init, ia, ir)
        counts = _read_counts()
        err_t = (att_t - want).abs().max().item()
        err_j = max([(att_j[g] - want[g]).abs().max().item()
                     for g in range(3) if ok[g]], default=0.0)
        print(f"gain kernels at n = {n}: K2 {counts['gain_jacobi']} sweeps "
              f"launched, converged {ok}, vs walk {err_j:.3e}; K3 + K4 vs "
              f"walk {err_t:.3e}")
        if (err_t != 0.0 or err_j != 0.0 or counts["gain_jacobi"] < 1
                or counts["gain_p1"] != 1 or counts["gain_p2"] != 1):
            raise AssertionError(f"gain kernels at n = {n}: K2 {err_j}, "
                                 f"K3 + K4 {err_t}, launches {counts}")
        rows.append({"n": n, "converged": ok, "jacobi_launches":
                     counts["gain_jacobi"], "max_abs_err": max(err_t, err_j)})
    return rows


def _wedge_spy():
    """A context that records every K1 launch made through the limiter
    module (depths, pieces, direction, the kernel's envelope)."""
    from unittest import mock

    from ame_tpu_torch.ops import limiter
    real, calls = limiter.wedge_env_cuda, []

    def spy(dep, pieces, reverse):
        env = real(dep, pieces, reverse)
        calls.append((dep.clone(), pieces, reverse, env))
        return env
    return mock.patch.object(limiter, "wedge_env_cuda", spy), calls


def _compat_stream_check(name: str, x_np: np.ndarray, push: int) -> dict:
    """x through StreamingCompatMaster in `push`-sample pieces on the card
    against the offline chunked compat chain (master_graph, lufs off) on
    the card: tests/test_streaming.py:203-206's bounds (max <= 8/32768,
    99.9th percentile <= 1/32768 + 1e-6, median 0). Every K1 launch is
    held against its plain version (1e-5)."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.ops.wedge_env import wedge_env_plain
    from ame_tpu_torch.streaming import StreamingCompatMaster
    settings = MasterSettings(**COMPAT_STREAM)
    want = master_graph(torch.from_numpy(x_np).cuda(), SR,
                        settings)[0].cpu().numpy()
    sm = StreamingCompatMaster(SR, settings, device="cuda")
    patch, calls = _wedge_spy()
    _zero_counts()
    with patch:
        got = _stream(sm, x_np, push)
    counts = _read_counts()
    k1_err = max(((env - wedge_env_plain(dep, pieces, rev)).abs().max()
                  .item() for dep, pieces, rev, env in calls), default=0.0)
    k1_lengths = [int(c[0].shape[0]) for c in calls]
    del calls
    blocks = -(-x_np.shape[0] // sm.block_len)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: emitted {got.shape}, offline "
                             f"{want.shape}")
    err = np.abs(got - want)
    stats = {"max": float(err.max()), "q999": float(np.quantile(err, 0.999)),
             "median": float(np.median(err))}
    print(f"{name}: [{x_np.shape[0]}, 2] in {blocks} blocks, pushes of "
          f"{push}: vs offline chunked max {stats['max'] / LSB:.3f} LSB, "
          f"99.9th {stats['q999'] / LSB:.3f} LSB, median {stats['median']}; "
          f"launches {json.dumps(counts)}; K1 lengths {k1_lengths}, vs "
          f"plain {k1_err:.3e}")
    if not (stats["max"] <= 8 * LSB and stats["q999"] <= LSB + 1e-6
            and stats["median"] == 0.0):
        raise AssertionError(f"{name}: vs offline {stats}")
    if not k1_err <= WEDGE_TOL:
        raise AssertionError(f"{name}: K1 vs plain {k1_err}")
    return {"counts": counts, "blocks": blocks, "err": stats,
            "k1_max_abs_err": k1_err, "k1_lengths": k1_lengths}


def _stream_compat(tmp: str) -> dict:
    """(c) The compat input's 2^23 track pushed in 100 000-sample pieces
    (gain 0, multiband): held to the offline chunked chain; per block one
    K1 launch (reverse), six K5, at least one K2, no K2 reset route. Then
    steady 0.5 noise (K3 and K4 must launch), and remainders of 1 and 31
    samples after one block, each held to the offline chain; the compat
    stream's host time a 30 s block."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.streaming import StreamingCompatMaster
    _, pcm, _ = _compat_x(tmp)
    x_np = pcm.astype(np.float32) / 32768.0
    main = _compat_stream_check("stream_compat", x_np, STREAM_PUSH)
    c, blocks = main["counts"], main["blocks"]
    if (c["wedge_env"] != blocks or c["cascade_scan"] != 6 * blocks
            or c["gain_jacobi"] < blocks or c["gain_jacobi_resets"] != 0
            or c["gain_p1_resets"] != 0):
        raise AssertionError(f"stream_compat launches {c}: expected {blocks}"
                             f" wedge_env, {6 * blocks} cascade_scan, at "
                             f"least {blocks} gain_jacobi, no reset route")
    settings = MasterSettings(**COMPAT_STREAM)

    def timed():
        sm = StreamingCompatMaster(SR, settings, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _stream(sm, x_np, STREAM_PUSH)
        return time.perf_counter() - t0, out
    secs = float(np.median([timed()[0] for _ in range(REPS)]))
    block_ms = secs / blocks * 1e3
    print(f"stream_compat: {secs:.3f} s for {blocks} blocks = "
          f"{block_ms:.2f} ms a 30 s block ({N_STREAM / SR / secs:.1f}x "
          f"realtime)")

    _, x_steady = _steady_x(tmp)
    steady_np = x_steady.cpu().numpy()
    sm = StreamingCompatMaster(SR, settings, device="cuda")
    _zero_counts()
    t0 = time.perf_counter()
    out = _stream(sm, steady_np, STREAM_PUSH)
    steady_s = time.perf_counter() - t0
    steady = _read_counts()
    peak = float(np.abs(out).max())
    print(f"stream_compat_steady: launches {json.dumps(steady)}; "
          f"{steady_s:.3f} s; peak {peak:.6f}")
    if (steady["gain_p1"] < 1 or steady["gain_p2"] < 1
            or out.shape != steady_np.shape or not np.isfinite(out).all()
            or peak > 1.0 + 1e-5):
        raise AssertionError(f"stream_compat_steady: launches {steady}, "
                             f"shape {out.shape}, peak {peak}")
    tails = {t: _compat_stream_check(f"stream_compat_tail{t}",
                                     x_np[:CHUNK_LEN + t], STREAM_PUSH)
             for t in STREAM_TAILS}
    return {"main": main, "seconds": secs, "ms_per_block": block_ms,
            "steady": {"counts": steady, "seconds": steady_s, "peak": peak},
            "tails": tails, "gain_tails": _stream_gain_tails()}


def _bench_block(settings: dict, block: int) -> dict:
    """benchmarks/bench_streaming.py's measurement on the card: a fresh
    StreamingMaster at 48 kHz, eight device chunks of 0.1 N(0,1), 3 warm
    blocks, then BENCH_REPS blocks on the host clock (each block ends in
    its one fetch); with the launches per block."""
    from ame_tpu_torch.streaming import StreamingMaster
    sm = StreamingMaster(BENCH_SR, settings, gain_db=BENCH_GAIN_DB,
                         device="cuda")
    rng = np.random.default_rng(0)
    chunks = [torch.from_numpy((0.1 * rng.standard_normal((block, 2)))
                               .astype(np.float32)).cuda() for _ in range(8)]
    for c in chunks[:BENCH_WARM]:
        sm.process(c)
    _zero_counts()
    t0 = time.perf_counter()
    for i in range(BENCH_REPS):
        sm.process(chunks[i % len(chunks)])
    ms = (time.perf_counter() - t0) / BENCH_REPS * 1e3
    counts = _read_counts()
    block_ms = block / BENCH_SR * 1e3
    return {"block": block, "ms_per_block": ms,
            "block_ms_of_audio": block_ms, "x_realtime": block_ms / ms,
            "algorithmic_latency_ms": sm.latency_samples / BENCH_SR * 1e3,
            "launches_per_block": {k: v / BENCH_REPS
                                   for k, v in counts.items() if v}}


def _profile_stream() -> dict:
    """The 4096-block streams' busy time and idle share, from torch.profiler
    in a process of its own (one that ran no plain gain walk)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--streaming-profile"], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"streaming profile failed: {r.stderr}")
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def streaming_profile() -> int:
    """``--streaming-profile``: for each bench path at blocks of 4096 (48
    kHz), the host ms a block over PROFILE_BLOCKS blocks, then the device
    time of as many blocks under torch.profiler: busy ms a block and the
    idle share of the block's time; prints one JSON line."""
    from ame_tpu_torch.streaming import StreamingMaster
    out = {}
    for name, settings in BENCH_PATHS.items():
        sm = StreamingMaster(BENCH_SR, settings, gain_db=BENCH_GAIN_DB,
                             device="cuda")
        rng = np.random.default_rng(0)
        chunks = [torch.from_numpy((0.1 * rng.standard_normal((4096, 2)))
                                   .astype(np.float32)).cuda()
                  for _ in range(8)]
        it = iter(range(10 ** 9))

        def step():
            sm.process(chunks[next(it) % len(chunks)])
        for _ in range(BENCH_WARM):
            step()
        t0 = time.perf_counter()
        for _ in range(PROFILE_BLOCKS):
            step()
        ms = (time.perf_counter() - t0) / PROFILE_BLOCKS * 1e3
        per_kernel = _profile(step, PROFILE_BLOCKS)
        busy = sum(t for t, _ in per_kernel.values()) / PROFILE_BLOCKS
        records = sum(k for _, k in per_kernel.values()) / PROFILE_BLOCKS
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:5]
        out[name] = {"ms_per_block": ms, "busy_ms_per_block": busy,
                     "idle_share": 1.0 - busy / ms,
                     "device_records_per_block": records,
                     "top": [(k[:60], t / PROFILE_BLOCKS) for k, (t, _)
                             in top]}
        print(f"stream {name} at 4096 (48 kHz): {ms:.4f} ms a block, busy "
              f"{busy:.4f} ms (idle share {1.0 - busy / ms:.3f}), "
              f"{records:.1f} device records a block; top (ms a block): "
              + ", ".join(f"{k} {v:.4f}" for k, v in out[name]["top"]))
    print(json.dumps(out))
    return 0


def _stream_latency() -> dict:
    """(d) Block latency as benchmarks/bench_streaming.py measures it, for
    quality plain, 3-band and 16-band, with launches per block; host us a
    sosfilt_cuda call at 4096; busy time and idle share at 4096."""
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    lines = {}
    for name, settings in BENCH_PATHS.items():
        lines[name] = []
        for block in BENCH_BLOCKS:
            r = _bench_block(settings, block)
            print(json.dumps({"bench_streaming": name, **r}))
            lines[name].append(r)
    sos = _quality_cascades()["eq_k4"]
    x, pre = _noise_input(STREAM_BLOCK, 2, 7)
    zi = torch.zeros((sos.shape[0], 2, 2), dtype=torch.float32,
                     device=x.device)
    host_us = _host_us(lambda: sosfilt_cuda(sos, x, zi), BENCH_REPS)
    print(f"sosfilt_cuda host time a call at [{STREAM_BLOCK}, 2]: "
          f"{host_us:.1f} us")
    return {"bench": lines, "sosfilt_cuda_host_us": host_us,
            "profile_4096": _profile_stream()}


def phase_streaming(tmp: str) -> dict:
    """Phase 12: (a) the quality streams, (b) K5 and K1 at stream shapes,
    (c) the compat streams, (d) block latency."""
    quality = _stream_quality()
    k5 = _stream_k5()
    k1 = _stream_k1()
    compat = _stream_compat(tmp)
    latency = _stream_latency()
    return {"quality": quality, "k5": k5, "k1": k1, "compat": compat,
            "latency": latency}


# ---------------------------------------------------------------------------
# Phase 13: fitting (models/automaster.py) on K5, its reverse and sos_grad
# ---------------------------------------------------------------------------
REVERSE_TOL = KERNEL_TOL
SOS_GRAD_TOL = 1e-9            # relative: the same f32 products, f64 sums
FIT_GRAD_TOL = 1e-3            # of each leaf's largest entry (f32 routes)
FIT_STEPS = 10
FIT_PROFILE_STEPS = 5
FIT_RES = (512, 2048)          # multi_resolution
FIT_KW = dict(optimize_multiband=True, multi_resolution=True,
              dynamics_weight=1.0, stereo_weight=1.0, true_peak_weight=1.0,
              tp_target=-1.0)
FIT_TARGET = dict(bass_boost=4.0, presence_boost=-2.0, width=1.3)
FIT_THETA = {"analog_raw": -1.0, "width_raw": 0.2,
             "eq_raw": [0.3, -0.2, 0.1, 0.25], "mb_thresh_raw": [0.1, -0.1,
                                                                  0.0],
             "mb_ratio_raw": [-2.0, -1.5, -1.0]}
# K5 launches of one fit step with FIT_KW (the chain: analog shelves k=2
# and EQ k=4 with tensor coefficients, then the 3-band split k=2, 4, 4 and
# the smoother k=1 with fixed ones; the loss: the band split of the output
# for the dynamics, of mid and of side for the stereo field). Forward: a
# tensor-coefficient cascade of k sections makes 1 + (k - 1) + k, a fixed
# one 1. Reverse: k for a tensor cascade (section by section), 1 for a
# fixed one (the whole cascade). sos_grad: k for a tensor cascade.
FIT_STEP_LAUNCHES = {"cascade_scan": 4 + 8 + 3 + 1 + 3 + 6,
                     "cascade_scan_reverse": 2 + 4 + 3 + 1 + 3 + 6,
                     "sos_grad": 2 + 4}
# outside the steps: the target's statistics (dynamics 3, stereo field 6)
# and the final loss without gradients (2 + 3 + 1 + 3 + 6, one each)
FIT_OTHER_FORWARD = 9 + 15


def _sos_grad_bound(n: int, c: int):
    """g, v, w read once; 5 products and 5 adds a sample."""
    return _bound(3 * n * c * 4, 10 * n * c)


def _fit_reverse() -> list:
    """(a) K5 REVERSE on the ten main-path cascades at [2^23 + 1234, 2]
    from zero state against its plain version (the tile-conv on the
    flipped input, flipped back), y and zf within 1e-4; times and bound."""
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv

    def plain(sos, x):
        y, zf = sosfilt_tileconv(sos, torch.flip(x, [0]))
        return torch.flip(y, [0]), zf
    x, _ = _noise_input(N_KERNEL, 2, 9)
    rows = []
    for name, sos in {**_quality_cascades(), **_compat_cascades()}.items():
        y_k, zf_k = sosfilt_cuda(sos, x, reverse=True)
        y_p, zf_p = plain(sos, x)
        torch.cuda.synchronize()
        err = max((y_k - y_p).abs().max().item(),
                  (zf_k - zf_p).abs().max().item())
        if not err <= REVERSE_TOL:
            raise AssertionError(f"reverse {name}: kernel vs plain {err:.3e}"
                                 f" > {REVERSE_TOL}")
        del y_k, y_p
        ms = _cuda_ms(lambda: sosfilt_cuda(sos, x, reverse=True),
                      KERNEL_CALLS)
        fwd_ms = _cuda_ms(lambda: sosfilt_cuda(sos, x), KERNEL_CALLS)
        plain_ms = _cuda_ms(lambda: plain(sos, x))
        k = int(np.asarray(sos).shape[0])
        bound = _cascade_bound(k, N_KERNEL, 2)
        rows.append({"cascade": name, "k": k, "max_abs_err": err, "ms": ms,
                     "forward_ms": fwd_ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_share": bound[0] / ms})
        print(f"reverse {name} k={k}: err {err:.3e}; kernel {ms:.4f} ms "
              f"({bound[0] / ms:.1%} of its bound; forward {fwd_ms:.4f} ms),"
              f" plain {plain_ms:.4f} ms")
    return rows


def _fit_sos_grad() -> dict:
    """(b) sos_grad against sos_grad_plain on [2^23 + 1234, 2] inputs, v
    and w the halves of one [N, 4] tensor as the backward passes them:
    relative error within 1e-9, the same sums bit for bit on a second
    call; times and bound."""
    from ame_tpu_torch.ops.sos_grad import sos_grad_cuda, sos_grad_plain
    rng = np.random.default_rng(10)
    g = torch.from_numpy(rng.standard_normal((N_KERNEL, 2)).astype(
        np.float32)).cuda()
    vw = torch.from_numpy((30.0 * rng.standard_normal((N_KERNEL, 4))).astype(
        np.float32)).cuda()
    v, w = vw[:, :2], vw[:, 2:]
    got = sos_grad_cuda(g, v, w)
    again = sos_grad_cuda(g, v, w)
    want = sos_grad_plain(g, v, w)
    rel = ((got - want).abs() / want.abs()).max().item()
    if not rel <= SOS_GRAD_TOL or not torch.equal(got, again):
        raise AssertionError(f"sos_grad vs plain: relative {rel:.3e} > "
                             f"{SOS_GRAD_TOL}, or not the same twice")
    ms = _cuda_ms(lambda: sos_grad_cuda(g, v, w), KERNEL_CALLS)
    plain_ms = _cuda_ms(lambda: sos_grad_plain(g, v, w))
    bound = _sos_grad_bound(N_KERNEL, 2)
    print(f"sos_grad [{N_KERNEL}, 2]: relative err {rel:.3e}; kernel "
          f"{ms:.4f} ms ({bound[0] / ms:.1%} of its bound {bound[0]:.4f} "
          f"ms), plain {plain_ms:.4f} ms")
    return {"max_rel_err": rel, "max_abs_err": (got - want).abs().max().item(),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_share": bound[0] / ms,
            "shape": [N_KERNEL, 2]}


def _fit_inputs():
    """The phase-4 track (2^23 samples, 0.1 N(0,1) seed 0 on the int16
    grid) on the card, and the target made from it with FIT_TARGET's
    settings through the port's quality stages."""
    from ame_tpu_torch.ops import eq, stereo
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.trunc(np.clip(
        0.1 * rng.standard_normal((N_MAIN, 2)), -1, 1) * 32767.0).astype(
            np.float32) / 32768.0).cuda()
    with torch.no_grad():
        t = eq.apply_eq_quality(x, SR, FIT_TARGET["bass_boost"], 0.0,
                                FIT_TARGET["presence_boost"], 0.0)
        t = stereo.stereo_width_quality(t, FIT_TARGET["width"])
    return x, t


def _fit_loss(theta, x, targets):
    from ame_tpu_torch.models import automaster as A
    return A._perceptual_loss(theta, x, *targets, SR, FIT_RES, 1.0, 1.0,
                              1.0, FIT_KW["tp_target"])


def _fit_grads(x, targets, route: str):
    """(loss, {name: dL/dtheta}) of _perceptual_loss at FIT_THETA, through
    the kernels (route "kernel") or with every cascade on the plain
    tile-conv (route "plain": the tables of a tensor sos in torch ops,
    autograd through them, on the card)."""
    from ame_tpu_torch.ops import scan_iir
    from ame_tpu_torch.ops.tile_conv import sosfilt_tileconv
    theta = {k: torch.tensor(v, dtype=torch.float32, device="cuda",
                             requires_grad=True)
             for k, v in FIT_THETA.items()}
    saved = scan_iir._sosfilt
    if route == "plain":
        scan_iir._sosfilt = lambda sos, sos64, x, zi, m: sosfilt_tileconv(
            sos, x, zi)
    try:
        loss = _fit_loss(theta, x, targets)
        loss.backward()
    finally:
        scan_iir._sosfilt = saved
    return loss.item(), {k: v.grad for k, v in theta.items()}


def _fit_host_prep_us() -> dict:
    """Host microseconds to prepare the kernel's tables of a tensor sos
    (fetched, designed and uploaded for one call: ``_params_np`` and
    ``_powers_np``), for the k=4 EQ and a k=1 section at C = 2."""
    from ame_tpu_torch.ops import cascade_scan as cs
    out = {}
    for name, sos in (("k4", _quality_cascades()["eq_k4"]),
                      ("k1", _quality_cascades()["eq_k4"][:1])):
        logP = cs._geometry(2)[1]
        t0 = time.perf_counter()
        for _ in range(50):
            cs._params_np(sos)
            cs._powers_np(sos, logP)
        out[name] = (time.perf_counter() - t0) / 50 * 1e6
    return out


def _fit_step_fn(x, targets):
    """One Adam step of the fit from FIT_THETA's neighbourhood: forward,
    backward and update."""
    from ame_tpu_torch.models import automaster as A
    theta = A.init_theta(True, "cuda")
    opt = torch.optim.Adam(theta.values(), lr=0.05)

    def step():
        opt.zero_grad(set_to_none=True)
        _fit_loss(theta, x, targets).backward()
        opt.step()
    return step


def fit_profile() -> int:
    """``--fit-profile``: a fit step at 2^23 samples, host-timed (each step
    synchronized) and under torch.profiler: busy ms a step and the idle
    share; prints one JSON line."""
    from ame_tpu_torch.models import automaster as A
    x, t = _fit_inputs()
    targets = A._perceptual_targets(t, SR, FIT_RES, 1.0, 1.0)
    step = _fit_step_fn(x, targets)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FIT_PROFILE_STEPS):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / FIT_PROFILE_STEPS * 1e3
    per_kernel = _profile(step, FIT_PROFILE_STEPS)
    busy = sum(v for v, _ in per_kernel.values()) / FIT_PROFILE_STEPS
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"step_ms": ms, "busy_ms": busy, "idle_share": 1.0 - busy / ms,
           "device_records_per_step": sum(k for _, k in per_kernel.values())
           / FIT_PROFILE_STEPS,
           "top": [(k[:60], v / FIT_PROFILE_STEPS) for k, (v, _) in top]}
    print(f"fit step (profile process): {ms:.3f} ms, busy {busy:.3f} ms "
          f"(idle share {1.0 - busy / ms:.3f}); top (ms a step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["top"]))
    print(json.dumps(out))
    return 0


def _profile_fit() -> dict:
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--fit-profile"], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"fit profile failed: {r.stderr}")
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def phase_fit() -> dict:
    """Phase 13: (a) K5 REVERSE, (b) sos_grad, (c) dL/dtheta kernel vs
    plain at 2^23, (d) fit_settings for FIT_STEPS steps (loss falls, bass
    moves towards +4 dB, exact launches a step), a step's time, busy time
    and idle share."""
    from ame_tpu_torch.models import automaster as A
    rev = _fit_reverse()
    sg = _fit_sos_grad()
    # (c)
    x, t = _fit_inputs()
    targets = A._perceptual_targets(t, SR, FIT_RES, 1.0, 1.0)
    loss_k, g_k = _fit_grads(x, targets, "kernel")
    loss_p, g_p = _fit_grads(x, targets, "plain")
    grad_err = {k: ((g_k[k] - g_p[k]).abs().max()
                    / g_p[k].abs().max().clamp(min=1e-30)).item()
                for k in g_k}
    print(f"dL/dtheta at 2^23, kernels vs plain tile-conv: loss {loss_k:.6f}"
          f" vs {loss_p:.6f}; relative errors "
          + ", ".join(f"{k} {e:.2e}" for k, e in grad_err.items()))
    if not (max(grad_err.values()) <= FIT_GRAD_TOL
            and abs(loss_k - loss_p) <= FIT_GRAD_TOL * abs(loss_p)):
        raise AssertionError(f"fit gradient kernel vs plain: {grad_err}, "
                             f"loss {loss_k} vs {loss_p}")
    del g_p
    # (d)
    x_np, t_np = x.cpu().numpy(), t.cpu().numpy()
    with torch.no_grad():
        loss0 = _fit_loss(A.init_theta(True, "cuda"), x, targets).item()
    _zero_counts()
    t0 = time.perf_counter()
    out = A.fit_settings(x_np, SR, t_np, steps=FIT_STEPS, lr=0.05,
                         device="cuda", **FIT_KW)
    fit_s = time.perf_counter() - t0
    counts = _read_counts()
    want = {k: FIT_STEPS * v for k, v in FIT_STEP_LAUNCHES.items()}
    want["cascade_scan"] += FIT_OTHER_FORWARD
    got = {k: counts[k] for k in want}
    if got != want or any(counts[k] for k in ("wedge_env", "gain_jacobi",
                                              "gain_p1", "gain_p2")):
        raise AssertionError(f"fit launches {counts}, expected {want}")
    if not (math.isfinite(out["loss"]) and out["loss"] < loss0
            and out["bass_boost"] > 0.0):
        raise AssertionError(f"fit did not move: loss {loss0} -> "
                             f"{out['loss']}, settings {out}")
    step = _fit_step_fn(x, targets)
    step_ms = _cuda_ms(step)
    step_host_ms = _host_s(lambda: (step(), torch.cuda.synchronize())) * 1e3
    prep = _fit_host_prep_us()
    print(f"fit_settings {FIT_STEPS} steps at 2^23: loss {loss0:.4f} -> "
          f"{out['loss']:.4f}, bass {out['bass_boost']:+.3f} dB (target "
          f"+4), presence {out['presence_boost']:+.3f} (target -2), width "
          f"{out['width']:.4f} (target 1.3); {fit_s:.2f} s; launches a "
          f"step {FIT_STEP_LAUNCHES}; step {step_ms:.3f} ms (host "
          f"{step_host_ms:.3f} ms); host prep of a tensor sos (us): {prep}")
    profile = _profile_fit()
    return {"reverse": rev, "sos_grad": sg,
            "grad_check": {"loss_kernel": loss_k, "loss_plain": loss_p,
                           "max_rel_err": grad_err, "tol": FIT_GRAD_TOL},
            "fit": {"steps": FIT_STEPS, "loss_start": loss0,
                    "loss_end": out["loss"], "settings": out,
                    "seconds": fit_s},
            "counts": counts, "launches_per_step": FIT_STEP_LAUNCHES,
            "step_ms": step_ms, "step_host_ms": step_host_ms,
            "host_prep_us": prep, "profile": profile}


# ---------------------------------------------------------------------------
# Phase 14: training the mood CNN (models/train_mood.py)
# ---------------------------------------------------------------------------
TRAIN_PER_CLASS = 8
TRAIN_SECONDS = 30.0
TRAIN_BATCH = 32
TRAIN_LR = 1e-3


class _EpochLog(logging.Handler):
    """Keeps the trainer's per-epoch records (epoch, loss, acc, steps,
    ms a step)."""

    def __init__(self):
        super().__init__()
        self.epochs = []

    def emit(self, record):
        if record.msg.startswith("epoch "):
            self.epochs.append(record.args)


def phase_train(tmp: str) -> dict:
    """Phase 14: synth_corpus.generate (4 classes x 8 tracks x 30 s), then
    train_mood.main for 2 epochs at batch 32 with a checkpoint directory,
    then once more to 3 epochs, resumed from the checkpoint; the loss is
    finite and falls, the written weights load through load_params and
    analyze_song runs on them; a step's time."""
    from ame_tpu_torch.analysis import musicologist as M
    from ame_tpu_torch.models import mood_cnn, synth_corpus, train_mood
    root = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    n = synth_corpus.generate(root, per_class=TRAIN_PER_CLASS,
                              seconds=TRAIN_SECONDS)
    gen_s = time.perf_counter() - t0
    ck = os.path.join(tmp, "ck")
    out = os.path.join(tmp, "mood.msgpack")
    args = [root, "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
            "--checkpoint-dir", ck, "--out", out, "--device", "cuda"]
    handler = _EpochLog()
    log = logging.getLogger("ame_tpu_torch.train")
    log.addHandler(handler)
    _zero_counts()
    try:
        t0 = time.perf_counter()
        train_mood.main(args + ["--epochs", "2"])
        first_s = time.perf_counter() - t0
        resumed_from = len(handler.epochs)
        t0 = time.perf_counter()
        train_mood.main(args + ["--epochs", "3"])
        resume_s = time.perf_counter() - t0
    finally:
        log.removeHandler(handler)
    counts = _read_counts()
    epochs = [{"epoch": e, "loss": l, "acc": a, "steps": k, "step_ms": ms}
              for e, l, a, k, ms in handler.epochs]
    losses = [e["loss"] for e in epochs]
    if not ([e["epoch"] for e in epochs] == [0, 1, 2] and resumed_from == 2
            and all(math.isfinite(v) for v in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"training: epochs {epochs}")
    if sorted(os.listdir(ck)) != ["ckpt_0.pt", "ckpt_1.pt", "ckpt_2.pt"]:
        raise AssertionError(f"checkpoints: {os.listdir(ck)}")
    model, trained = mood_cnn.load_params(out, device="cuda")
    if not (trained and all(torch.isfinite(t).all().item()
                            for t in model.state_dict().values())):
        raise AssertionError("trained weights do not load")
    saved = os.environ.get("AME_TPU_MOOD_WEIGHTS")
    os.environ["AME_TPU_MOOD_WEIGHTS"] = out
    try:
        track = os.path.join(root, "Calm-Content", "000.wav")
        brief = M.analyze_song(track, device="cuda")
    finally:
        if saved is None:
            del os.environ["AME_TPU_MOOD_WEIGHTS"]
        else:
            os.environ["AME_TPU_MOOD_WEIGHTS"] = saved
    if set(brief) != BRIEF_KEYS or brief["mood"] not in mood_cnn.MOOD_CLASSES:
        raise AssertionError(f"analyze_song on the trained weights: {brief}")
    step_ms = float(np.median([e["step_ms"] for e in epochs]))
    print(f"train: {n} tracks in {gen_s:.1f} s; epochs "
          + "; ".join(f"{e['epoch']}: loss {e['loss']:.4f} acc "
                      f"{e['acc']:.3f}" for e in epochs)
          + f"; {first_s:.1f} s + resumed {resume_s:.1f} s; step "
          f"{step_ms:.3f} ms (batch {TRAIN_BATCH}); analyze_song on the "
          f"trained weights: {brief['mood']}")
    return {"tracks": n, "generate_s": gen_s, "epochs": epochs,
            "first_run_s": first_s, "resumed_run_s": resume_s,
            "step_ms": step_ms, "batch": TRAIN_BATCH, "lr": TRAIN_LR,
            "mood_on_trained": brief["mood"], "counts": counts}


def kernel_times(root: str) -> int:
    """``--kernel-times [ROOT]``: K5 on the ten main-path cascades and Q14
    (checked against plain, timed, split by launch) and, where the package
    has chunked compat, on the chunk columns [1 323 000, 14] and the
    quality multiband cascades; K1 in both
    directions (checked, timed, split by launch); K2's carry and full
    sweeps and K3 (checked bit for bit against the full sweep's states,
    timed, with its floor when the library has one) and K4 (from K3's
    starts, checked and timed beside a device copy of m) on the compat
    main path's bands; K4 on random [3, 2^23 + 1234] input (the 4-byte
    route); K2's reset route (checked against K3 + K4 and its plain
    version, its sweeps timed) on the chunked path's bands, where the
    package has it; and the device chains (quality, compat, compat
    fallback, and those of chunked compat and quality multiband where the
    package runs them: master_graph, with the device's busy time), with the
    ame_tpu_torch package found under ROOT (default: this checkout), e.g.
    an unpacked parent commit, so that two trees can be timed in turns on
    one card. Prints one {"kernel_times": ...} line; no file is mastered."""
    sys.path.insert(0, os.path.abspath(root))
    import ame_tpu_torch
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.ops import pydub_gain as pg
    chunked = hasattr(pg, "pydub_gain_chunked")
    phase_device()
    phase_build()
    cascades = {"main_path": phase_cascades()}
    if chunked:
        cascades["chunk_columns"] = phase_cascades_chunked()
        cascades["quality_multiband"] = phase_cascades_mb()
    wedge =_wedge_kernel(_wedge_input()[1])
    del wedge["env_p"]
    with tempfile.TemporaryDirectory() as tmp:
        x_compat = _compat_x(tmp)[2]
        x_steady = _steady_x(tmp)[1]
    m_main = _band_max_att(x_compat)
    m_t, S, c_first, c_fix, _ = _jacobi_inputs(m_main)
    sweeps = _jacobi_times(m_t, c_first, c_fix)
    ia, ir = pg._scal(ATTACK, RELEASE)
    _, att_t = pg.gain_jacobi_cuda(m_t, c_fix.reshape(-1).contiguous(), ia,
                                   ir, True)
    G, n = m_main.shape
    p1 = _p1_kernel(m_main, _sweep_starts(att_t, G, S, n))
    del att_t, m_t
    p2 = _p2_kernel(m_main, p1.pop("starts"))
    p2["ragged"] = _p2_kernel(*_p2_random(N_KERNEL, 3))
    if chunked:
        sweeps["reset_route"] = _reset_main(_band_max_att_chunked(x_compat))
    rng = np.random.default_rng(0)
    x_quality = torch.from_numpy(np.trunc(np.clip(
        0.1 * rng.standard_normal((N_MAIN, 2)), -1, 1) * 32767.0).astype(
            np.float32) / 32768.0).cuda()
    runs = [("quality", x_quality, FLAGSHIP), ("compat", x_compat, COMPAT),
            ("compat_fallback", x_steady, COMPAT)]
    if chunked:
        runs += [("compat_chunked", x_compat, COMPAT_CHUNKED),
                 ("compat_chunked_fallback", x_steady, COMPAT_CHUNKED),
                 ("quality_mb", x_quality, QUALITY_MB),
                 ("quality_mb16", x_quality, QUALITY_MB16)]
    chains = {}
    for name, x, s in runs:
        settings = MasterSettings(**s)
        chain_ms = _cuda_ms(lambda: master_graph(x, SR, settings))
        busy = _chain_busy(name, lambda: master_graph(x, SR, settings),
                           chain_ms)
        chains[name] = {"device_chain_ms": chain_ms, **busy}
    analysis = None
    if os.path.exists(os.path.join(os.path.dirname(ame_tpu_torch.__file__),
                                   "analysis", "musicologist.py")):
        from ame_tpu_torch.analysis import musicologist as M
        y = torch.from_numpy((0.1 * np.random.default_rng(2).standard_normal(
            N_WINDOW)).astype(np.float32)).cuda()
        wave_ms = _cuda_ms(lambda: M.analyze_waveform(y))
        analysis = {"analyze_waveform_ms": wave_ms,
                    "analyze_waveform_host_ms":
                        _host_s(lambda: M.analyze_waveform(y)) * 1e3,
                    **_chain_busy("musicologist analyze_waveform",
                                  lambda: M.analyze_waveform(y), wave_ms)}
    print(json.dumps({"kernel_times": {
        "package": os.path.dirname(ame_tpu_torch.__file__),
        "cascade_scan": cascades, "wedge_env": wedge, "gain_jacobi": sweeps,
        "gain_p1": p1, "gain_p2": p2, "chains": chains,
        "musicologist": analysis}}))
    return 0


def main() -> int:
    t_start = time.perf_counter()
    kind = phase_device()
    try:
        import ame_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the ame_tpu_torch package is not "
                         f"importable ({e}); run the script from the "
                         f"repository checkout") from e
    phase_build()
    rows = phase_cascades()
    chunk_rows = phase_cascades_chunked()
    mb_rows = phase_cascades_mb()
    with tempfile.TemporaryDirectory() as tmp:
        main_run = phase_main(tmp)
        phase_parity()
        mb = phase_quality_mb(tmp)
        phase_quality_mb_parity()
        wedge = phase_wedge()
        compat = phase_compat_main(tmp)
        chunked = phase_compat_chunked(tmp)
        chunked_fb = phase_compat_chunked_fallback(tmp)
        gain = phase_gain(compat.pop("m_main"), chunked.pop("m_chunked"))
        fallback = phase_compat_fallback(tmp)
        phase_compat_parity(compat.pop("pcm"))
        phase_compat_parity(chunked.pop("pcm"), COMPAT_CHUNKED,
                            N_CHUNK_PARITY, "compat_chunked")
        mus = phase_musicologist(tmp)
        stream = phase_streaming(tmp)
        t0 = time.perf_counter()
        fit = phase_fit()
        fit["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = phase_train(tmp)
        train["phase_s"] = time.perf_counter() - t0
    sq, sc = stream["quality"], stream["compat"]
    paths = {"quality": main_run["counts"], "compat": compat["counts"],
             "compat_fallback": fallback["counts"],
             "compat_chunked": chunked["counts"],
             "compat_chunked_fallback": chunked_fb["counts"],
             "quality_mb": mb["mb3"]["counts"],
             "quality_mb16": mb["mb16"]["counts"],
             "musicologist": mus["song_counts"],
             **{p: r["counts"] for p, r in sq.items()},
             "stream_compat": sc["main"]["counts"],
             "stream_compat_steady": sc["steady"]["counts"],
             "fit": fit["counts"], "train": train["counts"]}

    def entry(name, source, replaces, path, err, ms, plain_ms, bound,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": paths[path][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "bound_share": bound[0] / ms, "library_ms": None, **extra}

    csrc = "ame_tpu_torch/csrc/"
    pg_src = "ame_tpu/ops/pydub_gain.py"
    quality = rows[:len(_quality_cascades())]
    kernels = [
        entry("cascade_scan", csrc + "cascade_scan.cu",
              "ame_tpu/ops/pallas_scan.py:65", "quality",
              max(max(max(r["max_abs_err_y"], r["max_abs_err_zf"])
                      for r in rows),
                  max(r["max_abs_err"] for r in chunk_rows + mb_rows
                      + stream["k5"]["rows"]),
                  stream["k5"]["chain"]["max_abs_err"]),
              sum(r["ms"] for r in quality),
              sum(r["plain_ms"] for r in quality),
              (sum(r["bound_ms"] for r in quality), "bytes"),
              note="ms, plain_ms and bound_ms: the quality path's three "
                   "cascades together; multiband_stage_totals: the K5 "
                   "launches of one master's multiband stage together",
              per_cascade=rows, chunk_columns=chunk_rows,
              quality_multiband=mb_rows, streaming=stream["k5"],
              multiband_stage_totals={
                  p: {key: sum(r[key] * r["uses"].get(p, 0)
                               for r in mb_rows)
                      for key in ("ms", "plain_ms", "bound_ms")}
                  for p in ("quality_mb", "quality_mb16")}),
        entry("wedge_env", csrc + "wedge_env.cu",
              "ame_tpu/ops/limiter.py:114", "compat",
              max([wedge["max_abs_err"]] + [r["max_abs_err"]
                                            for r in stream["k1"]]
                  + [c["k1_max_abs_err"] for c in [sc["main"]]
                     + list(sc["tails"].values())]),
              wedge["ms"], wedge["plain_ms"], wedge["bound"],
              n=N_KERNEL, note="both directions",
              one_call_ms=wedge["one_call_ms"], phase_ms=wedge["phase_ms"],
              streaming_reverse=stream["k1"]),
    ]
    reset = gain["reset"]
    for name, line in (("gain_jacobi", 307), ("gain_p1", 140),
                       ("gain_p2", 231)):
        path = "compat" if name == "gain_jacobi" else "compat_fallback"
        p2 = gain["p2"]
        extra = {"gain_jacobi": {
                     "carry_sweep": gain["carry"],
                     "reset_route": {
                         "replaces": f"{pg_src}:307 (has_resets=True)",
                         "launches": paths["compat_chunked"][
                             "gain_jacobi_resets"],
                         "max_abs_err": max(reset["max_abs_err"],
                                            reset["small"]["max_abs_err"]),
                         "shape": reset["shape"],
                         "plain_ms": reset["plain_ms"],
                         "sweeps_small": reset["small"]["sweeps"],
                         "sweeps_main": reset["sweeps"],
                         "full_sweep": reset["reset"]["full"],
                         "carry_sweep": reset["reset"]["carry"],
                         "no_resets_same_input": reset["no_resets"]}},
                 "gain_p1": {"floor": gain["p1"]["floor"]},
                 "gain_p2": {"one_call_ms": p2["one_call_ms"],
                             "copy_ms": p2["copy_ms"],
                             "device_ms": p2["device_ms"],
                             "ragged": p2["ragged"]}}[name]
        kernels.append(entry(
            name, csrc + "pydub_gain.cu", f"{pg_src}:{line}", path,
            gain["errs"][name],
            gain["ms"][name], gain["plain_ms"][name], gain["bounds"][name],
            n=gain["n"], plain_n=gain["plain_n"][name], **extra))
    rev, sg = fit["reverse"], fit["sos_grad"]
    kernels += [
        entry("cascade_scan_reverse", csrc + "cascade_scan.cu",
              "ame_tpu/ops/pallas_scan.py:65", "fit",
              max(r["max_abs_err"] for r in rev),
              sum(r["ms"] for r in rev[:3]),
              sum(r["plain_ms"] for r in rev[:3]),
              (sum(r["bound_ms"] for r in rev[:3]), "bytes"),
              note="K5's adjoint (the backward of a cascade; ame_tpu "
                   "differentiates its tile-conv tables with XLA, "
                   "ame_tpu/ops/tile_conv.py:246); ms, plain_ms and "
                   "bound_ms: the quality path's three cascades run "
                   "backward together, [2^23 + 1234, 2]",
              per_cascade=rev),
        entry("sos_grad", csrc + "sos_grad.cu",
              "ame_tpu/ops/pallas_scan.py:65", "fit",
              sg["max_abs_err"], sg["ms"], sg["plain_ms"],
              (sg["bound_ms"], sg["bound_by"]),
              note="K5's coefficient gradient (ame_tpu: XLA autodiff "
                   "through ame_tpu/ops/tile_conv.py:246); v and w as the "
                   "halves of one [N, 4] tensor",
              max_rel_err=sg["max_rel_err"], shape=sg["shape"]),
    ]
    chains = {p: {"device_chain_ms": r["chain_ms"],
                  "file_ms": r["file_s"] * 1e3,
                  "busy_ms": r["busy"]["busy_ms"],
                  "idle_share": r["busy"]["idle_share"]}
              for p, r in (("quality", main_run), ("compat", compat),
                           ("compat_fallback", fallback),
                           ("compat_chunked", chunked),
                           ("compat_chunked_fallback", chunked_fb),
                           ("quality_mb", mb["mb3"]))}
    chains["quality_mb16"] = {"device_chain_ms": mb["mb16"]["chain_ms"],
                              "file_ms": None,
                              "busy_ms": mb["mb16"]["busy"]["busy_ms"],
                              "idle_share": mb["mb16"]["busy"]["idle_share"]}
    print(f"run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"chains": chains}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"musicologist": mus}))
    print(json.dumps({"streaming": {
        "quality": sq, "k5_chain": stream["k5"]["chain"],
        "compat": sc, "latency": stream["latency"]}}))
    print(json.dumps({"fit": {k: v for k, v in fit.items()
                              if k not in ("reverse", "sos_grad")}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--musicologist-profile"]:
        sys.exit(musicologist_profile())
    if sys.argv[1:2] == ["--streaming-profile"]:
        sys.exit(streaming_profile())
    if sys.argv[1:2] == ["--fit-profile"]:
        sys.exit(fit_profile())
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2] if len(sys.argv) > 2 else
                              os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())

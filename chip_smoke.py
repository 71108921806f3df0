#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ame_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, the CUDA toolkit (nvcc) and the repository checkout;
it imports nothing of JAX or of the ame_tpu package. Phases, in order — any
failure raises and the script exits non-zero without the final line:

  1. device: the card's name and nvidia-smi's name / power limit line;
  2. build: compiles ame_tpu_torch/csrc/{cascade_scan,wedge_env,pydub_gain,
     sos_grad,graph_if,lookahead_limiter}.cu from the checkout, one nvcc
     each, all started together;
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
     its split over its three launches (torch.profiler); then the quality
     limiter's kernel (csrc/lookahead_limiter.cu) vs its plain version on
     the card at [2^23 + 1234, 2] and at the benchmark cells' mean track
     [9 702 000, 2], on gated noise and a 100 Hz tone with clicks that
     pull the gain to ~0.1 (gain within 1e-5, y within 1e-5 per unit of
     |x|), its time (10 calls in a row, one alone), the plain version's
     and its bound;
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
     its bound; (b) sos_grad against sos_grad_plain at N = 1, 2, 3, 31,
     4097, 2^20 + 7, 2^23 + 1234 and C = 1, 2, 3, 16, each with v and w
     the halves of one [N, 2C] tensor, separate tensors and the halves of
     a view one float off an allocation (not aligned): relative error
     within 1e-9, the same bits twice and in all three layouts, the
     vector route exactly for the halves at C <= 2; at [2^23 + 1234, 2]
     (halves) timed with its bound (3·N·C·4 bytes) beside the plain
     version and the library yardstick (torch.einsum over an as_strided
     lag view, held to plain within 1e-4);
     (c) dL/dtheta of _perceptual_loss on the phase-4 track with every
     term on (multiband parameters, two FFT resolutions, band dynamics,
     stereo field, true peak), through the kernels against every cascade
     on the plain traced tile-conv on the card, within 1e-3 of each
     leaf's largest entry; (d) fit_settings with those terms for 10
     steps against a target made with +4 dB bass, -2 dB presence and
     width 1.3: the loss falls, the bass gain rises, and K5 makes exactly
     25 forward and 19 reverse launches and sos_grad 6 a step, all on
     its vector route (plus the
     target's and the final loss's forward launches), nothing else; a
     step's time (CUDA events, host clock), the host time to prepare a
     tensor sos's tables, and its busy time and idle share under
     torch.profiler in a process of its own (``--fit-profile``);
 14. training (models/train_mood.py): synth_corpus.generate (4 classes x
     8 tracks x 30 s), train_mood.main for 2 epochs at batch 32 with a
     checkpoint directory, then to 3 epochs resumed from it: the loss is
     finite and falls, three checkpoints, the written msgpack loads
     through load_params, analyze_song runs on it; a step's time;
 15. serve and CLI (serve/server.py, cli.py): make_server(port=0,
     device="cuda") with one worker, phase 4's WAV PUT over HTTP as the web
     client does: (a) a flagship job with create_mp3 and an art prompt
     (procedural provider): done, a Success: and no Error: / Failed:, K5
     exactly 3 launches and nothing else, the served WAV within 1 LSB of
     master_file's on the card, -14 LUFS within 0.5 LU, a 1024x1024 PNG,
     the MP3 sidecar decoding to the master's length within 5000 samples;
     the same job without MP3 and art; (b) the track as an MP3 the port
     encoded (done, K5 3, -14 within 0.5 LU), and as a FLAC of verbatim
     subframes (the same, and within 1 LSB of the WAV upload's master);
     (c) phase 8's compat WAV (mode="compat", multiband): K1 2, K5 7, K2 at
     least 1, K3 / K4 never, within 1 LSB of master_file's; (d) /measure
     within 0.01 of loudnorm_pass1 on the card; (e) a second server with 2
     workers, 4 jobs at once (2 quality, 2 compat): all done, each within 1
     LSB of its one-at-a-time counterpart, and the burst's launches the
     sum of those four jobs' one at a time; (f) python -m ame_tpu_torch
     master --mp3 / measure / analyze / automaster --steps 3 in
     subprocesses on the card, started together: the info JSON and -14
     LUFS, the pass-1 keys, the brief's keys, a finite loss. The counts
     are held in (a)-(c) and (e) (atomic: ops/_count.bump). Where
     libmp3lame or libmpg123 is absent the MP3 checks are left out and
     "mp3" says "unavailable: ..."; latencies from the PUT's end to done,
     the host parts (decode, art, MP3 encode) timed alone;
 16. GUI, fleet, batch, profile, evaluation (gui_logic.py, gui.py,
     parallel/, io/loader.py, utils/profiler.py, models/oof*_corpus.py,
     io/avfilter.py), on phase 4's and phase 8's WAVs: (a) a GuiController
     with a recorder view starts a flagship job through process_audio on a
     worker thread and is drained until not busy: one Success: status, no
     Error: / Failed:, progress ending at its total, one info dialog, K5
     exactly 3 launches and nothing else, the master within 1 LSB of
     master_file's; then Match Reference through gui._fit_files (120 steps)
     against phase 13's +4 dB-bass target: the bass slider rises, the match
     ends not busy; (b) run_fleet over the quality WAV, its FLAC, the
     compat WAV in compat mode, an AIFF of the quality track and a corrupt
     WAV, then again: 4 done and 1 error, the second run skips the 4; the
     loader decodes the WAVs and the FLAC natively and the AIFF (and the
     corrupt file) in Python; launches a track (K5 3 a quality track; K1 2,
     K5 7, K2 >= 1 for the compat one) and its time from the loader's
     yield to the manifest's fsync; every master within 1 LSB of
     master_file's; python -m ame_tpu_torch fleet in a subprocess (exit 0,
     its summary); (c) master_batch on [4, 2^23, 2] (the quality track and
     three noise tracks): K5 exactly 12, each output within 2e-4 of
     master_graph on its track, its device time; (d) python -m
     ame_tpu_torch profile --runs 5 --trace in subprocesses, quality and
     compat multiband without LUFS: ame_tpu's report keys and stage names,
     steady_ms and x_realtime > 0, the Chrome trace's kernel events holding
     K5's kernels (quality) and K1's (compat); (e) the out-of-family and
     third-family corpora (seed 77, 4 a class, 20 s) through the
     spectrogram image and predict_mood on the card: accuracy >= 0.75 each;
     (f) the golden-FFmpeg harness: available, or the reason it is not
     (reported, not failed); where available loudnorm_pass1 on the card
     within 0.1 LU of the real filter's input_i; (g) device_memory_stats
     lists only cuda:0;
 17. time-sharded mastering (parallel/sp_master.py, sp_compat.py,
     sequence.py, bands.py, batch.py's mesh route, api's shard_time), at
     475 x 4 x 4410 = 8 379 000 samples (a 4-shard shard holds whole
     100 ms hops), on meshes of D = 1 and D = 4 shards, all on cuda:0:
     (a) bench.py's sp_quality (flagship + multiband, on 0.15 N(0,1) noise
     with a 3x loud second across the first D = 4 boundary, so the halo'd
     limiter works) and sp_compat (unchunked compat multiband, on the
     compat main path's input), and the flagship chunked compat through
     the padded wrapper: each against master_graph on the same input
     (tests/test_parallel.py's tolerances: quality info 2e-2, output atol
     3e-4 / rtol 2e-3; compat 5e-2, 2e-3 / 5e-3; linear_mode equal), the
     launches held to PERF.md's prediction (a sequence-parallel cascade
     2D - 1 K5, a chunk-local one D; K1 only at D = 1; K2 from 1 .. D
     engine sweeps, no K3), device times beside master_graph's; (b) the
     gain relaxation at D = 4 on the compat band detector's [3, N] output
     bit-equal to the one-track engine, and K3 and K2 from a non-zero init
     (the first shard's end state) at a shard's shape [3, 2 094 750]: K2's
     full sweep from the relaxed carries bit-equal to its plain version,
     K3's starts bit-equal to that sweep's states, pydub_gain_ends equal
     to its end; (c) K5 with a carried zi on zeros (the zero-input
     response) at a shard's shape, the k = 6 pre cascade at C = 2 and the
     smoother at C = 3, within 1e-4 of the plain version, timed; (d)
     master_batch over a 2-device data mesh bit-equal to mesh=None;
     multiband_band_parallel at 3 bands against multiband_quality_n (atol
     3e-5, rtol 1e-4); (e) master_file(shard_time=True) on cuda:0: the
     time-sharded status and no degrade warning, K5 2, within 2e-3 of the
     unsharded master;
 18. the sharded training step and the channel-stacked batch
     (parallel/mesh.init_distributed, parallel/train.py,
     parallel/stacked.py): (a) init_distributed with a file:// store in
     the run's temp dir and the nccl backend, world size 1 (the card
     machine has one card, and NCCL refuses two ranks on one device: the
     multi-rank layouts are held by the CPU tests over gloo), then
     make_sharded_train_step over {"data": 1, "model": 1} at batch 32 on
     the full mood CNN, 10 steps with dropout on from one generator: the
     parameters within 1e-5 of mood_cnn.make_train_step's on the card
     from the same generator seed, the loss falls, no kernel of the port
     launched, a step's time beside the one-device step's, the process
     group destroyed; (b) master_batch_stacked on phase 16's [4, 2^23, 2]
     with the flagship settings and multiband: K5 exactly 7 launches (each
     cascade once on the [N, 8] stack, the smoother at C = 12) and nothing
     else, each track within atol 5e-5, rtol 1e-4 of master_graph on it,
     its device time beside master_batch's on the same input (multiband
     and flagship), and K5 on each of the stack's cascades at [2^23, 8]
     (the smoother at [2^23, 12]) against its plain version from a
     non-zero zi (1e-4), timed with its bound;
 19. the fused chain (graph/chain.master_graph_fused: one CUDA graph a
     settings key, every branch of the chain a conditional node decided on
     the card, ops/_branch.py and csrc/graph_if.cu) on the quality, compat,
     compat fallback, compat_chunked and its fallback, quality_mb and
     quality_mb16 inputs of the phases above, a compat input that sends
     loudnorm dynamic (quiet noise with full-scale clicks) and a silent
     track: each from an empty cache, master_graph first (its launches
     counted: K5 3 quality, 7 compat; K3 only on the fallback inputs),
     then the warm-up and capture (seconds, the graph's pools' bytes, the
     launches counted at capture) and 3 replays under
     torch.cuda.set_sync_debug_mode("error"), each held to master_graph
     within the parity limits (quality 2e-4 abs, gain 0.01 dB; compat
     relative L2 < 3e-3 or max abs <= 2/32768; linear_mode equal); replay
     and staged times (CUDA events) and host us a call; one compat graph
     captured on the compat input replaying the fallback, dynamic and
     silent inputs; and, in a process of its own (``--fused-profile
     TMP``), each input's kernel records a replay against a staged run's
     under torch.profiler (the port's kernels' records must be equal: the
     same K2 sweeps, K3 / K4 only where the staged engine fell back),
     busy ms and idle share; then the fused chain from several threads
     (every output bit-equal to master_graph on its input, info too):
     (a) two threads, each on a stream of its own, replay one compat key
     FUSED_THREAD_REPLAYS times each on two inputs (the compat and the
     dynamic-loudnorm one), interleaved; (b) one thread captures two new
     keys (compat_chunked, quality_mb) while another masters eagerly with
     master_graph on the default stream (quality and compat in turn)
     until the captures are done; (c) two threads capture and replay
     FUSED_EVICT_KEYS compat keys (LUFS targets) in opposite orders, more
     than _FUSED_GRAPHS, so that graphs are evicted while the other
     thread replays;
 20. the run's seconds, a {"chains": ...} line, a {"kernels": [...]} line,
     a {"musicologist": ...} line, a {"streaming": ...} line, a {"fit":
     ...} line, a {"train": ...} line, a {"serve": ...} line, a
     {"surfaces": ...} line, a {"sharded": ...} line, a {"train_sharded":
     ...} line, a {"stacked": ...} line, a {"fused": ...} line, then the
     last line {"ok": true, "device": {"platform": "gpu", "kind": ...,
     "count": ...}}.

Run alone, without the repository's ame_tpu_torch package beside it, the
script stops after phase 1 with a non-zero exit and prints no result.

``python3 chip_smoke.py --kernel-times [ROOT]`` runs phase 3, K1's check
and times, the quality limiter's (phase 7), K2's sweep times, K3's check, time and floor and K4's checks
and times (with the copy yardstick) at [3, 2^23], K4 at [3, 2^23 + 1234],
K2's reset route (f), sos_grad at [2^23 + 1234, 2] (13 (b)'s check and
times), the device chains (quality, compat, compat fallback, compat
chunked and its fallback, quality multiband 3 and 16 bands) and
analyze_waveform on 30 s only, with the ame_tpu_torch package
under ROOT (default: this checkout; e.g. an unpacked parent commit, which
may lack chunked compat, multiband or the Musicologist: those parts are
then left out), so that two trees can be timed in turns on one card.
``python3 chip_smoke.py --sos-grad-variants [PARENT]`` builds PARENT's
csrc/sos_grad.cu and this checkout's under each of SG_VARIANTS' defines
(the general route, steps in flight, grid size) and times them in turns
at [2^23 + 1234, 2], with their registers and SASS opcode counts.
``python3 chip_smoke.py --sharded-times [ROOT]`` times phase 17's sharded
masters (each path at D = 1 and 4, twice, with its launches) of the
ame_tpu_torch package under ROOT, in the same way; ``--fused-times
[ROOT]`` its master_graph_fused replays (quality and compat: device ms
and host us a call, twice each).

Every kernel's launch count is set to 0 just before each main path and read
just after it. Times are medians of 3 warm runs, taken with
torch.cuda.Event (device work) or the host clock after a synchronize (file
to file). Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s f32.
"""

import concurrent.futures
import contextlib
import ctypes
import json
import logging
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SR = 44100
N_KERNEL = (1 << 23) + 1234       # ragged: not a multiple of the kernel block
N_MAIN = 1 << 23                  # 3:10 at 44.1 kHz
N_PARITY = 1 << 20
N_GAIN_PLAIN = 1 << 17            # the plain sequential walk's length
N_MEAN_TRACK = 9_702_000          # the benchmark cells' mean track, 220 s
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)
COMPAT = dict(FLAGSHIP, mode="compat", multiband=True)
KERNEL_TOL = 1e-4     # tests/test_pallas_scan.py holds K5 to 1e-4
WEDGE_TOL = 1e-5
LIMITER_TOL = 1e-5    # gain; y per unit of |x| (the plain release is f32)
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
    from ame_tpu_torch.ops import limiter
    if hasattr(limiter, "lookahead_limiter_cuda"):   # a tree with the kernel
        out["lookahead_limiter"] = limiter.lookahead_limiter_cuda
    return out


def _quality_launches_ok(counts: dict, masters: int = 1,
                         k5: int = 3) -> bool:
    """K5 ``k5`` launches a quality master, the limiter's kernel one (where
    the package has it), and nothing else."""
    want = {"cascade_scan": k5 * masters}
    if "lookahead_limiter" in counts:
        want["lookahead_limiter"] = masters
    return all(counts[k] == v for k, v in want.items()) and not any(
        v for k, v in counts.items() if k not in want)


def _reset_counters() -> dict:
    """The counts kept under other names than ``launches``, where the
    package keeps them: K2's reset route and K3 with flags (within
    gain_jacobi's and gain_p1's counts), K5's reverse launches (apart
    from its forward ones) and sos_grad's vector route (within its
    count)."""
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.ops.cascade_scan import sosfilt_cuda
    sos_grad = _counters().get("sos_grad")
    return {k: (fn, attr) for k, fn, attr in (
        ("gain_jacobi_resets", pg.gain_jacobi_cuda, "reset_launches"),
        ("gain_p1_resets", pg.gain_p1_cuda, "reset_launches"),
        ("cascade_scan_reverse", sosfilt_cuda, "reverse_launches"),
        ("sos_grad_vector", sos_grad, "vector_launches"))
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
                              "sos_grad", "graph_if", "lookahead_limiter")
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


def _sass(so):
    """cuobjdump -sass of the library `so`; None without cuobjdump."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    return subprocess.run([exe, "-sass", str(so)], capture_output=True,
                          text=True).stdout


def _sass_hot_loops(so, kernel: str):
    """The innermost loops of `kernel` that hold FMNMX (a loop is a
    backward branch in cuobjdump's SASS of the library): each one's address
    range, instruction count and the count of each opcode in SASS_OPS.
    None when cuobjdump or the kernel is not found."""
    text = _sass(so)
    if text is None:
        return None
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


def _kernel_name(mangled: str) -> str:
    """A kernel's mangled name shortened to name<template int>..."""
    m = re.match(r"_Z(\d+)", mangled)
    name = mangled[m.end():m.end() + int(m.group(1))] if m else mangled
    return name + "".join(f"<{a}>" for a in re.findall(r"L[ib](\d+)E",
                                                        mangled))


def _ptxas_report(text: str) -> list:
    """(kernel, registers, spill store + load bytes) from nvcc -Xptxas -v:
    the kernel's mangled name shortened to name<template int>."""
    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        name = _kernel_name(chunk.split("'", 1)[0])
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
    if not _quality_launches_ok(counts):
        raise AssertionError(f"main path made {counts} kernel launches, "
                             f"expected 3 K5 and the limiter's kernel once")

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


def _limiter_input(n: int, seed: int) -> torch.Tensor:
    """[n, 2] on the card: gated noise and a 100 Hz tone (the benchmark
    cells' content) with clicks six times as loud, which pull the
    limiter's gain to ~0.1."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.25 * rng.standard_normal((n, 2))
         + 0.3 * np.sin(2 * np.pi * 100 * t)[:, None])
    x[(np.floor(t / 1.7) % 2) == 1] = 0.0
    for at in rng.integers(0, n, max(n // 100_000, 1)):
        x[at:at + 30] *= 6.0
    return torch.from_numpy(x.astype(np.float32)).cuda()


def phase_limiter() -> dict:
    """The quality limiter's kernel against its plain version on the card
    at [2^23 + 1234, 2] and the cells' mean track (gain within
    LIMITER_TOL, y within LIMITER_TOL per unit of |x|), then timed: 10
    calls in a row and one alone, the plain version, and the bound (x
    read and y written once). A tree without the kernel (an older one)
    runs and times only its plain limiter, as its chain ran it."""
    from ame_tpu_torch.ops import limiter
    w = int(5.0 * SR / 1000.0)
    rho = math.exp(-1.0 / (50.0 * SR / 1000.0))
    kernel = getattr(limiter, "lookahead_limiter_cuda", None)
    rows = []
    for n in (N_KERNEL, N_MEAN_TRACK):
        x = _limiter_input(n, seed=n)
        bound = _bound(2 * x.numel() * 4, 0)
        row = {"n": n, "bound": bound}
        if kernel is None:
            row["plain_ms"] = _cuda_ms(lambda: limiter.lookahead_limiter(
                x, SR))
            print(f"lookahead_limiter [{n}, 2]: plain {row['plain_ms']:.4f} "
                  f"ms (this tree has no kernel)")
            rows.append(row)
            continue
        y, g = kernel(x, w, rho, 0.98, True)
        y_p, g_p = limiter.lookahead_limiter_plain(x, w, rho, 0.98, True)
        row["max_abs_err_gain"] = (g - g_p).abs().max().item()
        row["max_abs_err_y"] = (y - y_p).abs().max().item()
        row["max_abs_x"] = x.abs().max().item()
        row["min_gain"] = g.min().item()
        if not (row["max_abs_err_gain"] <= LIMITER_TOL
                and row["max_abs_err_y"]
                <= LIMITER_TOL * max(1.0, row["max_abs_x"])):
            raise AssertionError(f"lookahead_limiter vs plain at [{n}, 2]: "
                                 f"{row}")
        row["ms"] = _cuda_ms(lambda: kernel(x, w, rho), KERNEL_CALLS)
        row["one_call_ms"] = _cuda_ms(lambda: kernel(x, w, rho))
        row["plain_ms"] = _cuda_ms(
            lambda: limiter.lookahead_limiter_plain(x, w, rho))
        print(f"lookahead_limiter [{n}, 2]: |gain| err "
              f"{row['max_abs_err_gain']:.3e}, |y| err "
              f"{row['max_abs_err_y']:.3e} (|x| <= {row['max_abs_x']:.2f}, "
              f"gain >= {row['min_gain']:.3f}); kernel {row['ms']:.4f} ms "
              f"({bound[0] / row['ms']:.1%} of its bound {bound[0]:.4f} ms; "
              f"one call alone {row['one_call_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms")
        rows.append(row)
    if kernel is None:
        return {"rows": rows}
    return {"rows": rows, "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
            "bound": rows[0]["bound"],
            "max_abs_err": max(r["max_abs_err_gain"] for r in rows)}


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
    ok, sweeps = [bool(v) for v in ok], int(sweeps)
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
    ok_t, sweeps_t = [bool(v) for v in ok_t], int(sweeps_t)
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
    ok_c, sweeps_c = [bool(v) for v in ok_c], int(sweeps_c)
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
    sweeps = int(sweeps)
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
    ok, sweeps = [bool(v) for v in ok], int(sweeps)
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
    if not _quality_launches_ok(counts, k5=want):
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
        ok, sweeps = [bool(v) for v in ok], int(sweeps)
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


SOS_GRAD_NS = (1, 2, 3, 31, 4097, (1 << 20) + 7, N_KERNEL)
SOS_GRAD_CS = (1, 2, 3, 16)
SOS_GRAD_LIB_TOL = 1e-4        # relative: the library call sums in f32


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative error of got against want; a sum that is 0 in
    want must be 0 in got."""
    return ((got - want).abs() / want.abs().clamp_min(1e-300)).max().item()


def _sos_grad_layouts(n: int, c: int, seed: int) -> dict:
    """{layout: (g, v, w)} on the card, the same values in each: v and w
    the halves of one [n, 2c] tensor (as the backward passes them),
    separate contiguous tensors, and the halves of an [n, 2c] view one
    float past an allocation's start (rows not aligned)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn(n, c, device="cuda", generator=gen)
    vw = 30.0 * torch.randn(n, 2 * c, device="cuda", generator=gen)
    flat = torch.empty(n * 2 * c + 1, device="cuda")
    flat[1:] = vw.reshape(-1)
    off = flat[1:].view(n, 2 * c)
    return {"halves": (g, vw[:, :c], vw[:, c:]),
            "separate": (g, vw[:, :c].clone(), vw[:, c:].clone()),
            "unaligned": (g, off[:, :c], off[:, c:])}


def _sos_grad_sweep() -> dict:
    """(b) sos_grad against sos_grad_plain at every N in SOS_GRAD_NS and C
    in SOS_GRAD_CS, in each of _sos_grad_layouts' layouts: relative error
    within 1e-9, the same bits on a second call, the vector route taken
    exactly for the halves at C <= 2, and the same bits in every layout
    (both routes add the same products in the same order)."""
    from ame_tpu_torch.ops.sos_grad import sos_grad_cuda, sos_grad_plain
    worst, cases = 0.0, 0
    for n in SOS_GRAD_NS:
        for c in SOS_GRAD_CS:
            sums = {}
            for layout, (g, v, w) in _sos_grad_layouts(n, c, n + c).items():
                vec0 = sos_grad_cuda.vector_launches
                got = sos_grad_cuda(g, v, w)
                again = sos_grad_cuda(g, v, w)
                vector = (sos_grad_cuda.vector_launches - vec0) // 2
                rel = _rel_err(got, sos_grad_plain(g, v, w))
                label = f"sos_grad [{n}, {c}] {layout}"
                if not rel <= SOS_GRAD_TOL or not torch.equal(got, again):
                    raise AssertionError(f"{label}: relative {rel:.3e} > "
                                         f"{SOS_GRAD_TOL}, or not the same "
                                         f"twice")
                if vector != (layout == "halves" and c <= 2):
                    raise AssertionError(f"{label}: vector route {vector}")
                sums[layout] = got
                worst, cases = max(worst, rel), cases + 1
            if not all(torch.equal(x, sums["halves"]) for x in sums.values()):
                raise AssertionError(f"sos_grad [{n}, {c}]: the layouts "
                                     f"disagree: {sums}")
    print(f"sos_grad sweep: {cases} cases (N {SOS_GRAD_NS} x C "
          f"{SOS_GRAD_CS} x 3 layouts), relative error <= {worst:.3e}, "
          f"the same bits twice and in every layout")
    return {"cases": cases, "max_rel_err": worst, "n": list(SOS_GRAD_NS),
            "c": list(SOS_GRAD_CS)}


def _sos_grad_library(g, v, w):
    """The yardstick: one torch.einsum over lags x (v, w) x columns, an
    as_strided view of a zero-padded copy of v|w (made here, outside the
    timed call). Returns (the call, its result in sos_grad's order)."""
    n, c = g.shape
    pad = torch.zeros(n + 2, 2 * c, device=g.device)
    pad[2:, :c], pad[2:, c:] = v, w
    V = pad.as_strided((n, 3, 2, c), (2 * c, 2 * c, c, 1))   # lag 2 - i

    def call():
        return torch.einsum("tc,tikc->ik", g, V)
    r = call().double()
    return call, torch.stack([r[2, 0], r[1, 0], r[0, 0], -r[1, 1],
                              -r[0, 1]])


def _sos_grad_time() -> dict:
    """sos_grad at [2^23 + 1234, 2], v and w the halves of one [N, 4]
    tensor as the backward passes them: held to sos_grad_plain (relative
    1e-9, the same bits twice), timed beside it, its bound and the library
    yardstick (held to plain within 1e-4 relative); the device time of a
    launch by kernel (torch.profiler: the mean over the records it kept,
    which it may drop after long streams of small launches, as in
    _launch_ms). Runs on the package on sys.path, so that
    --kernel-times can time a parent tree's kernel."""
    from ame_tpu_torch.ops.sos_grad import sos_grad_cuda, sos_grad_plain
    g, v, w = _sos_grad_layouts(N_KERNEL, 2, 10)["halves"]
    got = sos_grad_cuda(g, v, w)
    again = sos_grad_cuda(g, v, w)
    want = sos_grad_plain(g, v, w)
    rel = _rel_err(got, want)
    if not rel <= SOS_GRAD_TOL or not torch.equal(got, again):
        raise AssertionError(f"sos_grad vs plain: relative {rel:.3e} > "
                             f"{SOS_GRAD_TOL}, or not the same twice")
    lib_call, lib = _sos_grad_library(g, v, w)
    lib_rel = _rel_err(lib, want)
    if not lib_rel <= SOS_GRAD_LIB_TOL:
        raise AssertionError(f"sos_grad library yardstick vs plain: "
                             f"relative {lib_rel:.3e} > {SOS_GRAD_LIB_TOL}")
    ms = _cuda_ms(lambda: sos_grad_cuda(g, v, w), KERNEL_CALLS)
    one_ms = _cuda_ms(lambda: sos_grad_cuda(g, v, w))
    plain_ms = _cuda_ms(lambda: sos_grad_plain(g, v, w))
    library_ms = _cuda_ms(lib_call)
    device_ms = {k: ms / n for k, (ms, n) in _profile(
        lambda: sos_grad_cuda(g, v, w), 20).items()}
    bound = _sos_grad_bound(N_KERNEL, 2)
    print(f"sos_grad [{N_KERNEL}, 2]: relative err {rel:.3e}; kernel "
          f"{ms:.4f} ms ({bound[0] / ms:.1%} of its bound {bound[0]:.4f} "
          f"ms; one call {one_ms:.4f}), plain {plain_ms:.4f} ms, library "
          f"{library_ms:.4f} ms (relative err {lib_rel:.3e}); device ms a "
          f"launch by kernel {device_ms}")
    return {"max_rel_err": rel, "max_abs_err": (got - want).abs().max().item(),
            "ms": ms, "one_call_ms": one_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_rel_err": lib_rel,
            "device_ms": device_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bound_share": bound[0] / ms,
            "shape": [N_KERNEL, 2]}


def _fit_sos_grad() -> dict:
    """(b) the sweep over shapes and layouts, then the time at the fit's
    shape."""
    return {**_sos_grad_time(), "sweep": _sos_grad_sweep()}


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
    if (got != want or counts["sos_grad_vector"] != counts["sos_grad"]
            or any(counts[k] for k in ("wedge_env", "gain_jacobi",
                                       "gain_p1", "gain_p2"))):
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


# ---------------------------------------------------------------------------
# Phase 15: the server and the CLI
# ---------------------------------------------------------------------------
SERVE_DEVICE = "cuda"
SERVE_POLL_S = 0.002
SERVE_TIMEOUT_S = 300
SERVE_ART_PROMPT = "a serene, tranquil pastel artwork of a mountain lake"
SERVE_QUALITY = dict(FLAGSHIP, create_mp3=False)
SERVE_COMPAT = dict(COMPAT, create_mp3=False)
MP3_PAD = 5000                 # tests/test_io.py:80-83: the encoder's padding
MEASURE_TOL = 0.01
FLAC_BLOCK = 4096
CLI_FLAGSHIP = ["--analog-character", "20", "--bass", "2", "--presence",
                "1.5", "--width", "1.2"]
PASS1_KEYS = {"input_i", "input_tp", "input_lra", "input_thresh",
              "output_i", "target_offset"}


def _flac_verbatim(path: str, pcm: np.ndarray, sr: int) -> None:
    """Write int16 [N, C] as a FLAC stream of verbatim subframes, every
    field byte-aligned (frames of FLAC_BLOCK, each header with its 16-bit
    block size; CRCs and MD5 zero: the port's decoder checks none)."""
    n, c = pcm.shape
    info = struct.pack(">HHHBHB", FLAC_BLOCK, FLAC_BLOCK, 0, 0, 0, 0)
    info += struct.pack(">Q", (sr << 44) | ((c - 1) << 41) | (15 << 36) | n)
    out = [b"fLaC", b"\x80" + struct.pack(">I", len(info) + 16)[1:],
           info, bytes(16)]
    for i, s in enumerate(range(0, n, FLAC_BLOCK)):
        block = pcm[s:s + FLAC_BLOCK]
        out.append(b"\xff\xf8" + bytes([0x70, ((c - 1) << 4) | 0x08])
                   + chr(i).encode("utf-8")
                   + struct.pack(">H", len(block) - 1) + b"\x00")
        for ch in range(c):
            out.append(b"\x02" + block[:, ch].astype(">i2").tobytes())
        out.append(b"\x00\x00")
    with open(path, "wb") as f:
        f.write(b"".join(out))


def _http(base: str, path: str, payload=None, body=None) -> dict:
    """One JSON request: POST `payload` as JSON, PUT `body`, else GET."""
    import urllib.request
    if body is not None:
        req = urllib.request.Request(base + path, body, method="PUT")
    elif payload is not None:
        req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                     {"Content-Type": "application/json"})
    else:
        req = urllib.request.Request(base + path)
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT_S) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(workdir: str, workers: int):
    """make_server on a free port, served from a thread, shut down after."""
    from ame_tpu_torch.serve.server import make_server
    srv, store = make_server(port=0, workdir=workdir, workers=workers,
                             device=SERVE_DEVICE)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", store
    finally:
        srv.shutdown()
        srv.server_close()


def _upload(base: str, src: str):
    """PUT `src` as the web client does: (gcs_uri, PUT seconds, PUT end on
    the host clock)."""
    r = _http(base, "/generate-upload-url",
              {"filename": os.path.basename(src)})
    with open(src, "rb") as f:
        body = f.read()
    t0 = time.perf_counter()
    put = _http(base, r["url"], body=body)
    t1 = time.perf_counter()
    if put != {"ok": True, "bytes": len(body)}:
        raise AssertionError(f"PUT {src}: {put}")
    return r["gcs_uri"], t1 - t0, t1


def _start(base: str, uri: str, settings: dict):
    r = _http(base, "/start-processing", {"gcs_uri": uri,
                                          "settings": settings})
    return r["processed_filename"], r["image_filename"]


def _wait(base: str, name: str, image: str):
    """Poll /status until the job leaves `processing`: (status, the host
    clock then)."""
    deadline = time.perf_counter() + SERVE_TIMEOUT_S
    while True:
        st = _http(base, f"/status?audio_filename={name}"
                         f"&image_filename={image}")
        if st["status"] != "processing":
            return st, time.perf_counter()
        if time.perf_counter() > deadline:
            raise AssertionError(f"served job {name}: still processing")
        time.sleep(SERVE_POLL_S)


def _check_job(store, name: str, st: dict, label: str) -> dict:
    from ame_tpu_torch.serve.server import _serve_devices
    job = store.job_snapshot(name)
    msgs = job["messages"]
    if (st["status"] != "done"
            or not any(m.startswith("Success:") for m in msgs)
            or any(m.startswith(("Error:", "Failed:")) for m in msgs)
            or job.get("device") != str(_serve_devices(SERVE_DEVICE)[0])):
        raise AssertionError(f"served {label}: status {st}, device "
                             f"{job.get('device')}, messages {msgs}")
    return job


def _served(base: str, store, src: str, settings: dict, label: str) -> dict:
    """Upload, then with the counts at 0 start the job, wait for done and
    read the counts: the job's checks, output, latency from the PUT's end to
    done and launches."""
    from ame_tpu_torch.io.wav import read_wav
    uri, put_s, put_end = _upload(base, src)
    _zero_counts()
    name, image = _start(base, uri, settings)
    st, t_done = _wait(base, name, image)
    counts = _read_counts()
    job = _check_job(store, name, st, label)
    pcm, sr = read_wav(store.output_path(name), prefer_int16=True)
    return {"label": label, "uri": uri, "name": name, "status": st,
            "job": job, "pcm": pcm, "sr": sr, "counts": counts,
            "put_s": put_s, "latency_s": t_done - put_end}


def _lsb(a: np.ndarray, b: np.ndarray) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} vs {b.shape}")
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _out_lufs(pcm: np.ndarray, sr: int) -> float:
    from ame_tpu_torch.ops.loudness import measure
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(SERVE_DEVICE)
    return measure(x, sr)["input_i"].item()


def _check_quality(r: dict) -> float:
    """K5 exactly 3 launches, the limiter's kernel one and nothing else;
    -14 LUFS within 0.5 LU."""
    if not _quality_launches_ok(r["counts"]):
        raise AssertionError(f"served {r['label']}: launches {r['counts']}, "
                             f"expected 3 cascade_scan, 1 lookahead_limiter "
                             f"and nothing else")
    out_i = _out_lufs(r["pcm"], r["sr"])
    if abs(out_i + 14.0) > LUFS_TOL:
        raise AssertionError(f"served {r['label']} measures {out_i} LUFS")
    return out_i


def _png_size(path: str):
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def _cli(args: list) -> list:
    """``python -m ame_tpu_torch`` with each argument list, all started
    together from the checkout on the device; returns [(wall s, stdout
    JSON lines)], fails on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [(time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "ame_tpu_torch", *a, "--device",
         SERVE_DEVICE], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for a in args]
    out = []
    for a, (t0, p) in zip(args, procs):
        try:
            stdout, stderr = p.communicate(timeout=SERVE_TIMEOUT_S)
        finally:
            p.kill()
        if p.returncode != 0:
            raise AssertionError(f"cli {a[0]}: exit {p.returncode}\n"
                                 f"{stderr[-3000:]}")
        out.append((time.perf_counter() - t0,
                    [json.loads(ln) for ln in stdout.splitlines()
                     if ln.startswith("{")]))
    return out


def phase_serve(tmp: str, device_chain_ms: float) -> dict:
    """Phase 15: (a) a flagship quality job over HTTP with the MP3 sidecar
    and procedural art; a quality job without them; (b) an MP3 upload the
    port encoded, and a FLAC upload; (c) a compat multiband job; (d)
    /measure; (e) 4 jobs at once on 2 workers; (f) the CLI in
    subprocesses. Launches are held in (a)-(c) and, summed over its jobs,
    in (e) (the counters are atomic)."""
    from ame_tpu_torch.api import export_mp3_sidecar, master_file
    from ame_tpu_torch.creative import art, procedural
    from ame_tpu_torch.io import av, codecs, force_stereo, read_audio
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.ops.loudnorm import loudnorm_pass1

    src = os.path.join(tmp, "in.wav")            # phase 4's
    compat_src = os.path.join(tmp, "compat_in.wav")   # phase 8's
    libs = {"lame": codecs.have_mp3_encode(),
            "mpg123": codecs.have_mp3_decode(), "libav": av.have_av()}
    mp3 = libs["lame"] and libs["mpg123"]
    mp3_note = ("checked" if mp3 else "unavailable: " + ", ".join(
        f"lib{k} not found" for k in ("mp3lame", "mpg123")
        if not libs["lame" if k == "mp3lame" else "mpg123"]))
    pcm_src, _ = read_wav(src, prefer_int16=True)
    n = pcm_src.shape[0]
    saved_env = os.environ.get("AME_TPU_ART_PROVIDER")
    saved_art = (art._providers, art._active)
    os.environ["AME_TPU_ART_PROVIDER"] = "procedural"
    art._providers, art._active = {}, None
    try:
        with _serving(os.path.join(tmp, "serve1"), 1) as (base, store):
            # (a)
            a = _served(base, store, src, dict(
                SERVE_QUALITY, create_mp3=mp3, art_prompt=SERVE_ART_PROMPT,
                auto_generate_prompt=False), "quality_mp3_art")
            a_i = _check_quality(a)
            ref = os.path.join(tmp, "serve_ref.wav")
            master_file(src, ref, FLAGSHIP, device=SERVE_DEVICE)
            ref_pcm, _ = read_wav(ref, prefer_int16=True)
            a_lsb = _lsb(a["pcm"], ref_pcm)
            if a_lsb > 1:
                raise AssertionError(f"served master vs master_file: "
                                     f"{a_lsb} LSB")
            art_file = a["job"].get("art_file")
            if (not art_file or a["status"].get("art_url") is None
                    or _png_size(art_file) != (1024, 1024)):
                raise AssertionError(f"served art: {art_file}, status "
                                     f"{a['status']}")
            mp3_len = None
            if mp3:
                y, _ = codecs.decode_mp3(store.output_path(
                    a["name"][:-4] + ".mp3"))
                mp3_len = len(y)
                if "mp3_url" not in a["status"] or abs(mp3_len - n) >= MP3_PAD:
                    raise AssertionError(f"MP3 sidecar: {mp3_len} samples "
                                         f"against {n}")
            a2 = _served(base, store, src, SERVE_QUALITY, "quality")
            _check_quality(a2)
            # (b)
            uploads = {}
            if mp3:
                up_mp3 = os.path.join(tmp, "serve_in.mp3")
                x_src, _ = read_audio(src)
                t0 = time.perf_counter()
                codecs.encode_mp3(up_mp3, x_src, SR)
                uploads["mp3_encode_track_s"] = time.perf_counter() - t0
                b = _served(base, store, up_mp3, SERVE_QUALITY, "mp3_upload")
                uploads["mp3"] = {"lufs": _check_quality(b),
                                  "latency_s": b["latency_s"],
                                  "counts": b["counts"]}
            up_flac = os.path.join(tmp, "serve_in.flac")
            _flac_verbatim(up_flac, pcm_src, SR)
            bf = _served(base, store, up_flac, SERVE_QUALITY, "flac_upload")
            flac_lsb = _lsb(bf["pcm"], a2["pcm"])
            if flac_lsb > 1:
                raise AssertionError(f"FLAC upload vs WAV upload: "
                                     f"{flac_lsb} LSB")
            uploads["flac"] = {"lufs": _check_quality(bf),
                               "latency_s": bf["latency_s"],
                               "vs_wav_lsb": flac_lsb}
            # (c)
            c = _served(base, store, compat_src, SERVE_COMPAT, "compat")
            cc = c["counts"]
            if (cc["wedge_env"] != 2 or cc["cascade_scan"] != 7
                    or cc["gain_jacobi"] < 1 or cc["gain_p1"] != 0
                    or cc["gain_p2"] != 0):
                raise AssertionError(f"served compat launches {cc}")
            ref_c = os.path.join(tmp, "serve_ref_compat.wav")
            master_file(compat_src, ref_c, COMPAT, device=SERVE_DEVICE)
            c_lsb = _lsb(c["pcm"], read_wav(ref_c, prefer_int16=True)[0])
            if c_lsb > 1:
                raise AssertionError(f"served compat vs master_file: {c_lsb}"
                                     f" LSB")
            # (d)
            stats = _http(base, "/measure", {"gcs_uri": a["uri"]})
            audio, sr = read_audio(src)
            direct = loudnorm_pass1(torch.from_numpy(np.ascontiguousarray(
                force_stereo(audio))).to(SERVE_DEVICE), sr, target_i=-14.0)
            measure_err = max(abs(stats[k] - float(v))
                              for k, v in direct.items())
            if set(direct) < PASS1_KEYS or measure_err > MEASURE_TOL:
                raise AssertionError(f"/measure {stats} vs direct {direct}")
        # host parts of a served job, timed alone
        t0 = time.perf_counter()
        read_audio(src, prefer_int16=True)
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        procedural.render(SERVE_ART_PROMPT, os.path.join(tmp, "art.png"))
        art_ms = (time.perf_counter() - t0) * 1e3
        mp3_encode_s = None
        if libs["lame"]:
            t0 = time.perf_counter()
            export_mp3_sidecar(ref, lambda m: None)
            mp3_encode_s = time.perf_counter() - t0
        # (e)
        with _serving(os.path.join(tmp, "serve2"), 2) as (base, store):
            srcs = [src, src, compat_src, compat_src]
            sets = [SERVE_QUALITY, SERVE_QUALITY, SERVE_COMPAT, SERVE_COMPAT]
            uris = [_upload(base, s)[0] for s in srcs]
            _zero_counts()
            t0 = time.perf_counter()
            jobs = [_start(base, u, s) for u, s in zip(uris, sets)]
            sts = [_wait(base, *j) for j in jobs]
            burst_s = max(t for _, t in sts) - t0
            # the counters are atomic: the burst's launches are the sum of
            # its jobs' launches one at a time
            burst_counts = _read_counts()
            want_counts = {k: 2 * a2["counts"][k] + 2 * cc[k]
                           for k in burst_counts}
            if burst_counts != want_counts:
                raise AssertionError(f"burst launches {burst_counts} != "
                                     f"the jobs' one at a time "
                                     f"{want_counts}")
            burst_lsb = []
            for (name, _), (st, _), one in zip(jobs, sts, [a2, a2, c, c]):
                _check_job(store, name, st, "burst")
                pcm, _ = read_wav(store.output_path(name), prefer_int16=True)
                burst_lsb.append(_lsb(pcm, one["pcm"]))
            if max(burst_lsb) > 1:
                raise AssertionError(f"burst vs one at a time: {burst_lsb} "
                                     f"LSB")
    finally:
        art._providers, art._active = saved_art
        if saved_env is None:
            os.environ.pop("AME_TPU_ART_PROVIDER", None)
        else:
            os.environ["AME_TPU_ART_PROVIDER"] = saved_env
    # (f)
    cli_out = os.path.join(tmp, "cli_out.wav")
    (m_s, m_js), (me_s, me_js), (an_s, an_js), (au_s, au_js) = _cli([
        ["master", src, cli_out, *CLI_FLAGSHIP, "--mp3"],
        ["measure", src], ["analyze", src],
        ["automaster", src, compat_src, "--steps", "3"]])
    info, meas, brief, fitted = m_js[-1], me_js[-1], an_js[-1], au_js[0]
    cli_i = _out_lufs(read_wav(cli_out, prefer_int16=True)[0], SR)
    cli_mp3 = os.path.exists(cli_out[:-4] + ".mp3")
    if (info.get("output_file") != cli_out or abs(cli_i + 14.0) > LUFS_TOL
            or cli_mp3 != libs["lame"]
            or not PASS1_KEYS | {"sample_rate"} <= set(meas)
            or abs(meas["input_i"] - float(direct["input_i"])) > MEASURE_TOL
            or set(brief) != BRIEF_KEYS
            or not math.isfinite(fitted.get("loss", float("nan")))):
        raise AssertionError(f"cli: master {info} ({cli_i} LUFS, mp3 "
                             f"{cli_mp3}), measure {meas}, analyze {brief}, "
                             f"automaster {fitted}")
    latency_ms = a2["latency_s"] * 1e3
    out = {
        "device": str(SERVE_DEVICE), "libs": libs, "mp3": mp3_note,
        "latency_ms": {"quality_mp3_art": a["latency_s"] * 1e3,
                       "quality": latency_ms,
                       "compat": c["latency_s"] * 1e3,
                       **{f"{k}_upload": v["latency_s"] * 1e3
                          for k, v in uploads.items() if isinstance(v, dict)}},
        "put_s": a["put_s"], "upload_mb": os.path.getsize(src) / 2 ** 20,
        "host": {"decode_ms": decode_ms, "art_ms": art_ms,
                 "mp3_encode_s": mp3_encode_s,
                 "mp3_encode_track_s": uploads.get("mp3_encode_track_s"),
                 "device_chain_ms": device_chain_ms,
                 "host_share_quality": 1.0 - device_chain_ms / latency_ms},
        "launches": {"quality_mp3_art": a["counts"], "quality": a2["counts"],
                     "flac_upload": bf["counts"], "compat": cc},
        "lsb": {"served_vs_master_file": a_lsb, "compat_vs_master_file":
                c_lsb, "flac_vs_wav": flac_lsb, "burst": burst_lsb},
        "lufs": {"quality": a_i, "flac": uploads["flac"]["lufs"]},
        "mp3_len": mp3_len, "n": n, "measure_max_err": measure_err,
        "burst": {"jobs": len(jobs), "workers": 2, "wall_s": burst_s,
                  "jobs_per_s": len(jobs) / burst_s,
                  "launches": {k: v for k, v in burst_counts.items() if v}},
        "cli_s": {"master": m_s, "measure": me_s, "analyze": an_s,
                  "automaster": au_s},
        "cli": {"lufs": cli_i, "mp3": cli_mp3, "loss": fitted["loss"],
                "mood": brief["mood"]}}
    print(f"serve: quality job {latency_ms:.1f} ms from the PUT's end "
          f"(with MP3 and art {a['latency_s'] * 1e3:.1f}), compat "
          f"{c['latency_s'] * 1e3:.1f}; burst of 4 on 2 workers "
          f"{burst_s:.3f} s = {len(jobs) / burst_s:.2f} jobs/s; K5 "
          f"{a2['counts']['cascade_scan']} a quality job, compat {cc}; "
          f"served vs master_file {a_lsb} LSB; mp3 {mp3_note}; libs {libs}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the GUI, fleet, batch, profile and evaluation surfaces
# ---------------------------------------------------------------------------
GUI_POLL_S = 0.005
GUI_TIMEOUT_S = 600
GUI_FIT_STEPS = 120             # ame_tpu/gui.py's _fit_files
BATCH = 4
BATCH_SEEDS = (4, 5, 6)         # _noise_input's seeds for the 3 more tracks
PROFILE_RUNS = 5
EVAL_SEED = 77                  # tests/test_mood_model.py:40-84's protocol
EVAL_PER_CLASS = 4
EVAL_SECONDS = 20.0
EVAL_FLOOR = 0.75
GOLDEN_TOL_LU = 0.1
FLEET_QUALITY = dict(FLAGSHIP, create_mp3=False)
FLEET_COMPAT = {"mode": "compat", "multiband": True}
VIEW_METHODS = ("set_status", "set_progress", "set_tag", "show_art",
                "set_busy", "set_match_busy", "show_info", "show_error",
                "set_value", "enable_multiband")


class _RecorderView:
    """The GUI controller's view surface, recording every call in order."""

    def __init__(self):
        self.calls = []
        self.values = {}

    def __getattr__(self, name):
        if name not in VIEW_METHODS:
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, *args))
            if name == "set_value":
                self.values[args[0]] = args[1]
        return record

    def kind(self, name):
        return [c[1:] for c in self.calls if c[0] == name]


def _pump(ctl, done) -> float:
    """Drain the controller's queue like the Tk after() loop until done();
    returns the seconds it took."""
    t0 = time.perf_counter()
    while True:
        ctl.drain()
        if done():
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > GUI_TIMEOUT_S:
            raise AssertionError("GUI job did not finish")
        time.sleep(GUI_POLL_S)


def _gui(tmp: str, src: str) -> dict:
    """(a) The GUI controller headless on the card: a flagship job through
    the port's process_audio on a worker thread (launches counted around
    it), and Match Reference through _fit_files against phase 13's target."""
    import functools
    from ame_tpu_torch import api, gui
    from ame_tpu_torch.gui_logic import GuiController, build_settings
    from ame_tpu_torch.io.wav import read_wav, write_wav
    sliders = {key: default for _, key, _, _, default in
               gui.MAIN_SLIDERS + gui.MB_SLIDERS}
    sliders.update({k: FLAGSHIP[k] for k in ("analog_character",
                                             "bass_boost", "presence_boost",
                                             "width", "lufs")})
    out = os.path.join(tmp, "gui_out.wav")
    settings = build_settings(sliders, input_file=src, output_file=out,
                              multiband=False, art_prompt="",
                              auto_generate_prompt=False, create_mp3=False)
    view = _RecorderView()
    ctl = GuiController(view)
    _zero_counts()
    t0 = time.perf_counter()
    worker = ctl.start(settings, functools.partial(api.process_audio,
                                                   device="cuda"))
    _pump(ctl, lambda: not ctl.busy)
    job_s = time.perf_counter() - t0
    worker.join(GUI_TIMEOUT_S)
    counts = _read_counts()
    statuses = [s for (s,) in view.kind("set_status")]
    progress = view.kind("set_progress")
    infos = view.kind("show_info")
    ref = os.path.join(tmp, "gui_ref.wav")
    api.master_file(src, ref, FLAGSHIP, device="cuda")
    lsb = _lsb(read_wav(out, prefer_int16=True)[0],
               read_wav(ref, prefer_int16=True)[0])
    if (sum(s.startswith("Success:") for s in statuses) != 1
            or any(s.startswith(("Error:", "Failed:")) for s in statuses)
            or progress[-1][0] != progress[-1][1] or len(infos) != 1
            or not _quality_launches_ok(counts) or lsb > 1):
        raise AssertionError(f"GUI job: statuses {statuses}, progress "
                             f"{progress[-3:]}, dialogs {infos}, launches "
                             f"{counts}, vs master_file {lsb} LSB")
    # Match Reference: _fit_files (120 steps) against the +4 dB bass target
    _, t = _fit_inputs()
    target = os.path.join(tmp, "fit_target.wav")
    write_wav(target, t.cpu().numpy(), SR, bits=32)
    del t
    t0 = time.perf_counter()
    ctl.start_match(src, target, False,
                    functools.partial(gui._fit_files, device="cuda"))
    _pump(ctl, lambda: view.kind("set_match_busy")[-1] == (False,))
    match_s = time.perf_counter() - t0
    last = [s for (s,) in view.kind("set_status")][-1]
    bass = view.values.get("bass_boost")
    bass_default = {k: d for _, k, _, _, d in gui.MAIN_SLIDERS}["bass_boost"]
    if (not last.startswith("Success: matched reference") or bass is None
            or not bass > bass_default or ctl.busy):
        raise AssertionError(f"GUI match: status {last!r}, fitted values "
                             f"{view.values}")
    print(f"gui: job {job_s:.3f} s (K5 {counts['cascade_scan']}, vs "
          f"master_file {lsb} LSB, {len(statuses)} statuses, progress "
          f"{progress[-1]}); match {GUI_FIT_STEPS} steps {match_s:.2f} s, "
          f"fitted {view.values}")
    return {"job_s": job_s, "counts": counts, "lsb_vs_master_file": lsb,
            "statuses": len(statuses), "match_s": match_s,
            "fitted": dict(view.values), "match_status": last}


def _fleet(tmp: str, src: str, compat_src: str) -> dict:
    """(b) run_fleet over five files into one output directory and one
    manifest (a directory of the quality WAV, its FLAC, an AIFF of the
    quality track and a corrupt WAV in quality mode, then a directory of
    the compat WAV in compat mode), twice; launches and time per track
    from the loader's yield to the manifest's fsync; then the fleet CLI in
    a subprocess."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.io import loader
    from ame_tpu_torch.io.wav import read_wav, write_aiff
    from ame_tpu_torch.parallel import fleet
    indir, outdir = os.path.join(tmp, "fleet_in"), os.path.join(tmp,
                                                                "fleet_out")
    compat_dir = os.path.join(tmp, "fleet_in_compat")
    manifest_path = os.path.join(outdir, "fleet_manifest.json")
    os.makedirs(indir)
    os.makedirs(compat_dir)
    pcm, _ = read_wav(src, prefer_int16=True)
    files = {"a_quality.wav": None, "b_quality.flac": None,
             "c_compat.wav": FLEET_COMPAT, "d_quality.aiff": None,
             "e_corrupt.wav": None}
    shutil.copy(src, os.path.join(indir, "a_quality.wav"))
    _flac_verbatim(os.path.join(indir, "b_quality.flac"), pcm, SR)
    shutil.copy(compat_src, os.path.join(compat_dir, "c_compat.wav"))
    write_aiff(os.path.join(indir, "d_quality.aiff"), pcm, SR, 16)
    with open(os.path.join(indir, "e_corrupt.wav"), "wb") as f:
        f.write(b"RIFF\x24\x00\x00\x00WAVEnot a wave at all")

    def run_both(**kw):
        """The quality directory, then the compat one; summed counts."""
        runs = [fleet.run_fleet(d, outdir, settings,
                                manifest_path=manifest_path, **kw)
                for d, settings in ((indir, FLEET_QUALITY),
                                    (compat_dir, {**FLEET_QUALITY,
                                                  **FLEET_COMPAT}))]
        return {k: sum(r[k] for r in runs)
                for k in ("total", "done", "resumed_skips", "failed")}

    marks, starts = {}, {}
    mark = fleet.Manifest.mark

    def timed_mark(self, track, status, **extra):
        mark(self, track, status, **extra)
        marks[track] = (time.perf_counter() - starts[track], status,
                        _read_counts())

    def on_status(msg):
        if msg.startswith("Mastering "):
            name = msg[len("Mastering "):-len("...")]
            _zero_counts()
            starts[name] = time.perf_counter()

    loader.decodes = {"native": {}, "python": {}}
    fleet.Manifest.mark = timed_mark
    try:
        t0 = time.perf_counter()
        s1 = run_both(status_callback=on_status)
        run_s = time.perf_counter() - t0
        decodes = {k: dict(v) for k, v in loader.decodes.items()}
    finally:
        fleet.Manifest.mark = mark
    s2 = run_both()
    with open(manifest_path) as f:
        manifest = json.load(f)
    states = {k: v["status"] for k, v in manifest.items()}
    want_states = {k: ("error" if k.startswith("e_") else "done")
                   for k in files}
    if (states != want_states or s1["done"] != 4 or s1["failed"] != 1
            or s2["done"] != 0 or s2["resumed_skips"] != 4
            or s2["failed"] != 1
            or decodes != {"native": {".wav": 2, ".flac": 1},
                           "python": {".aiff": 1, ".wav": 1}}):
        raise AssertionError(f"fleet: manifest {states}, runs {s1} / {s2}, "
                             f"decodes {decodes}")
    lsb, launches = {}, {}
    for name, over in files.items():
        counts = marks[name][2]
        launches[name] = counts
        if name.startswith("e_"):
            if any(counts.values()):
                raise AssertionError(f"fleet {name}: launches {counts}")
            continue
        if over:
            ok = (counts["wedge_env"] == 2 and counts["cascade_scan"] == 7
                  and counts["gain_jacobi"] >= 1 and not counts["gain_p1"]
                  and not counts["gain_p2"])
        else:
            ok = _quality_launches_ok(counts)
        if not ok:
            raise AssertionError(f"fleet {name}: launches {counts}")
        ref = os.path.join(tmp, f"fleet_ref_{name}.wav")
        master_file(os.path.join(compat_dir if over else indir, name), ref,
                    {**FLEET_QUALITY, **(over or {})}, device="cuda")
        stem = os.path.splitext(name)[0]
        lsb[name] = _lsb(read_wav(os.path.join(outdir,
                                               f"{stem}_mastered.wav"),
                                  prefer_int16=True)[0],
                         read_wav(ref, prefer_int16=True)[0])
    if max(lsb.values()) > 1:
        raise AssertionError(f"fleet vs master_file: {lsb} LSB")
    # the CLI, on a directory without the corrupt file: exit 0
    cli_in = os.path.join(tmp, "fleet_cli_in")
    os.makedirs(cli_in)
    for name in ("a_quality.wav", "b_quality.flac"):
        shutil.copy(os.path.join(indir, name), os.path.join(cli_in, name))
    ((cli_s, cli_js),) = _cli([["fleet", cli_in,
                                os.path.join(tmp, "fleet_cli_out"),
                                *CLI_FLAGSHIP]])
    summary = cli_js[-1]
    if summary.get("done") != 2 or summary.get("failed") != 0:
        raise AssertionError(f"fleet cli: {summary}")
    track_ms = {k: v[0] * 1e3 for k, v in marks.items()}
    print(f"fleet: {s1['done']} done, {s1['failed']} error, then "
          f"{s2['resumed_skips']} skipped; run {run_s:.3f} s; ms a track "
          f"(yield to fsync) " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in track_ms.items())
          + f"; decodes {decodes}; vs master_file {lsb} LSB; cli "
          f"{cli_s:.1f} s")
    return {"run_s": run_s, "track_ms": track_ms, "launches": launches,
            "decodes": decodes, "lsb_vs_master_file": lsb,
            "summaries": [s1, s2], "cli_s": cli_s, "cli_summary": summary}


def _batch(src: str, device_chain_ms: float) -> dict:
    """(c) master_batch on [4, 2^23, 2]: the quality track and three noise
    tracks; each output against master_graph on that track (2e-4), K5
    exactly 3 a track; device time beside the single-track chain's."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.parallel.batch import master_batch
    pcm, _ = read_wav(src, prefer_int16=True)
    xs = torch.stack(
        [torch.from_numpy(pcm).cuda().to(torch.float32) * (1.0 / 32768.0)]
        + [_noise_input(N_MAIN, 2, s)[0] for s in BATCH_SEEDS])
    _zero_counts()
    ys = master_batch(xs, SR, FLAGSHIP)
    counts = _read_counts()
    if not _quality_launches_ok(counts, BATCH):
        raise AssertionError(f"master_batch launches {counts}")
    settings = MasterSettings(**FLAGSHIP)
    errs = []
    for b in range(BATCH):
        y, _ = master_graph(xs[b], SR, settings)
        errs.append((ys[b] - y).abs().max().item())
    if not (torch.isfinite(ys).all().item() and max(errs) <= PARITY_TOL):
        raise AssertionError(f"master_batch vs master_graph: {errs}")
    del ys
    batch_ms = _cuda_ms(lambda: master_batch(xs, SR, FLAGSHIP))
    print(f"master_batch [{BATCH}, {N_MAIN}, 2]: K5 {counts['cascade_scan']}"
          f"; vs master_graph {max(errs):.3e}; device {batch_ms:.3f} ms = "
          f"{batch_ms / BATCH:.3f} ms a track (single-track chain "
          f"{device_chain_ms:.3f} ms)")
    return {"counts": counts, "max_abs_err": max(errs), "device_ms": batch_ms,
            "ms_a_track": batch_ms / BATCH,
            "single_track_chain_ms": device_chain_ms}


def _trace_kernels(trace_dir: str) -> list:
    names = []
    for entry in os.scandir(trace_dir):
        with open(entry.path) as f:
            events = json.load(f).get("traceEvents", [])
        names += [e.get("name", "") for e in events
                  if str(e.get("cat", "")).lower() == "kernel"]
    return names


def _profile_cli(tmp: str, src: str, compat_src: str) -> dict:
    """(d) python -m ame_tpu_torch profile in a subprocess, quality and
    compat multiband without LUFS, each with a torch.profiler trace."""
    keys = {"n_samples", "sample_rate", "seconds", "mode", "runs",
            "cold_start_s", "fetch_rtt_ms", "steady_ms", "steady_ms_min",
            "x_realtime", "stages_ms", "stages_note", "host_rss_mb",
            "trace_dir"}
    runs = {"quality": (src, CLI_FLAGSHIP, {"analog_eq_width", "loudnorm",
                                            "limiter"}, "cascade_"),
            "compat": (compat_src, ["--mode", "compat", "--multiband",
                                    "--no-lufs"],
                       {"eq_width", "multiband", "limiter"}, "wedge_")}
    out = {}
    for mode, (path, flags, stages, kernel) in runs.items():
        trace = os.path.join(tmp, f"profile_{mode}")
        ((wall_s, js),) = _cli([["profile", path, "--runs",
                                 str(PROFILE_RUNS), "--trace", trace,
                                 *flags]])
        rep = js[-1]
        names = _trace_kernels(trace)
        hits = sorted({n.split("(")[0] for n in names if kernel in n})
        if (not keys <= set(rep) or set(rep["stages_ms"]) != stages
                or not rep["steady_ms"] > 0 or not rep["x_realtime"] > 0
                or rep["mode"] != mode or not hits):
            raise AssertionError(f"profile {mode}: report {rep}, "
                                 f"{len(names)} kernel events, {kernel}*: "
                                 f"{hits}")
        print(f"profile {mode}: cold_start_s {rep['cold_start_s']}, "
              f"steady_ms {rep['steady_ms']} (host "
              f"{rep['steady_host_ms']}), x_realtime {rep['x_realtime']}, "
              f"stages_ms {rep['stages_ms']}, hbm_peak_mb "
              f"{rep.get('hbm_peak_mb')}; trace {len(names)} kernel events, "
              f"{hits}; the process {wall_s:.1f} s")
        out[mode] = {**{k: rep.get(k) for k in (
            "cold_start_s", "fetch_rtt_ms", "steady_ms", "steady_ms_min",
            "steady_host_ms", "x_realtime", "stages_ms", "hbm_peak_mb")},
            "trace_kernel_events": len(names), "trace_kernels": hits,
            "process_s": wall_s}
    return out


def _evaluation() -> dict:
    """(e) the evaluation corpora (seed 77, 4 a class, 20 s) through the
    spectrogram image and predict_mood with the shipped weights on the
    card: accuracy >= 0.75 for each family."""
    from ame_tpu_torch.analysis import musicologist as M
    from ame_tpu_torch.models import mood_cnn, oof2_corpus, oof_corpus
    model, trained = mood_cnn.load_params(device="cuda")
    if not trained:
        raise AssertionError("the shipped mood weights did not load")
    classes = mood_cnn.MOOD_CLASSES
    out = {}
    for family, synth in (("oof", oof_corpus.synth_track_oof),
                          ("oof2", oof2_corpus.synth_track_oof2)):
        rng = np.random.default_rng(EVAL_SEED)
        conf = np.zeros((4, 4), int)
        t0 = time.perf_counter()
        for ci, cls in enumerate(classes):
            for _ in range(EVAL_PER_CLASS):
                y = synth(cls, rng, seconds=EVAL_SECONDS)
                img = M.spectrogram_image(torch.from_numpy(
                    np.ascontiguousarray(y[:, 0])).cuda())
                conf[ci, classes.index(mood_cnn.predict_mood(model, img))] \
                    += 1
        acc = float(np.trace(conf) / conf.sum())
        print(f"evaluation {family}: accuracy {acc:.4f} "
              f"({time.perf_counter() - t0:.1f} s)\n{conf}")
        if acc < EVAL_FLOOR:
            raise AssertionError(f"{family} accuracy {acc} < {EVAL_FLOOR}")
        out[family] = {"accuracy": acc, "confusion": conf.tolist(),
                       "seconds": time.perf_counter() - t0}
    return out


def _golden() -> dict:
    """(f) the real-FFmpeg harness: available, or why not; where available
    the port's loudnorm_pass1 on the card against the real filter's
    input_i on 12 s of alternating-level program."""
    from ame_tpu_torch.io import avfilter
    from ame_tpu_torch.ops.loudnorm import loudnorm_pass1
    if not avfilter.available():
        reason = avfilter.unavailable_reason()
        print(f"golden FFmpeg harness: unavailable: {reason}")
        return {"available": False, "reason": reason}
    rng = np.random.default_rng(3)
    t = np.arange(SR * 12) / SR
    env = np.where((t % 6) < 3, 0.08, 0.5)
    x = env * np.sin(2 * np.pi * 220 * t) + 0.12 * env * rng.standard_normal(
        t.size)
    x = np.clip(np.stack([x, 0.85 * x], 1), -1, 1).astype(np.float32)
    ff = avfilter.loudnorm_pass1(x, SR)
    ours = loudnorm_pass1(torch.from_numpy(x).cuda(), SR)["input_i"].item()
    err = abs(ours - ff["input_i"])
    print(f"golden FFmpeg harness: input_i port {ours:.3f} vs ffmpeg "
          f"{ff['input_i']:.3f} ({err:.3f} LU)")
    if err > GOLDEN_TOL_LU:
        raise AssertionError(f"loudnorm_pass1 vs ffmpeg: {err} LU")
    return {"available": True, "input_i": ours, "ffmpeg_input_i":
            ff["input_i"], "err_lu": err}


def phase_surfaces(tmp: str, device_chain_ms: float) -> dict:
    """Phase 16: (a) the GUI controller, (b) fleet, (c) master_batch, (d)
    profile, (e) the evaluation corpora, (f) the golden-FFmpeg harness,
    (g) device_memory_stats lists only the card in use."""
    from ame_tpu_torch.utils import telemetry
    src = os.path.join(tmp, "in.wav")                  # phase 4's
    compat_src = os.path.join(tmp, "compat_in.wav")    # phase 8's
    out = {}
    for key, fn in (("gui", lambda: _gui(tmp, src)),
                    ("fleet", lambda: _fleet(tmp, src, compat_src)),
                    ("batch", lambda: _batch(src, device_chain_ms)),
                    ("profile", lambda: _profile_cli(tmp, src, compat_src)),
                    ("evaluation", _evaluation), ("golden", _golden)):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
    cards = [s["device"] for s in telemetry.device_memory_stats()]
    if cards != ["cuda:0"]:
        raise AssertionError(f"device_memory_stats lists {cards}")
    out["device_memory_stats"] = cards
    print(f"surfaces: device_memory_stats lists {cards}")
    return out


# ---------------------------------------------------------------------------
# Phase 17: time-sharded mastering (parallel/sp_master.py, sp_compat.py,
# bands.py, batch.py's mesh route, api.shard_time)
# ---------------------------------------------------------------------------

N_SP = 475 * 4 * 4410          # 8 379 000: a D = 4 shard holds whole hops
SP_MESHES = (1, 4)             # shards, all on cuda:0
SP_QUALITY = dict(bass_boost=2.0, presence_boost=1.5, width=1.2,
                  analog_character=20.0, multiband=True, lufs=-14.0,
                  mode="quality")               # bench.py:341-344
SP_COMPAT = dict(bass_boost=2.0, width=1.2, multiband=True, lufs=-14.0,
                 mode="compat")                 # bench.py:345-347
SP_PATHS = {"sp_quality": SP_QUALITY, "sp_compat": SP_COMPAT,
            "sp_compat_chunked": COMPAT_CHUNKED}
# tests/test_parallel.py's tolerances (:161-165, :365-369): the info keys
# held, their tolerance, atol, rtol
SP_TOL = {"quality": (("input_i", "input_lra", "input_tp", "gain_db"), 2e-2,
                      3e-4, 2e-3),
          "compat": (("input_i", "input_thresh", "gain_db", "target_offset"),
                     5e-2, 2e-3, 5e-3)}
SP_FILE_TOL = 2e-3             # tests/test_parallel.py:455-458
BAND_EDGES = (250.0, 4000.0)   # 3 bands, one a device
BAND_TOL = (3e-5, 1e-4)        # tests/test_parallel.py:253


def _sp_inputs():
    """The quality input (tests/test_parallel.py:151-155 at N_SP: 0.15
    N(0,1) noise, a 220 Hz tone on the left, a 3x loud second across the
    first D = 4 shard boundary, clipped at 0.9) and the compat main path's
    input at N_SP, both on the int16 grid, on the card."""
    rng = np.random.default_rng(3)
    t = np.arange(N_SP) / SR
    x = 0.15 * rng.standard_normal((N_SP, 2))
    x[:, 0] += 0.1 * np.sin(2 * np.pi * 220.0 * t)
    b = N_SP // 4
    x[b - SR // 2: b + SR // 2] *= 3.0
    out = []
    for a in (np.clip(x, -0.9, 0.9), _compat_input(N_SP)):
        out.append(torch.from_numpy(
            (np.trunc(np.clip(a, -1, 1) * 32767.0) / 32768.0).astype(
                np.float32)).cuda())
    return out


def _sp_predicted(path: str, D: int) -> dict:
    """The launches of one sharded master (PERF.md, PR 12's prediction):
    a sequence-parallel cascade makes 2D - 1 K5 launches (D zero-state, D -
    1 zero-input responses), a chunk-local one D. Exact counts; K2 (1 .. D
    relaxation sweeps of one engine call each) is held to a range."""
    sp = 2 * D - 1
    if path == "sp_quality":    # pre k=6, 3 bands, smoother, K-weighting
        return {"cascade_scan": 6 * sp, "wedge_env": 0, "gain_jacobi": 0,
                "gain_p1": 0, "gain_p2": 0}
    if path == "sp_compat":     # bass shelf, 2 crossovers, 2 K-weightings
        return {"cascade_scan": 5 * sp, "wedge_env": 2 if D == 1 else 0,
                "gain_p1": 0, "gain_jacobi": (1, D * 17), "gain_p2": 0}
    # chunked: 6 chunk-local cascades a shard, 2 sp K-weightings
    return {"cascade_scan": 6 * D + 2 * sp, "wedge_env": 2 if D == 1 else 0,
            "gain_p1": 0, "gain_jacobi": (D, D * 17), "gain_p2": 0}


def _hold_counts(label: str, counts: dict, want: dict) -> None:
    for k, v in want.items():
        lo, hi = v if isinstance(v, tuple) else (v, v)
        if not lo <= counts[k] <= hi:
            raise AssertionError(f"{label}: {k} launched {counts[k]} times, "
                                 f"predicted {v} ({counts})")
    if counts.get("sos_grad") or counts.get("cascade_scan_reverse"):
        raise AssertionError(f"{label}: backward kernels launched {counts}")


def _sp_paths(xq: torch.Tensor, xc: torch.Tensor) -> dict:
    """Each sharded master (quality, compat, chunked compat through the
    padded wrapper) at D = 1 and 4 against master_graph on the same input:
    info, linear_mode, output within tests/test_parallel.py's tolerances;
    launches held to the prediction; device times beside master_graph's."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.parallel.mesh import make_mesh
    from ame_tpu_torch.parallel.sp_master import (
        master_sequence_parallel_padded)
    out = {}
    for path, sdict in SP_PATHS.items():
        s = MasterSettings(**sdict)
        x = xq if s.mode == "quality" else xc
        keys, info_tol, atol, rtol = SP_TOL[s.mode]
        y1, i1 = master_graph(x, SR, s)
        single_ms = _cuda_ms(lambda: master_graph(x, SR, s))
        row = {"master_graph_ms": single_ms}
        for D in SP_MESHES:
            mesh = make_mesh({"sp": D}, devices=["cuda:0"] * D)

            def run():
                return master_sequence_parallel_padded(x, SR, s, mesh)
            _zero_counts()
            y, info = run()
            counts = _read_counts()
            label = f"{path} D={D}"
            _hold_counts(label, counts, _sp_predicted(path, D))
            err = (y - y1).abs()
            bad = (err > atol + rtol * y1.abs()).sum().item()
            dinfo = {k: abs(float(info[k]) - float(i1[k])) for k in info}
            if (y.shape != x.shape or not torch.isfinite(y).all().item()
                    or bad or max(dinfo[k] for k in keys) > info_tol
                    or float(info["linear_mode"]) != float(
                        i1["linear_mode"])):
                raise AssertionError(
                    f"{label} vs master_graph: {bad} samples over atol "
                    f"{atol} / rtol {rtol} (max {err.max().item():.3e}); "
                    f"info diffs {dinfo}; linear_mode "
                    f"{float(info['linear_mode'])} vs "
                    f"{float(i1['linear_mode'])}")
            del y
            ms = _cuda_ms(run)
            row[f"D{D}"] = {"counts": counts,
                            "max_abs_err": err.max().item(),
                            "max_info_diff": max(dinfo.values()),
                            "linear_mode": float(info["linear_mode"]),
                            "device_ms": ms}
            print(f"sharded {label}: launches "
                  + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
                  + f"; vs master_graph max {err.max().item():.3e}, info "
                  f"{max(dinfo.values()):.3e}; {ms:.3f} ms (master_graph "
                  f"{single_ms:.3f} ms)")
        out[path] = row
    return out


def _sp_gain(xc: torch.Tensor) -> dict:
    """The gain relaxation at D = 4 on the compat band detector's [3, N]
    output, bit-equal to the one-track engine; then K3 and K2 from a
    non-zero init at a shard's shape: the second shard's chains from the
    first shard's end state, K3's starts and K2's full sweep from the
    relaxed carries each against the plain Jacobi sweep from those carries
    (bit for bit), and pydub_gain_ends against that sweep's last state."""
    from ame_tpu_torch.ops import pydub_gain as pg
    from ame_tpu_torch.parallel.sp_compat import _pydub_gain_sp
    ia, ir = pg._scal(ATTACK, RELEASE)
    m = _band_max_att(xc)                                    # [3, N]
    G, n = m.shape
    one = torch.stack(pg.pydub_gain_multi(list(m), ATTACK, RELEASE))
    sp = torch.cat(_pydub_gain_sp(list(m.T.chunk(4)), ATTACK, RELEASE)).T
    if not torch.equal(sp, one):
        raise AssertionError(f"_pydub_gain_sp D=4 vs the one-track engine: "
                             f"max diff {(sp - one).abs().max().item()}")
    del sp, one
    ln = n // 4
    init = pg.pydub_gain_ends(list(m[:, :ln]), ATTACK, RELEASE)
    if not init.any().item():
        init = torch.tensor([0.0, 1.5, 7.0], device="cuda")
    init = init.contiguous()
    ms = m[:, ln:2 * ln].contiguous()
    npad = pg._pad_block(ln)
    S = pg._select_S(npad)
    seg_len = npad // S
    m_t = torch.nn.functional.pad(ms, (0, npad - ln)).reshape(
        G, S, seg_len).permute(2, 0, 1).reshape(seg_len, G * S).contiguous()
    c_fix, ok, sweeps = pg._jacobi_carries(m_t, G, S, init, ia, ir)
    sweeps = int(sweeps)
    if not ok.all().item():
        raise AssertionError(f"the second shard's chains from init "
                             f"{init.tolist()}: carries converged "
                             f"{ok.tolist()} after {sweeps} sweeps")
    c = c_fix.reshape(-1).contiguous()
    co_k, att_k = pg.gain_jacobi_cuda(m_t, c, ia, ir, True)
    co_p, att_p = pg.gain_jacobi_plain(m_t, c, ia, ir, True)
    if not (torch.equal(co_k, co_p) and torch.equal(att_k, att_p)):
        raise AssertionError(f"gain_jacobi from init {init.tolist()} vs "
                             f"plain at [{seg_len}, {G * S}]: max diff "
                             f"{(att_k - att_p).abs().max().item()}")
    att = att_p.reshape(seg_len, G, S).permute(1, 2, 0).reshape(G, npad)
    ref_starts = torch.cat([init[:, None], att[:, pg._K - 1:ln - 1:pg._K]],
                           dim=1)
    starts = pg.gain_p1_cuda(ms, None, init, ia, ir)
    if not torch.equal(starts, ref_starts):
        raise AssertionError(f"gain_p1 from init {init.tolist()} vs the "
                             f"plain sweep's states at [{G}, {ln}]: max diff "
                             f"{(starts - ref_starts).abs().max().item()}")
    ends = pg.pydub_gain_ends(list(ms), ATTACK, RELEASE, init)
    if not torch.equal(ends, att[:, ln - 1]):
        raise AssertionError(f"pydub_gain_ends vs the plain sweep: "
                             f"{ends.tolist()} vs {att[:, ln - 1].tolist()}")
    p1_ms = _cuda_ms(lambda: pg.gain_p1_cuda(ms, None, init, ia, ir))
    k2_ms = _cuda_ms(lambda: pg.gain_jacobi_cuda(m_t, c, ia, ir, True),
                     KERNEL_CALLS)
    b = _gain_bounds(G, ln)
    print(f"sharded gain: _pydub_gain_sp D=4 == one-track engine bit for "
          f"bit [3, {n}]; from init {[round(v, 4) for v in init.tolist()]} "
          f"at [3, {ln}]: gain_jacobi ({sweeps} sweeps, converged "
          f"{ok.tolist()}) and gain_p1 == the plain sweep bit for bit, "
          f"pydub_gain_ends == its end; gain_p1 {p1_ms:.4f} ms, gain_jacobi "
          f"full {k2_ms:.4f} ms")
    return {"init": init.tolist(), "shape": [G, ln],
            "gain_p1": {"max_abs_err": 0.0, "ms": p1_ms,
                        "bound_ms": b["gain_p1"][0]},
            "gain_jacobi": {"max_abs_err": 0.0, "ms": k2_ms,
                            "sweeps": sweeps, "shape": [seg_len, G * S],
                            "bound_ms": b["gain_jacobi"][0]}}


def _sp_zir_rows(xq: torch.Tensor) -> list:
    """K5 with a carried zi on zeros (the zero-input response every shard
    after the first adds), at a D = 4 shard's shape, against its plain
    version: the quality pre cascade (k = 6, C = 2) and the attack smoother
    (k = 1, C = 3)."""
    from ame_tpu_torch import config as C
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.ops.compressor import attack_sos
    from ame_tpu_torch.parallel.sp_master import _pre_cascade_sos
    ln = N_SP // 4
    rows = []
    for name, sos, cols in (
            ("zir_pre_cascade", _pre_cascade_sos(
                MasterSettings(**SP_QUALITY), SR), 2),
            ("zir_attack_smoother", attack_sos(SR, C.MB_ATTACK_MS), 3)):
        pre = (xq[:4096] if cols == 2
               else xq[:4096, :1].abs().repeat(1, cols).contiguous())
        rows.append(_cascade_row(name, sos, torch.zeros(
            (ln, cols), device="cuda"), pre.contiguous()))
    return rows


def _sp_batch_and_bands(xq: torch.Tensor) -> dict:
    """master_batch over a 2-device 'data' mesh (cuda:0 twice) bit-equal to
    mesh=None; multiband_band_parallel at 3 bands (cuda:0 three times)
    against multiband_quality_n."""
    from ame_tpu_torch.graph.multiband import multiband_quality_n
    from ame_tpu_torch.parallel.bands import multiband_band_parallel
    from ame_tpu_torch.parallel.batch import master_batch
    from ame_tpu_torch.parallel.mesh import make_mesh
    xs = torch.stack([xq, _noise_input(N_SP, 2, 4)[0]])
    a = master_batch(xs, SR, FLAGSHIP, mesh=make_mesh(
        {"data": 2}, devices=["cuda:0"] * 2))
    b = master_batch(xs, SR, FLAGSHIP)
    if not torch.equal(a, b):
        raise AssertionError(f"master_batch(mesh) vs mesh=None: max diff "
                             f"{(a - b).abs().max().item()}")
    del a, b, xs
    th, ra = [-24.0, -20.0, -18.0], [2.0, 3.0, 4.0]
    mesh = make_mesh({"band": 3}, devices=["cuda:0"] * 3)
    _zero_counts()
    y_bp = multiband_band_parallel(xq, SR, BAND_EDGES, th, ra, mesh)
    counts = _read_counts()
    y_1 = multiband_quality_n(xq, SR, BAND_EDGES, th, ra)
    err = (y_bp - y_1).abs()
    if (err > BAND_TOL[0] + BAND_TOL[1] * y_1.abs()).any().item():
        raise AssertionError(f"multiband_band_parallel vs "
                             f"multiband_quality_n: max {err.max().item()}")
    bp_ms = _cuda_ms(lambda: multiband_band_parallel(xq, SR, BAND_EDGES, th,
                                                     ra, mesh))
    one_ms = _cuda_ms(lambda: multiband_quality_n(xq, SR, BAND_EDGES, th,
                                                  ra))
    print(f"sharded: master_batch over a 2-device mesh == mesh=None bit for "
          f"bit [2, {N_SP}, 2]; band-parallel 3 bands vs multiband_quality_n "
          f"max {err.max().item():.3e}, K5 {counts['cascade_scan']}, "
          f"{bp_ms:.3f} ms (one device {one_ms:.3f} ms)")
    return {"master_batch_mesh_equal": True,
            "bands": {"counts": counts, "max_abs_err": err.max().item(),
                      "device_ms": bp_ms, "one_device_ms": one_ms}}


def _sp_file(tmp: str, xq: torch.Tensor) -> dict:
    """master_file(shard_time=True) on cuda:0 (the pool: this card, D = 1)
    against the unsharded master_file of the same WAV: no degrade warning,
    the time-sharded status, atol 2e-3; its launches."""
    from ame_tpu_torch.api import master_file
    from ame_tpu_torch.io.wav import read_wav, write_wav
    src = os.path.join(tmp, "sp_in.wav")
    write_wav(src, xq.cpu().numpy(), SR)
    outs, msgs = {}, []
    counts = None
    for sharded in (True, False):
        dst = os.path.join(tmp, f"sp_out_{sharded}.wav")
        _zero_counts()
        master_file(src, dst, FLAGSHIP, msgs.append if sharded else
                    (lambda m: None), device="cuda", shard_time=sharded)
        if sharded:
            counts = _read_counts()
        outs[sharded] = read_wav(dst)[0]
    bad = [m for m in msgs if "unavailable" in m or m.startswith(
        ("Warning", "Error", "Failed"))]
    if bad or not any("time-sharded mastering graph over 1 devices" in m
                      for m in msgs):
        raise AssertionError(f"master_file(shard_time=True): {msgs}")
    # the flagship at D = 1: the fused pre cascade and the K-weighting
    _hold_counts("shard_time master_file", counts,
                 {**_sp_predicted("sp_quality", 1), "cascade_scan": 2})
    err = float(np.abs(outs[True] - outs[False]).max())
    if err > SP_FILE_TOL:
        raise AssertionError(f"master_file shard_time vs one device: {err}")
    print(f"sharded: master_file(shard_time=True) on cuda:0: no warning, "
          f"K5 {counts['cascade_scan']}, vs unsharded max {err:.3e}")
    return {"counts": counts, "max_abs_err": err,
            "statuses": [m for m in msgs if "device" in m]}


def phase_sharded(tmp: str) -> dict:
    """Phase 17 (see the module docstring)."""
    xq, xc = _sp_inputs()
    out = {"n": N_SP, "paths": _sp_paths(xq, xc)}
    out["gain"] = _sp_gain(xc)
    out["zir"] = _sp_zir_rows(xq)
    out.update(_sp_batch_and_bands(xq))
    out["shard_time_file"] = _sp_file(tmp, xq)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the sharded training step (parallel/mesh.init_distributed,
# parallel/train.py) and the channel-stacked batch (parallel/stacked.py)
# ---------------------------------------------------------------------------
SHARDED_STEPS = 10
SHARDED_TOL = 1e-5             # the sharded step vs the one-device step
STACKED_TOL = (5e-5, 1e-4)     # tests/test_parallel.py:136-137 (atol, rtol)
# K5 launches of one master_batch_stacked with QUALITY_MB, whatever B:
# analog shelves, EQ, the 3 band cascades, the attack smoother (at C = 3B)
# and the K-weighting, each once over the [N, 2B] stack (the prediction
# in PERF.md's findings)
STACKED_K5 = 7


def _train_sharded(tmp: str) -> dict:
    """(a) make_sharded_train_step over {"data": 1, "model": 1} on cuda:0
    after init_distributed with a file:// store and the nccl backend (the
    gradient and loss all-reduces run over a one-rank NCCL group), at batch
    32 on the full mood CNN, 10 steps with dropout on from one generator,
    beside mood_cnn.make_train_step from the same seed and generator seed:
    the parameters within 1e-5, the loss falls, no kernel of the port
    launched; a step's device time beside the one-device step's. NCCL
    refuses two ranks on one card, so the multi-rank layouts are held by
    the CPU tests over gloo (tests/test_torch_dist_train.py)."""
    import torch.distributed as dist
    from ame_tpu_torch.models import mood_cnn
    from ame_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from ame_tpu_torch.parallel.train import make_sharded_train_step
    world = init_distributed(f"file://{os.path.join(tmp, 'dist_store')}",
                             1, 0, device="cuda", timeout=300.0)
    try:
        backend = dist.get_backend()
        if world != 1 or backend != "nccl":
            raise AssertionError(f"init_distributed: world {world}, "
                                 f"backend {backend}")
        init_fn, step_fn, place_batch = make_sharded_train_step(
            make_mesh({"data": 1, "model": 1}, devices=["cuda:0"]),
            TRAIN_LR)
        params, opt = init_fn(0)
        model = mood_cnn.init_params(0, device="cuda")
        step = mood_cnn.make_train_step(torch.optim.Adam(model.parameters(),
                                                         lr=TRAIN_LR))
        # a class a brightness band: a batch the CNN can learn in a few
        # steps, so the loss falls through the dropout's noise
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 4, TRAIN_BATCH)
        images = (0.25 * rng.random((TRAIN_BATCH, 128, 128, 3))
                  + 0.25 * labels[:, None, None, None]).astype(np.float32)
        x, y = place_batch(images, labels)
        if x.device != torch.device("cuda:0"):
            raise AssertionError(f"place_batch put the batch on {x.device}")
        gens = [torch.Generator(device="cuda").manual_seed(0)
                for _ in range(2)]
        # cuDNN's default weight-gradient algorithms sum with atomics, so
        # two runs of one step differ in float32's last bits, which max
        # pooling's routing and Adam's sqrt(v) amplify (noise, reported
        # below): the comparison runs its deterministic algorithms
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True):
            _zero_counts()
            losses = [float(step_fn(params, opt, x, y, gens[0])[2])
                      for _ in range(SHARDED_STEPS)]
            counts = _read_counts()
            for _ in range(SHARDED_STEPS):
                step(model, x, y, gens[1])
        err = max((a - b).abs().max().item() for a, b in
                  zip(params.parameters(), model.parameters()))
        noise = _one_device_noise(x, y)
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0] and err <= SHARDED_TOL):
            raise AssertionError(f"sharded step: losses {losses}, vs the "
                                 f"one-device step {err:.3e}")
        if any(counts.values()):
            raise AssertionError(f"sharded step launched kernels {counts}")
        step_ms = _cuda_ms(lambda: step_fn(params, opt, x, y, gens[0]))
        one_ms = _cuda_ms(lambda: step(model, x, y, gens[1]))
    finally:
        dist.destroy_process_group()
    print(f"train_sharded: world 1 over {backend}, batch {TRAIN_BATCH}, "
          f"{SHARDED_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"vs the one-device step {err:.3e} (the one-device step against "
          f"itself with cuDNN's default algorithms {noise:.3e}); a step "
          f"{step_ms:.3f} ms (one-device step {one_ms:.3f} ms)")
    return {"world": world, "backend": backend, "batch": TRAIN_BATCH,
            "steps": SHARDED_STEPS, "losses": losses,
            "max_abs_err_vs_one_device": err,
            "one_device_run_to_run": noise, "step_ms": step_ms,
            "one_device_step_ms": one_ms, "counts": counts}


def _one_device_noise(x: torch.Tensor, y: torch.Tensor) -> float:
    """The largest parameter difference between two runs of
    SHARDED_STEPS one-device steps from the same seeds, with cuDNN's
    default algorithms."""
    from ame_tpu_torch.models import mood_cnn
    runs = []
    for _ in range(2):
        model = mood_cnn.init_params(0, device="cuda")
        step = mood_cnn.make_train_step(torch.optim.Adam(model.parameters(),
                                                         lr=TRAIN_LR))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for _ in range(SHARDED_STEPS):
            step(model, x, y, gen)
        runs.append(list(model.parameters()))
    return max((a - b).abs().max().item() for a, b in zip(*runs))


def _stacked_cascades(B: int) -> dict:
    """The K5 inputs of master_batch_stacked with QUALITY_MB on B tracks:
    {name: (sos, C)}; the quality path's three cascades and the 3-band
    split's bands on the [N, 2B] stack, the attack smoother on [N, 3B]."""
    from ame_tpu_torch import config as C
    from ame_tpu_torch.graph import multiband as mb
    from ame_tpu_torch.ops.compressor import attack_sos
    out = {name: (sos, 2 * B) for name, sos in _quality_cascades().items()}
    out.update({f"band{b}": (sos, 2 * B)
                for b, sos in enumerate(mb._band_cascades_3(SR))})
    out["attack_smoother"] = (attack_sos(SR, C.MB_ATTACK_MS), 3 * B)
    return out


def _stacked(src: str) -> dict:
    """(b) master_batch_stacked on [4, 2^23, 2] (phase 16's input: the
    quality track and three noise tracks) with QUALITY_MB: K5 exactly
    STACKED_K5 times and nothing else, each track within atol 5e-5, rtol
    1e-4 of master_graph on it; device times beside master_batch on the
    same input (QUALITY_MB and FLAGSHIP); K5 at the stack's shapes against
    its plain version with its bound."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph.chain import master_graph
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.parallel.batch import master_batch
    from ame_tpu_torch.parallel.stacked import master_batch_stacked
    pcm, _ = read_wav(src, prefer_int16=True)
    xs = torch.stack(
        [torch.from_numpy(pcm).cuda().to(torch.float32) * (1.0 / 32768.0)]
        + [_noise_input(N_MAIN, 2, s)[0] for s in BATCH_SEEDS])
    _zero_counts()
    ys = master_batch_stacked(xs, SR, QUALITY_MB)
    counts = _read_counts()
    _hold_counts("master_batch_stacked", counts,
                 {"cascade_scan": STACKED_K5, "wedge_env": 0,
                  "gain_jacobi": 0, "gain_p1": 0, "gain_p2": 0})
    if tuple(ys.shape) != tuple(xs.shape):
        raise AssertionError(f"master_batch_stacked shape {ys.shape}")
    settings = MasterSettings(**QUALITY_MB)
    errs, over = [], []
    for b in range(BATCH):
        y, _ = master_graph(xs[b], SR, settings)
        d = (ys[b] - y).abs()
        errs.append(d.max().item())
        over.append((d - STACKED_TOL[1] * y.abs()).max().item())
    if not (torch.isfinite(ys).all().item()
            and max(over) <= STACKED_TOL[0]):
        raise AssertionError(f"master_batch_stacked vs master_graph: max "
                             f"{errs}, over rtol {over}")
    del ys
    times = {f"{fn.__name__}_{label}": _cuda_ms(
        lambda: fn(xs, SR, settings_dict))
        for label, settings_dict in (("quality_mb", QUALITY_MB),
                                     ("flagship", FLAGSHIP))
        for fn in (master_batch_stacked, master_batch)}
    del xs
    rows, inputs = [], {}
    for name, (sos, cols) in _stacked_cascades(BATCH).items():
        if cols not in inputs:
            inputs[cols] = _noise_input(N_MAIN, cols, 7)
        rows.append(_cascade_row(f"stacked_{name}", sos, *inputs[cols]))
    print(f"stacked [{BATCH}, {N_MAIN}, 2] quality_mb: K5 "
          f"{counts['cascade_scan']}; vs master_graph max {max(errs):.3e}; "
          "device ms " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return {"counts": counts, "max_abs_err": max(errs),
            "per_track_max_abs_err": errs, "device_ms": times,
            "ms_a_track": {k: v / BATCH for k, v in times.items()},
            "k5": rows}


def phase_train_sharded_stacked(tmp: str) -> dict:
    """Phase 18 (see the module docstring)."""
    out = {}
    for key, fn in (("train_sharded", lambda: _train_sharded(tmp)),
                    ("stacked", lambda: _stacked(os.path.join(tmp,
                                                              "in.wav")))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[key]["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 19: the fused chain (graph/chain.master_graph_fused)
# ---------------------------------------------------------------------------

FUSED_REPLAYS = 3
FUSED_KERNELS = ("cascade_", "wedge_", "gain_", "graph_if")   # the port's
FALLBACK_INPUTS = ("compat_fallback", "compat_chunked_fallback")


def _dynamic_compat_input(n: int) -> np.ndarray:
    """Quiet 0.01 N(0,1) noise (seed 3) with a full-scale click every
    second: the linear gain would break the true-peak target, so loudnorm
    goes dynamic."""
    x = 0.01 * np.random.default_rng(3).standard_normal((n, 2))
    x[::SR] = 0.9
    return x.astype(np.float32)


def _fused_inputs(tmp: str) -> list:
    """(name, settings, x on the card) of phase 19: phase 4's quality track
    (plain, 3 and 16 bands), phase 8's compat input and steady noise (plain
    and chunked: the converging engine and its fallback), the dynamic-
    loudnorm input and a silent track, as master_array stages them."""
    from ame_tpu_torch.io.wav import read_wav
    from ame_tpu_torch.ops.quantize import int16_roundtrip
    pcm, _ = read_wav(os.path.join(tmp, "in.wav"), prefer_int16=True)
    xq = torch.from_numpy(pcm).cuda().to(torch.float32) * (1.0 / 32768.0)
    xc = _compat_x(tmp)[2]
    xs = _steady_x(tmp)[1]
    xd = int16_roundtrip(torch.from_numpy(
        _dynamic_compat_input(N_MAIN)).cuda())
    xz = torch.zeros((N_MAIN, 2), device="cuda")
    return [("quality", FLAGSHIP, xq), ("compat", COMPAT, xc),
            ("compat_fallback", COMPAT, xs),
            ("compat_chunked", COMPAT_CHUNKED, xc),
            ("compat_chunked_fallback", COMPAT_CHUNKED, xs),
            ("quality_mb", QUALITY_MB, xq),
            ("quality_mb16", QUALITY_MB16, xq),
            ("compat_dynamic", COMPAT, xd), ("compat_silent", COMPAT, xz)]


def _fused_err(settings: dict, got, want) -> float:
    """Max abs difference of a fused master from master_graph's, held to
    the parity limits (PERF.md section 2): quality 2e-4 abs and the gain
    within 0.01 dB; compat relative L2 < 3e-3 or max abs <= 2/32768; the
    same linear_mode."""
    (y, info), (y0, i0) = got, want
    max_abs = (y - y0).abs().max().item()
    if settings.get("mode") == "compat":
        rel = ((y - y0).norm() / (y0.norm() + 1e-12)).item()
        ok = rel < 3e-3 or max_abs <= 2.0 / 32768.0
    else:
        ok = max_abs <= PARITY_TOL
    g, g0 = float(info["gain_db"]), float(i0["gain_db"])
    ok = (ok and (g == g0 or abs(g - g0) <= GAIN_TOL_DB)
          and float(info["linear_mode"]) == float(i0["linear_mode"]))
    if not ok:
        raise AssertionError(f"fused vs master_graph: max abs {max_abs}, "
                             f"gain {g} vs {g0}, linear_mode "
                             f"{float(info['linear_mode'])} vs "
                             f"{float(i0['linear_mode'])}")
    return max_abs


def _pool_bytes(entry) -> int:
    """Device bytes held by a captured chain's two memory pools (the
    graph's and its conditional bodies')."""
    ids = {tuple(entry.graph.pool()), tuple(entry.pool)}
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) in ids)


def _fused_one(name: str, settings: dict, x: torch.Tensor) -> dict:
    """One input: master_graph (staged, counted), then master_graph_fused
    from an empty cache (warm-up and capture: its seconds, its pools'
    bytes, the launches counted at capture), FUSED_REPLAYS replays under
    sync debug mode "error" held to the staged master, and the times of
    both (CUDA events; host us a call)."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    s = MasterSettings(**settings)
    chain._fused.clear()
    _zero_counts()
    want = chain.master_graph(x, SR, s)
    staged = _read_counts()
    _zero_counts()
    t0 = time.perf_counter()
    first = chain.master_graph_fused(x, SR, s)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    at_capture = _read_counts()
    (entry,) = chain._fused[x.device].values()
    pool = _pool_bytes(entry)
    torch.cuda.set_sync_debug_mode("error")
    try:
        replays = [chain.master_graph_fused(x, SR, s)
                   for _ in range(FUSED_REPLAYS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    err = max(_fused_err(settings, r, want) for r in [first] + replays)
    if name == "quality" and staged["cascade_scan"] != 3 or name in (
            "compat", "compat_fallback", "compat_chunked",
            "compat_chunked_fallback") and staged["cascade_scan"] != 7:
        raise AssertionError(f"fused {name}: staged launches {staged}")
    if (staged["gain_p1"] > 0) != (name in FALLBACK_INPUTS):
        raise AssertionError(f"fused {name}: K3 {staged['gain_p1']} times "
                             f"in the staged run")
    row = {"capture_s": capture_s, "pool_bytes": pool, "max_abs_err": err,
           "linear_mode": float(want[1].get("linear_mode", 1.0)),
           "staged_launches": {k: v for k, v in staged.items() if v},
           "launches_at_capture": {k: v for k, v in at_capture.items()
                                   if v},
           "replay_ms": _cuda_ms(lambda: chain.master_graph_fused(x, SR, s)),
           "staged_ms": _cuda_ms(lambda: chain.master_graph(x, SR, s)),
           "replay_host_us": _host_us(
               lambda: chain.master_graph_fused(x, SR, s)),
           "staged_host_us": _host_us(lambda: chain.master_graph(x, SR, s))}
    print(f"fused {name}: capture {capture_s:.3f} s, pools "
          f"{pool / 2 ** 20:.1f} MiB; replay vs master_graph max abs "
          f"{err:.3e} ({1 + FUSED_REPLAYS} calls, the replays under sync "
          f"debug mode error); replay {row['replay_ms']:.3f} ms vs staged "
          f"{row['staged_ms']:.3f} ms, host {row['replay_host_us']:.1f} vs "
          f"{row['staged_host_us']:.1f} us a call; staged launches "
          + json.dumps(row["staged_launches"]))
    return row


def _fused_cross(inputs: list) -> dict:
    """One graph, the card's decisions: the compat chain captured on the
    compat input replays the steady (fallback), dynamic-loudnorm and
    silent inputs, each held to master_graph on it."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    s = MasterSettings(**COMPAT)
    xs = {n: x for n, st, x in inputs if st is COMPAT}
    chain._fused.clear()
    chain.master_graph_fused(xs["compat"], SR, s)
    out = {}
    for name in ("compat_fallback", "compat_dynamic", "compat_silent",
                 "compat"):
        want = chain.master_graph(xs[name], SR, s)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = chain.master_graph_fused(xs[name], SR, s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out[name] = _fused_err(COMPAT, got, want)
    if len(chain._fused[xs["compat"].device]) != 1:
        raise AssertionError("the compat inputs did not share one graph")
    chain._fused.clear()
    print("fused: one compat graph replays the fallback, dynamic and silent "
          "inputs, max abs vs master_graph " + json.dumps(out))
    return out


FUSED_THREAD_REPLAYS = 20
FUSED_EVICT_KEYS = 6
FUSED_THREAD_S = 300           # a thread check's bound


def _bit_equal(got, want) -> bool:
    """A fused master and its info equal master_graph's bit for bit (NaN
    where NaN)."""
    (y, info), (y0, i0) = got, want
    return (torch.equal(y, y0) and set(info) == set(i0) and all(
        torch.equal(info[k], i0[k])
        or bool(torch.isnan(info[k]).all() and torch.isnan(i0[k]).all())
        for k in i0))


def _in_threads(*fns) -> list:
    """Run each fn on a thread of its own, started together; their
    results, or an AssertionError naming the first that raised or the
    threads still running after FUSED_THREAD_S."""
    barrier = threading.Barrier(len(fns))
    results, errors = [None] * len(fns), []

    def body(i, fn):
        try:
            barrier.wait(timeout=FUSED_THREAD_S)
            results[i] = fn()
        except Exception as e:              # reported below
            errors.append(f"thread {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=body, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(FUSED_THREAD_S)
    errors += [f"thread {i}: still running after {FUSED_THREAD_S} s"
               for i, t in enumerate(threads) if t.is_alive()]
    if errors:
        raise AssertionError("; ".join(errors))
    return results


def _fused_threads(inputs: list) -> dict:
    """Phase 19 (a)-(c): master_graph_fused from several threads at once,
    every output held bit for bit to master_graph on its input."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    xs = {n: x for n, _, x in inputs}
    dev = xs["compat"].device
    order = []                    # (thread, call), in the order they ended

    # (a) two threads, a stream each, one key, two inputs, interleaved
    s = MasterSettings(**COMPAT)
    chain._fused.clear()
    pair = [xs["compat"], xs["compat_dynamic"]]
    wants = [chain.master_graph(x, SR, s) for x in pair]
    chain.master_graph_fused(pair[0], SR, s)          # the capture

    def replayer(i):
        stream = torch.cuda.Stream(dev)
        outs = []
        with torch.cuda.stream(stream):
            for j in range(FUSED_THREAD_REPLAYS):
                outs.append(chain.master_graph_fused(pair[i], SR, s))
                order.append(i)
        stream.synchronize()
        return [_bit_equal(o, wants[i]) for o in outs]

    t0 = time.perf_counter()
    oks = _in_threads(lambda: replayer(0), lambda: replayer(1))
    a_s = time.perf_counter() - t0
    switches = sum(a != b for a, b in zip(order, order[1:]))
    if not all(all(ok) for ok in oks) or len(chain._fused[dev]) != 1:
        raise AssertionError(f"fused (a): bit-equal {oks}, graphs "
                             f"{len(chain._fused[dev])}")
    out = {"a": {"replays": 2 * FUSED_THREAD_REPLAYS, "switches": switches,
                 "wall_s": a_s}}
    del wants

    # (b) captures on one thread, eager masters on another
    chain._fused.clear()
    eager = [(MasterSettings(**FLAGSHIP), xs["quality"]),
             (MasterSettings(**COMPAT), xs["compat"])]
    eager_want = [chain.master_graph(x, SR, st) for st, x in eager]
    caps = [(MasterSettings(**COMPAT_CHUNKED), xs["compat_chunked"]),
            (MasterSettings(**QUALITY_MB), xs["quality_mb"])]
    cap_want = [chain.master_graph(x, SR, st) for st, x in caps]
    torch.cuda.synchronize()
    done = threading.Event()

    def capturer():
        try:
            return [_bit_equal(chain.master_graph_fused(x, SR, st), w)
                    for (st, x), w in zip(caps, cap_want)]
        finally:
            done.set()

    def eager_masters():
        oks = []
        while not done.is_set() or len(oks) < 4:
            i = len(oks) % 2
            st, x = eager[i]
            oks.append(_bit_equal(chain.master_graph(x, SR, st),
                                  eager_want[i]))
        return oks

    cap_ok, eager_ok = _in_threads(capturer, eager_masters)
    if not all(cap_ok) or not all(eager_ok):
        raise AssertionError(f"fused (b): captures {cap_ok}, eager "
                             f"masters {eager_ok}")
    out["b"] = {"captures": len(caps), "eager_masters": len(eager_ok)}
    del eager_want, cap_want

    # (c) more keys than _FUSED_GRAPHS from two threads: evictions while
    # the other thread replays
    chain._fused.clear()
    keys = [MasterSettings(**dict(COMPAT, lufs=-14.0 - k))
            for k in range(FUSED_EVICT_KEYS)]
    x = xs["compat"]
    key_want = [chain.master_graph(x, SR, st) for st in keys]
    captures = []
    fused_cls = chain._Fused

    class Counted(fused_cls):
        def __init__(self, *args):
            super().__init__(*args)
            captures.append(1)

    def cycler(ks):
        return [_bit_equal(chain.master_graph_fused(x, SR, keys[k]),
                           key_want[k]) for k in ks for _ in range(2)]

    ks = list(range(FUSED_EVICT_KEYS))
    chain._Fused = Counted
    try:
        c_ok = _in_threads(lambda: cycler(ks), lambda: cycler(ks[::-1]))
    finally:
        chain._Fused = fused_cls
    kept = len(chain._fused[dev])
    evicted = len(captures) - kept
    if (not all(all(ok) for ok in c_ok) or kept > chain._FUSED_GRAPHS
            or evicted < FUSED_EVICT_KEYS - chain._FUSED_GRAPHS):
        raise AssertionError(f"fused (c): bit-equal {c_ok}, "
                             f"{len(captures)} captures, {kept} kept")
    chain._fused.clear()
    out["c"] = {"keys": FUSED_EVICT_KEYS, "captures": len(captures),
                "evicted": evicted, "calls": sum(len(ok) for ok in c_ok)}
    print("fused threads: (a) " + json.dumps(out["a"]) + "; (b) "
          + json.dumps(out["b"]) + "; (c) " + json.dumps(out["c"])
          + "; every output bit-equal to master_graph")
    return out


def _profile_fused(tmp: str) -> dict:
    """Kernel records per replay and per staged run, busy time and idle
    share, from torch.profiler in a process of its own (one that ran no
    plain gain walk: PERF.md section 7)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--fused-profile", tmp], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"fused profile failed: {r.stderr[-4000:]}")
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


def fused_profile(tmp: str) -> int:
    """``--fused-profile TMP``: for each phase-19 input (read from TMP), one
    staged run and one replay under torch.profiler: the port's kernel
    records by name (the replay's must equal the staged run's, graph_if's
    setter apart), busy ms (every kernel) and the idle share of each
    one's event time; prints one JSON line. No graph is dropped here: once
    a captured graph has been destroyed in a process, torch.profiler
    (torch 2.11, CUDA 12.8) has been seen to name and count the kernels of
    later graphs' replays wrongly, while their outputs stay exact. Inputs
    of one settings key replay one graph."""
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    inputs = _fused_inputs(tmp)
    chain._FUSED_GRAPHS = len(inputs)
    out = {}
    for name, settings, x in inputs:
        s = MasterSettings(**settings)
        row = {}
        for how, fn in (("staged", lambda: chain.master_graph(x, SR, s)),
                        ("replay",
                         lambda: chain.master_graph_fused(x, SR, s))):
            ms = _cuda_ms(fn)
            per_kernel = _profile(fn, 1)
            busy = sum(t for t, _ in per_kernel.values())
            row[how] = {"ms": ms, "busy_ms": busy,
                        "idle_share": 1.0 - busy / ms,
                        "records": {k: n for k, (_, n) in per_kernel.items()
                                    if k.startswith(FUSED_KERNELS)}}
        st, rp = row["staged"]["records"], row["replay"]["records"]
        ifs = rp.pop("graph_if_set", 0)
        if rp != st or not st:
            raise AssertionError(f"fused {name}: kernel records a replay "
                                 f"{rp} != a staged run {st}")
        row["if_nodes_run"] = ifs
        out[name] = row
        print(f"fused {name}: replay busy {row['replay']['busy_ms']:.3f} of "
              f"{row['replay']['ms']:.3f} ms (idle share "
              f"{row['replay']['idle_share']:.3f}) vs staged busy "
              f"{row['staged']['busy_ms']:.3f} of {row['staged']['ms']:.3f} "
              f"ms ({row['staged']['idle_share']:.3f}); the port's kernel "
              f"records equal, {sum(st.values())} a run; {ifs} IF setters")
    print(json.dumps(out))
    return 0


def phase_fused(tmp: str) -> dict:
    """Phase 19 (see the module docstring)."""
    inputs = _fused_inputs(tmp)
    rows = {name: _fused_one(name, settings, x)
            for name, settings, x in inputs}
    cross = _fused_cross(inputs)
    threads = _fused_threads(inputs)
    del inputs
    torch.cuda.empty_cache()
    prof = _profile_fused(tmp)
    for name, row in rows.items():
        row["profile"] = prof[name]
    return {"inputs": rows, "one_graph_compat": cross, "threads": threads}


def sharded_times(root: str) -> int:
    """``--sharded-times [ROOT]``: each sharded master of phase 17 (the
    paths of SP_PATHS at the meshes of SP_MESHES, on phase 17's inputs)
    with the ame_tpu_torch package found under ROOT: its launches and its
    device ms (``_cuda_ms``) twice. Checks nothing; prints one
    {"sharded_times": ...} line."""
    sys.path.insert(0, os.path.abspath(root))
    import ame_tpu_torch
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.parallel.mesh import make_mesh
    from ame_tpu_torch.parallel.sp_master import (
        master_sequence_parallel_padded)
    phase_device()
    xq, xc = _sp_inputs()
    out = {"package": os.path.dirname(ame_tpu_torch.__file__)}
    for path, sdict in SP_PATHS.items():
        s = MasterSettings(**sdict)
        x = xq if s.mode == "quality" else xc
        for D in SP_MESHES:
            mesh = make_mesh({"sp": D}, devices=["cuda:0"] * D)

            def run():
                return master_sequence_parallel_padded(x, SR, s, mesh)
            _zero_counts()
            run()
            counts = {k: v for k, v in _read_counts().items() if v}
            out[f"{path}_d{D}"] = {"counts": counts,
                                   "device_ms": [_cuda_ms(run),
                                                 _cuda_ms(run)]}
    print(json.dumps({"sharded_times": out}))
    return 0


def fused_times(root: str) -> int:
    """``--fused-times [ROOT]``: master_graph_fused of the ame_tpu_torch
    package found under ROOT on a quality input (0.1 N(0,1), seed 0) and
    the compat main path's input at N_MAIN, made here: a replay checked
    equal to master_graph, then its device ms (``_cuda_ms``) and host us a
    call (``_host_us``: KERNEL_CALLS calls in a row), each twice. Prints
    one {"fused_times": ...} line."""
    sys.path.insert(0, os.path.abspath(root))
    import ame_tpu_torch
    from ame_tpu_torch.config import MasterSettings
    from ame_tpu_torch.graph import chain
    from ame_tpu_torch.ops.quantize import int16_roundtrip
    phase_device()
    rng = np.random.default_rng(0)
    xq = torch.from_numpy((0.1 * rng.standard_normal((N_MAIN, 2))).astype(
        np.float32)).cuda()
    xc = int16_roundtrip(torch.from_numpy(
        _compat_input(N_MAIN).astype(np.float32)).cuda())
    out = {"package": os.path.dirname(ame_tpu_torch.__file__)}
    for name, settings, x in (("quality", FLAGSHIP, xq),
                              ("compat", COMPAT, xc)):
        s = MasterSettings(**settings)

        def replay():
            return chain.master_graph_fused(x, SR, s)
        if not torch.equal(replay()[0], chain.master_graph(x, SR, s)[0]):
            raise AssertionError(f"fused times {name}: a replay differs "
                                 f"from master_graph")
        out[name] = {"replay_ms": [_cuda_ms(replay), _cuda_ms(replay)],
                     "replay_host_us": [_host_us(replay), _host_us(replay)]}
        chain._fused.clear()
    print(json.dumps({"fused_times": out}))
    return 0


def kernel_times(root: str) -> int:
    """``--kernel-times [ROOT]``: K5 on the ten main-path cascades and Q14
    (checked against plain, timed, split by launch) and, where the package
    has chunked compat, on the chunk columns [1 323 000, 14] and the
    quality multiband cascades; K1 in both
    directions (checked, timed, split by launch); the quality limiter's
    kernel (checked and timed beside its plain version; a tree without it
    times its plain limiter); K2's carry and full
    sweeps and K3 (checked bit for bit against the full sweep's states,
    timed, with its floor when the library has one) and K4 (from K3's
    starts, checked and timed beside a device copy of m) on the compat
    main path's bands; K4 on random [3, 2^23 + 1234] input (the 4-byte
    route); K2's reset route (checked against K3 + K4 and its plain
    version, its sweeps timed) on the chunked path's bands, where the
    package has it; sos_grad at [2^23 + 1234, 2] (checked, timed beside
    its plain version and the library yardstick), where the package has
    it; and the device chains (quality, compat, compat
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
    lim = phase_limiter()
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
    pkg = os.path.dirname(ame_tpu_torch.__file__)
    sos_grad = (_sos_grad_time() if os.path.exists(
        os.path.join(pkg, "ops", "sos_grad.py")) else None)
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
        "gain_p1": p1, "gain_p2": p2, "sos_grad": sos_grad,
        "lookahead_limiter": lim,
        "chains": chains, "musicologist": analysis}}))
    return 0


SG_VARIANTS = (           # name, -D defines, vector route
    ("general route", {}, False),
    ("vector, 1 step in flight", {"SG_UNROLL": 1}, True),
    ("vector, 2 steps (shipped)", {}, True),
    ("vector, 4 steps", {"SG_UNROLL": 4}, True),
    ("vector, 8 steps", {"SG_UNROLL": 8}, True),
    ("vector, 4 steps, 264 blocks", {"SG_UNROLL": 4, "SG_BLOCKS": 264,
                                     "SG_MIN_BLOCKS": 2}, True),
    ("vector, 1056 blocks", {"SG_BLOCKS": 1056}, True))
SASS_SG_OPS = ("LDG", "SHFL", "F2F.F64.F32", "DADD", "CALL", "BAR", "LDS",
               "STS")


def _sass_counts(so, prefix: str) -> dict:
    """{kernel: {opcode: static count}} over the whole SASS body of each
    kernel in `so` whose name starts with `prefix` (cuobjdump -sass); LDG
    also by width. Empty when cuobjdump is not found."""
    out = {}
    for chunk in (_sass(so) or "").split("Function : ")[1:]:
        name = _kernel_name(chunk.split(None, 1)[0])
        if not name.startswith(prefix):
            continue
        ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", chunk)
        out[name] = {"instructions": len(ops),
                     **{k: sum(o.startswith(k) for o in ops)
                        for k in SASS_SG_OPS},
                     **{f"LDG {w}": sum(o.startswith("LDG") and w in o
                                        for o in ops)
                        for w in (".128", ".64")}}
    return out


def sos_grad_variants(parent: str) -> int:
    """``--sos-grad-variants [PARENT]``: what each design step of
    csrc/sos_grad.cu buys, on one card in one process. Builds the source of
    the ame_tpu_torch under PARENT (an unpacked parent commit; left out
    when not given) and this checkout's source under SG_VARIANTS' defines,
    checks each against sos_grad_plain at [2^23 + 1234, 2] (v, w the
    halves of one [N, 4] tensor; relative 1e-9), and times each by its C
    entry (no wrapper: device time, 10 calls in a row) in two turns, the
    second in reverse order. Prints each build's registers and spills and
    the SASS opcode counts of the parent's and the shipped kernels, then
    one {"sos_grad_variants": ...} line."""
    from ame_tpu_torch.ops import _build
    from ame_tpu_torch.ops.sos_grad import sos_grad_plain
    phase_device()
    builds = [(name, _build._CSRC / "sos_grad.cu", d, vec)
              for name, d, vec in SG_VARIANTS]
    if parent:
        builds.insert(0, ("parent", os.path.join(
            parent, "ame_tpu_torch", "csrc", "sos_grad.cu"), {}, None))
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        def build(i):
            _, src, defines, _ = builds[i]
            so = os.path.join(tmp, f"libsg{i}.so")
            r = subprocess.run([nvcc, *_build.NVCC_FLAGS,
                                *(f"-D{k}={v}" for k, v in defines.items()),
                                "-o", so, str(src)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise AssertionError(f"nvcc {builds[i][0]}: {r.stderr}")
            return so, r.stderr
        with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
            built = list(pool.map(build, range(len(builds))))
        g, v, w = _sos_grad_layouts(N_KERNEL, 2, 10)["halves"]
        want = sos_grad_plain(g, v, w)
        ptr = [t.data_ptr() for t in (g, v, w)]
        ld = [t.stride(0) for t in (g, v, w)]
        stream = torch.cuda.current_stream().cuda_stream
        calls, rows = [], []
        for (name, _, defines, vec), (so, log) in zip(builds, built):
            lib = ctypes.CDLL(so)
            lib.sos_grad_blocks.restype = ctypes.c_longlong
            lib.sos_grad_blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
            nb = lib.sos_grad_blocks(N_KERNEL, 2)
            buf = torch.empty(nb * 5 + 5, dtype=torch.float64, device="cuda")
            out = buf[nb * 5:]
            route = [] if vec is None else [int(vec)]
            args = (*ptr, N_KERNEL, 2, *ld, *route, buf.data_ptr(),
                    out.data_ptr(), stream)
            lib.sos_grad_f64.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                + [ctypes.c_longlong] * 3 + [ctypes.c_int] * len(route)
                + [ctypes.c_void_p] * 3)

            def call(f=lib.sos_grad_f64, a=args):
                if f(*a) != 0:
                    raise AssertionError("sos_grad variant launch failed")
            call()
            rel = _rel_err(out.clone(), want)
            if not rel <= SOS_GRAD_TOL:
                raise AssertionError(f"sos_grad variant {name}: relative "
                                     f"{rel:.3e}")
            calls.append(call)
            rows.append({"variant": name, "defines": defines,
                         "blocks": nb, "max_rel_err": rel,
                         "ptxas": _ptxas_report(log), "_lib": lib})
            print(f"sos_grad variant {name}: {nb} blocks, relative err "
                  f"{rel:.3e}; ptxas {_ptxas_report(log)}")
        order = list(range(len(rows)))
        for turn, seq in enumerate((order, order[::-1])):
            for i in seq:
                rows[i][f"ms_turn{turn + 1}"] = _cuda_ms(calls[i],
                                                         KERNEL_CALLS)
        bound = _sos_grad_bound(N_KERNEL, 2)[0]
        for r, (so, _) in zip(rows, built):
            del r["_lib"]
            r["bound_share"] = bound / min(r["ms_turn1"], r["ms_turn2"])
            if r["variant"] == "parent" or "shipped" in r["variant"]:
                r["sass"] = _sass_counts(so, "sos_grad")
            print(f"sos_grad variant {r['variant']}: {r['ms_turn1']:.4f} / "
                  f"{r['ms_turn2']:.4f} ms ({r['bound_share']:.1%} of "
                  f"{bound:.4f} ms)" + (f"; sass {r['sass']}"
                                        if "sass" in r else ""))
    print(json.dumps({"sos_grad_variants": {"shape": [N_KERNEL, 2],
                                            "bound_ms": bound,
                                            "rows": rows}}))
    return 0


def _no_cloud_art() -> None:
    """The run needs no network: the cloud art provider is left out (where
    its SDK is installed, its probe reaches for credentials over the
    network); art, where a phase asks for it, is the procedural
    provider's."""
    from ame_tpu_torch.creative import art
    art._try_register_vertex = lambda: None


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
    _no_cloud_art()
    rows = phase_cascades()
    chunk_rows = phase_cascades_chunked()
    mb_rows = phase_cascades_mb()
    with tempfile.TemporaryDirectory() as tmp:
        main_run = phase_main(tmp)
        phase_parity()
        mb = phase_quality_mb(tmp)
        phase_quality_mb_parity()
        wedge = phase_wedge()
        lim = phase_limiter()
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
        t0 = time.perf_counter()
        serve = phase_serve(tmp, main_run["chain_ms"])
        serve["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        surfaces = phase_surfaces(tmp, main_run["chain_ms"])
        surfaces["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = phase_sharded(tmp)
        sharded["phase_s"] = time.perf_counter() - t0
        last = phase_train_sharded_stacked(tmp)
        t0 = time.perf_counter()
        fused = phase_fused(tmp)
        fused["phase_s"] = time.perf_counter() - t0
    train_sharded, stacked = last["train_sharded"], last["stacked"]
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
             "fit": fit["counts"], "train": train["counts"],
             **{f"serve_{p}": c for p, c in serve["launches"].items()},
             "gui": surfaces["gui"]["counts"],
             **{f"fleet_{p}": c
                for p, c in surfaces["fleet"]["launches"].items()},
             "master_batch": surfaces["batch"]["counts"],
             **{f"{p}_d{D}": r[f"D{D}"]["counts"]
                for p, r in sharded["paths"].items() for D in SP_MESHES},
             "band_parallel": sharded["bands"]["counts"],
             "shard_time_file": sharded["shard_time_file"]["counts"],
             "train_sharded": train_sharded["counts"],
             "master_batch_stacked": stacked["counts"]}

    def entry(name, source, replaces, path, err, ms, plain_ms, bound,
              **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": paths[path][name],
                "launches_by_path": {p: c.get(name)
                                     for p, c in paths.items()},
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
                      + stream["k5"]["rows"] + sharded["zir"]
                      + stacked["k5"]),
                  stream["k5"]["chain"]["max_abs_err"]),
              sum(r["ms"] for r in quality),
              sum(r["plain_ms"] for r in quality),
              (sum(r["bound_ms"] for r in quality), "bytes"),
              note="ms, plain_ms and bound_ms: the quality path's three "
                   "cascades together; multiband_stage_totals: the K5 "
                   "launches of one master's multiband stage together",
              per_cascade=rows, chunk_columns=chunk_rows,
              quality_multiband=mb_rows, streaming=stream["k5"],
              sharded_zero_input=sharded["zir"],
              stacked=stacked["k5"],
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
        entry("lookahead_limiter", csrc + "lookahead_limiter.cu",
              "none: ame_tpu/ops/limiter.py:40 _limiter_jit is plain jnp",
              "quality", lim["max_abs_err"], lim["ms"], lim["plain_ms"],
              lim["bound"], n=N_KERNEL, rows=lim["rows"]),
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
                         "no_resets_same_input": reset["no_resets"]},
                     "sharded_init": sharded["gain"]["gain_jacobi"]},
                 "gain_p1": {"floor": gain["p1"]["floor"],
                             "sharded_init": sharded["gain"]["gain_p1"]},
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
                   "halves of one [N, 4] tensor; library_ms: torch.einsum "
                   "over an as_strided lag view (f32 sums)",
              max_rel_err=sg["max_rel_err"], shape=sg["shape"],
              library_ms=sg["library_ms"],
              library_rel_err=sg["library_rel_err"],
              one_call_ms=sg["one_call_ms"], device_ms=sg["device_ms"],
              vector_launches=paths["fit"]["sos_grad_vector"],
              sweep=sg["sweep"]),
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
    print(json.dumps({"serve": serve}))
    print(json.dumps({"surfaces": surfaces}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"train_sharded": train_sharded}))
    print(json.dumps({"stacked": {k: v for k, v in stacked.items()
                                  if k != "k5"}}))
    print(json.dumps({"fused": fused}))
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
    if sys.argv[1:2] == ["--fused-profile"]:
        sys.exit(fused_profile(sys.argv[2]))
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2] if len(sys.argv) > 2 else
                              os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1:2] == ["--sos-grad-variants"]:
        sys.exit(sos_grad_variants(sys.argv[2] if len(sys.argv) > 2 else ""))
    if sys.argv[1:2] == ["--sharded-times"]:
        sys.exit(sharded_times(sys.argv[2] if len(sys.argv) > 2 else
                               os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1:2] == ["--fused-times"]:
        sys.exit(fused_times(sys.argv[2] if len(sys.argv) > 2 else
                             os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())

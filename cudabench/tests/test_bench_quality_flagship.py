"""The ``quality_flagship`` configuration (the default deployment, -14 LUFS
two-pass loudness) and its cell ``quality_flagship.album_dynamic``: the
spec finds the cell, its configuration, its reference and its readers;
the true peak's least work (``work/true_peak.py``); the readers read
nothing without a trace; and on the CPU the program's masters pass the
check while the control (the reference in TF32) fails it."""

import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from ame_tpu_torch import api
from cudabench import harness, peaks, traffic
from cudabench.reference import quality, wav
from cudabench.spec import BENCH_DIR, Spec
from cudabench.trace import Trace
from cudabench.work import true_peak

CELL = "quality_flagship.album_dynamic"
NOLUFS = "quality_flagship_nolufs.album_dynamic"
METRICS = {"loudnorm.true_peak_product_ms",
           "loudnorm.true_peak_product_roofline"}
SEED = 2**33 + 21


def test_spec_finds_the_cell_and_its_files():
    spec = Spec()
    w = spec.cell(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "quality_flagship", "album_dynamic", 1)
    config = spec.config("quality_flagship")
    base = spec.config("quality_flagship_nolufs")
    assert config["settings"] == dict(base["settings"], lufs=-14.0,
                                      target_tp=-1.5, target_lra=11.0)
    assert config["cascades"][:2] == base["cascades"]
    assert config["cascades"][2]["sections"] == 2
    assert true_peak.kernel_names(config)
    ref = spec.reference("quality_flagship")
    assert ref.LIMITS == {"max_lsb": 6}
    assert set(ref.INFO_LIMITS) == {"input_tp", "input_lra"}
    assert {m["name"] for m in spec.end_to_end(CELL)} == {
        "audio_x_realtime", "setup_s"}
    # its own two, and every per-layer metric of the nolufs cell: each
    # reads the harness's wrappers or the trace, which both cells have
    nolufs = {m["name"] for m in spec.per_layer(NOLUFS)}
    assert {m["name"] for m in spec.per_layer(CELL)} == METRICS | nolufs
    assert not METRICS & nolufs
    for m in spec.per_layer(CELL):
        assert m["moves"] == "audio_x_realtime"
        assert callable(spec.reader(m["name"]).read)
        if m["name"] in METRICS:
            assert m["source"] == "device_trace"
    entry = [c for c in spec.benchmark["configs"]
             if c["name"] == "quality_flagship"][0]
    assert entry["reduced"] == config["reduced"] == []
    assert entry["source"] == config["source"]


def test_reference_imports_neither_package_nor_jax():
    code = ("import sys; import cudabench.reference.quality_flagship; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ame_tpu', 'ame_tpu_torch', 'torch')]; "
            "print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("n, c", [(44100 * 30, 2), (15_567_300, 2)])
def test_true_peak_least_work(n, c):
    h100 = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert true_peak.bytes_for(n, c) == 4 * n * c
    assert true_peak.flops_for(n, c) == 2 * 4 * 32 * n * c
    t = true_peak.least_seconds(n, c, h100)
    # reading the input bounds it: 256 operations a 4-byte sample at
    # 989 TFLOP/s take less than 4 bytes at 3.35 TB/s
    assert t == pytest.approx(4 * n * c / 3.35e12)
    assert t > 2 * 4 * 32 * n * c / 989e12


def _run(trace, config, n=(441000, 882000)):
    calls = [harness.Call(k, k, m, m / 44100, 1.0, True)
             for k, m in enumerate(n)]
    return harness.Run(config=config, setup_s=1.0, window_s=1.0,
                       calls=calls, spans=[], trace=trace, counters={},
                       peaks=peaks.for_device("NVIDIA H100 80GB HBM3"))


@pytest.mark.parametrize("name", sorted(METRICS))
def test_readers_read_nothing_without_a_trace(name):
    spec = Spec()
    reader = spec.reader(name)
    config = spec.config("quality_flagship")
    assert reader.read(_run(None, config)) is None
    no_kernel = Trace(1.0, 0.5, [0, 1], {"cascade_outputs": 0.01}, [])
    assert reader.read(_run(no_kernel, config)) is None
    # a configuration without the key (the nolufs cell's) reads nothing
    some = Trace(1.0, 0.5, [0, 1], {
        true_peak.kernel_names(config)[0] + "_x": 0.002}, [])
    assert reader.read(_run(some, spec.config(
        "quality_flagship_nolufs"))) is None
    assert reader.read(_run(some, config)) > 0


def test_readers_arithmetic():
    spec = Spec()
    config = spec.config("quality_flagship")
    name = true_peak.kernel_names(config)[0]
    tr = Trace(1.0, 0.5, [0, 1], {name: 0.004, "other": 1.0}, [])
    run = _run(tr, config)
    assert spec.reader("loudnorm.true_peak_product_ms").read(run) == \
        pytest.approx(2.0)
    least = sum(true_peak.least_seconds(m, 2, run.peaks)
                for m in (441000, 882000))
    assert spec.reader("loudnorm.true_peak_product_roofline").read(run) == \
        pytest.approx(100.0 * least / 0.004)


def _small_mix(spec, seconds, pool):
    mix = spec.mix(spec.cell(CELL)["traffic"])
    mix["lengths"] = {"kind": "fixed", "seconds": seconds}
    mix["pool"] = pool
    return mix


def test_reference_master_is_the_quality_chain():
    """The configuration's reference writes ``quality.master``'s master
    bit for bit and its info, and adds the true peak and the LRA."""
    spec = Spec()
    settings = spec.config("quality_flagship")["settings"]
    ref = spec.reference("quality_flagship")
    (tr,) = traffic.make_pool(_small_mix(spec, 8.0, 1), SEED, "cpu")
    info, base = {}, {}
    got = ref.master(tr.pcm, 44100.0, settings, info=info)
    want = quality.master(tr.pcm, 44100.0, settings, info=base)
    assert np.array_equal(got, want)
    assert info == dict(base, input_tp=info["input_tp"],
                        input_lra=info["input_lra"])
    with pytest.raises(ValueError):
        ref.master(tr.pcm, 44100.0, dict(settings, lufs=None))


def test_reference_true_peak_of_a_sine_between_its_samples():
    """A sine at a sixteenth of the rate, sampled 11.25 degrees off its
    crests, peaks 0.17 dB above its samples; the 4x bank, whose phases
    fall on the crests, reads it to the bank's passband ripple. Phase 0
    is a pure delay and every phase passes DC at unit gain within 5e-4."""
    ref = Spec().reference("quality_flagship")
    bank = ref.tp_bank()
    assert bank.shape == (4, 32)
    assert np.abs(bank.sum(axis=1) - 1.0).max() < 5e-4
    assert np.count_nonzero(np.abs(bank[0]) > 1e-9) == 1
    n = np.arange(44100)
    x = 0.5 * np.sin(np.pi / 8 * n + np.pi / 16)[:, None] * np.ones((1, 2))
    assert 20 * np.log10(np.abs(x).max()) == pytest.approx(-6.19, abs=0.01)
    assert ref.true_peak_db(x) == pytest.approx(-6.02, abs=0.015)
    assert ref.true_peak_db(np.zeros((1000, 2))) == -240.0


@pytest.mark.parametrize("content", ["album", "noise", "square"])
def test_reference_true_peak_equals_every_interpolant(content):
    """The reference computes interpolants only where they can pass the
    sample peak; its reading equals the maximum over all of them, each
    phase a causal FIR from zero history: on the album mix's content (a
    few clicks above the rest), on noise, and on a full-scale square wave
    (every sample a candidate)."""
    spec = Spec()
    ref = spec.reference("quality_flagship")
    if content == "album":
        (tr,) = traffic.make_pool(_small_mix(spec, 6.0, 1), SEED, "cpu")
        x = tr.pcm / 32768.0
    elif content == "noise":
        x = np.random.default_rng(3).standard_normal((44100, 2)) * 0.2
    else:
        x = np.sign(np.sin(2 * np.pi * 441 * np.arange(20000) / 44100))
        x = np.stack([x, -0.5 * x], axis=1)
    n = x.shape[0]
    every = max(np.abs(np.convolve(ch, phase)[:n]).max()
                for phase in ref.tp_bank() for ch in x.T)
    want = 20 * np.log10(max(every, np.abs(x).max()))
    assert ref.true_peak_db(x) == pytest.approx(want, abs=1e-12)


def test_reference_loudness_range_of_two_levels():
    """10 s of a 1 kHz tone, then 10 s of it 10 dB down: 18 blocks of
    3 s, 8 at each level and 2 between, so P10 and P95 fall on the two
    levels and the range is 10 LU."""
    ref = Spec().reference("quality_flagship")
    n = np.arange(10 * 44100)
    tone = 0.3 * np.sin(2 * np.pi * 1000 * n / 44100)
    x = np.concatenate([tone, tone * 10 ** -0.5])[:, None] * np.ones((1, 2))
    assert ref.loudness_range(x, 44100.0) == pytest.approx(10.0, abs=1e-6)
    assert ref.loudness_range(x[:2 * 44100], 44100.0) == 0.0
    assert ref.loudness_range(np.zeros((5 * 44100, 2)), 44100.0) == 0.0


def test_program_passes_and_control_fails(tmp_path):
    """The masters within ``LIMITS`` and the TF32 control outside; the
    program's true peak and LRA within ``INFO_LIMITS`` of the reference's,
    where the sample peak (no oversampling) and the control's LRA are
    outside. The control's true peak is nearer the reference than the
    program's, which runs its product on bf16-rounded samples. As the
    check's `max_lsb`, the LRA's gap is the widest over a run's tracks:
    the control's is narrower than the limit on some tracks."""
    spec = Spec()
    config = spec.config("quality_flagship")
    ref = spec.reference("quality_flagship")
    limit = ref.LIMITS["max_lsb"]
    tp_limit, lra_limit = (ref.INFO_LIMITS["input_tp"],
                           ref.INFO_LIMITS["input_lra"])
    control_lra_gaps = []
    for tr in traffic.make_pool(_small_mix(spec, 12.0, 2), SEED, "cpu"):
        path = tmp_path / "in.wav"
        path.write_bytes(wav.encode(tr.pcm, tr.sample_rate))
        info = api.master_file(str(path), str(tmp_path / "out.wav"),
                               config["settings"], device="cpu")
        got, _ = wav.decode((tmp_path / "out.wav").read_bytes())
        want_info = {}
        want = ref.master(tr.pcm, 44100.0, config["settings"],
                          info=want_info)
        control_info = {}
        control = ref.master(tr.pcm, 44100.0, config["settings"],
                             mantissa_bits=10, info=control_info)
        assert np.abs(got.astype(int) - want).max() <= limit
        assert np.abs(control.astype(int) - want).max() > limit
        assert abs(float(info["gain_db"]) - want_info["gain_db"]) < 1e-3
        assert abs(info["input_tp"] - want_info["input_tp"]) <= tp_limit
        assert abs(info["input_lra"] - want_info["input_lra"]) <= lra_limit
        sample_peak_db = 20 * np.log10(
            want_info["limiter_in_peak"] / 10 ** (want_info["gain_db"] / 20))
        assert want_info["input_tp"] - sample_peak_db > tp_limit
        control_lra_gaps.append(abs(control_info["input_lra"]
                                    - want_info["input_lra"]))
        assert (abs(control_info["input_tp"] - want_info["input_tp"])
                < abs(info["input_tp"] - want_info["input_tp"]))
    assert max(control_lra_gaps) > lra_limit


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_is_correct(trace):
    """The harness on the CPU: correct, the end-to-end metrics untraced,
    and traced only the per-layer metrics of the harness's host spans (no
    card, no device kernels). A 6 s window, so that a loaded host still
    reaches every sampled call (in 3 s, one was missed once in a full
    run of this file)."""
    spec = Spec()
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, SEED, 6.0, trace, t_start=time.perf_counter(),
                     device="cpu", spec=spec, mix=_small_mix(spec, 4.0, 3),
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == ({
        "io.decode_ms", "io.write_ms", "chain.call_ms"} if trace else {
        "audio_x_realtime", "setup_s"})


# Product kernels read off the card's trace (NVIDIA H100 80GB HBM3, torch
# 2.11, CUDA 12.8) at the album's 12 track lengths: cuBLAS picks the true
# peak's [512, 256] x [256, nb * 2] product ("nn") by shape, and the
# limiter's moving-sum product (ops/window, "tn") likewise.
TRUE_PEAK_SEEN = [
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_warpsize1",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3_warpsiz",
]
LIMITER_SEEN = [
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize1",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x256x8_stage3_warpsize",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x256x8_stage3_warpsiz",
]


def test_true_peak_kernel_names_pick_the_product_only():
    """The names pick every true-peak product kernel seen on the card and
    none of the chain's other kernels."""
    config = Spec().config("quality_flagship")
    names = true_peak.kernel_names(config)
    others = LIMITER_SEEN + config["cascade_kernels"] + [
        "wedge", "release", "elementwise", "reduce", "Memcpy", "Memset"]
    for op in TRUE_PEAK_SEEN:
        assert any(n in op for n in names), op
    for op in others:
        assert not any(n in op for n in names), op

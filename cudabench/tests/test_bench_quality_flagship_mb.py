"""The ``quality_flagship_mb_nolufs`` configuration (the 3-band multiband
compressor at the GUI's default bands, loudness off) and its cell
``quality_flagship_mb_nolufs.album_hot``: the spec finds the cell, its
configuration, its mix, its reference and its readers; the reference's
LR4 split; the mix puts every band over its threshold most of the time;
on the CPU the program's masters pass the check, while the control (the
reference in TF32) and masters with a planted fault in the stage fail
it; the readers read nothing where there is nothing to read."""

import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest
from scipy.signal import butter, sosfilt, sosfreqz

from ame_tpu_torch import api
from cudabench import harness, peaks, traffic
from cudabench.reference import wav
from cudabench.spec import BENCH_DIR, Spec
from cudabench.trace import Trace

CELL = "quality_flagship_mb_nolufs.album_hot"
CONFIG = "quality_flagship_mb_nolufs"
NOLUFS = "quality_flagship_nolufs.album_dynamic"
METRICS = {"multiband.compressor_ms", "multiband.release_launches"}
SEED = 2**33 + 25
FS = 44100.0


def test_spec_finds_the_cell_and_its_files():
    spec = Spec()
    w = spec.cell(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        CONFIG, "album_hot", 1)
    config = spec.config(CONFIG)
    base = spec.config("quality_flagship_nolufs")
    assert config["settings"] == dict(
        base["settings"], multiband=True, low_thresh=-25.0, low_ratio=6.0,
        mid_thresh=-20.0, mid_ratio=3.0, high_thresh=-15.0, high_ratio=4.0)
    assert config["cascades"][:2] == base["cascades"]
    assert [(c["sections"], c["channels"]) for c in
            config["cascades"][2:]] == [(2, 2), (4, 2), (4, 2), (1, 3)]
    assert config["cascade_kernels"] == base["cascade_kernels"]
    assert config["compressor_kernels"]
    ref = spec.reference(CONFIG)
    assert ref.LIMITS == {"max_lsb": 6}
    assert {m["name"] for m in spec.end_to_end(CELL)} == {
        "audio_x_realtime", "setup_s"}
    # its own two, and every per-layer metric of the nolufs cell
    nolufs = {m["name"] for m in spec.per_layer(NOLUFS)}
    assert {m["name"] for m in spec.per_layer(CELL)} == METRICS | nolufs
    for m in spec.per_layer(CELL):
        assert m["moves"] == "audio_x_realtime"
        assert callable(spec.reader(m["name"]).read)
    entry = [c for c in spec.benchmark["configs"] if c["name"] == CONFIG][0]
    assert entry["reduced"] == config["reduced"] == []
    assert entry["source"] == config["source"]


def test_mix_is_album_dynamic_at_a_level_the_compressor_acts_on():
    spec = Spec()
    hot, base = spec.mix("album_hot"), spec.mix("album_dynamic")
    assert hot["content"] == dict(base["content"], noise=0.25, sine=0.25)
    assert {k: v for k, v in hot.items()
            if k not in ("content", "source", "assumed")} == {
        k: v for k, v in base.items()
        if k not in ("content", "source", "assumed")}


def test_reference_imports_neither_package_nor_jax():
    code = ("import sys; import cudabench.reference.quality_flagship_mb_nolufs"
            "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ame_tpu', 'ame_tpu_torch', 'torch')]; "
            "print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=BENCH_DIR.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _response_db(cascades, f):
    h = sum(sosfreqz(c, worN=f, fs=FS)[1] for c in cascades)
    return 20 * np.log10(np.abs(h))


def test_reference_lr4_split():
    """Each biquad is scipy's 2nd-order Butterworth; each crossover's LR4
    pair sums to an allpass; the three bands sum to within 0.05 dB of flat
    over 20 Hz - 20 kHz (0.042 dB at 329 Hz: the low band passes no 4 kHz
    allpass), and to within 1e-6 dB once it does."""
    ref = Spec().reference(CONFIG)
    for fc in (ref.LOW_HZ, ref.HIGH_HZ):
        for kind in ("low", "high"):
            want = butter(2, fc, kind, fs=FS, output="sos")[0]
            assert np.abs(ref.butter2(fc, FS, kind) - want).max() < 1e-12
    f = np.geomspace(20.0, 20000.0, 2000)
    for fc in (ref.LOW_HZ, ref.HIGH_HZ):
        pair = [ref.lr4(fc, FS, "low"), ref.lr4(fc, FS, "high")]
        assert np.abs(_response_db(pair, f)).max() < 1e-6
    low, mid, high = ref.band_cascades(FS)
    three = np.abs(_response_db([low, mid, high], f))
    assert 0.035 < three.max() < 0.05
    allpass_4k = [np.concatenate([low, ref.lr4(ref.HIGH_HZ, FS, k)])
                  for k in ("low", "high")]
    assert np.abs(_response_db(allpass_4k + [mid, high], f)).max() < 1e-6


@pytest.fixture(scope="module")
def hot_track():
    """A 20 s track of the cell's mix, seeded."""
    spec = Spec()
    mix = spec.mix("album_hot")
    mix["lengths"] = {"kind": "fixed", "seconds": 20.0}
    mix["pool"] = 1
    (tr,) = traffic.make_pool(mix, SEED, "cpu")
    return tr


@pytest.fixture(scope="module")
def want(hot_track):
    """(the reference's master, its info)."""
    spec = Spec()
    info = {}
    y = spec.reference(CONFIG).master(
        hot_track.pcm, FS, spec.config(CONFIG)["settings"], info=info)
    return y, info


def _lsb(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_program_passes_and_control_fails(hot_track, want, tmp_path):
    """The program's master on the CPU reads 1 LSB from the reference (the
    limit is 6); the reference in TF32 reads 39-42 on this mix's tracks."""
    spec = Spec()
    settings = spec.config(CONFIG)["settings"]
    ref = spec.reference(CONFIG)
    path = tmp_path / "in.wav"
    path.write_bytes(wav.encode(hot_track.pcm, hot_track.sample_rate))
    api.master_file(str(path), str(tmp_path / "out.wav"), settings,
                    device="cpu")
    got, _ = wav.decode((tmp_path / "out.wav").read_bytes())
    limit = ref.LIMITS["max_lsb"]
    assert _lsb(got, want[0]) <= limit
    control = ref.master(hot_track.pcm, FS, settings, mantissa_bits=10)
    assert _lsb(control, want[0]) > limit


def test_mix_keeps_every_band_over_its_threshold(want):
    """Of the sounding frames, at least half have every band's level over
    its threshold (low and high ~99.8 %, mid ~80 %)."""
    info = want[1]
    for band in ("low", "mid", "high"):
        assert info[f"over_{band}"] >= 0.5, info


def _compat_split(x, fs):
    """The engine's wiring: order-4 Butterworth low and high bands and a
    subtractive mid."""
    low = butter(4, 250.0, "lowpass", fs=fs, output="sos")
    high = butter(4, 4000.0, "highpass", fs=fs, output="sos")
    lo, hi = sosfilt(low, x, axis=0), sosfilt(high, x, axis=0)
    return [lo, x - lo - hi, hi]


FAULTS = {
    "low_band_off": ({"low_ratio": 1.0}, None),
    "mid_band_off": ({"mid_ratio": 1.0}, None),
    "high_band_off": ({"high_ratio": 1.0}, None),
    "mid_threshold_up_1db": ({"mid_thresh": -19.0}, None),
    "mid_threshold_down_1db": ({"mid_thresh": -21.0}, None),
    "no_release": ({}, ("release", lambda gr, fs: gr)),
    "no_attack": ({}, ("attack", lambda gr, fs: gr)),
    "compat_split": ({}, ("split", _compat_split)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_check(fault, hot_track, want, monkeypatch):
    spec = Spec()
    settings = spec.config(CONFIG)["settings"]
    ref = spec.reference(CONFIG)
    changed, patch = FAULTS[fault]
    if patch is not None:
        monkeypatch.setattr(ref, *patch)
    got = ref.master(hot_track.pcm, FS, dict(settings, **changed))
    assert _lsb(got, want[0]) > ref.LIMITS["max_lsb"]


def _run(trace, config, counters=None, n=(441000, 882000)):
    calls = [harness.Call(k, k, m, m / 44100, 1.0, True)
             for k, m in enumerate(n)]
    return harness.Run(config=config, setup_s=1.0, window_s=1.0,
                       calls=calls, spans=[], trace=trace,
                       counters=counters or {},
                       peaks=peaks.for_device("NVIDIA H100 80GB HBM3"))


def test_compressor_ms_reads_nothing_without_its_kernels():
    spec = Spec()
    reader = spec.reader("multiband.compressor_ms")
    config = spec.config(CONFIG)
    name = config["compressor_kernels"][0]
    assert reader.read(_run(None, config)) is None
    no_kernel = Trace(1.0, 0.5, [0, 1], {"cascade_outputs": 0.01}, [])
    assert reader.read(_run(no_kernel, config)) is None
    some = Trace(1.0, 0.5, [0, 1], {"void " + name + "<x>": 0.004,
                                    "cascade_outputs": 1.0}, [])
    # a configuration without the key (the nolufs cell's) reads nothing
    assert reader.read(_run(some, spec.config(
        "quality_flagship_nolufs"))) is None
    assert reader.read(_run(some, config)) == pytest.approx(2.0)


def test_release_launches_reads_the_counter():
    spec = Spec()
    reader = spec.reader("multiband.release_launches")
    config = spec.config(CONFIG)
    assert reader.read(_run(None, config)) is None     # a parent: no key
    assert reader.read(_run(None, config, {
        "window.release_scan.launches": 214})) == pytest.approx(107.0)
    empty = _run(None, config, {"window.release_scan.launches": 0}, n=())
    assert reader.read(empty) is None


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_is_correct(trace):
    """The harness on the CPU: correct, the end-to-end metrics untraced;
    traced, the harness's host spans and the release scan's counter (the
    device metrics read nothing without a card). On the CPU the counter
    counts the plain limiter's scan too."""
    spec = Spec()
    mix = spec.mix("album_hot")
    mix["lengths"] = {"kind": "fixed", "seconds": 4.0}
    mix["pool"] = 3
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, SEED, 6.0, trace, t_start=time.perf_counter(),
                     device="cpu", spec=spec, mix=mix, out=out, err=err)
    assert rc == 0, err.getvalue()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == ({
        "io.decode_ms", "io.write_ms", "chain.call_ms",
        "multiband.release_launches"} if trace else {
        "audio_x_realtime", "setup_s"})
    if trace:
        # [N, 3] and [N] at N = 176 400: 4 a sweep, 7 + 11 sweeps, 11 more
        assert res["metrics"]["multiband.release_launches"]["value"] == (
            2 * (4 * 18 + 11))


# Device kernels read off the card's trace (NVIDIA H100 80GB HBM3, torch
# 2.11, CUDA 12.8) of one master at the mix's mean track, names cut to 200
# characters: those of the multiband stage that the configuration's
# ``compressor_kernels`` pick, and every other kernel of the master
# (K5, the limiter, and the elementwise, cat, fill and copy kernels that
# the stage shares with the rest of the chain).
COMPRESSOR_SEEN = [
    ('void at::native::vectorized_elementwise_kernel<4, at::native::Bi'
     'naryFunctor<float, float, float, at::native::maximum_kernel_cuda'
     '(at::TensorIteratorBase&)::{lambda()#2}::operator()() const::{la'
     'mbda()#2'),
    ('void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align'
     '1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<floa'
     't, at::native::MeanOps<float, float, float, float>, unsigned int'
     ', float, 4, 4> >(at::native::ReduceOp<float, at::native::MeanOps'
     '<float, '),
    ('void at::native::elementwise_kernel<128, 4, at::native::gpu_kern'
     'el_impl<at::native::(anonymous namespace)::pow_tensor_tensor_ker'
     'nel(at::TensorIteratorBase&)::{lambda()#1}::operator()() const::'
     '{lambda('),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::lo'
     'g10_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator'
     '()() const::{lambda()#2}::operator()() const::{lambda(float)#1},'
     ' std::ar'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::ne'
     'g_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator()'
     '() const::{lambda()#7}::operator()() const::{lambda(float)#1}, s'
     'td::arra'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::re'
     'ciprocal_kernel_cuda(at::TensorIteratorBase&)::{lambda()#1}::ope'
     'rator()() const::{lambda()#2}::operator()() const::{lambda(float'
     ')#1}, st'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::ex'
     'p_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator()'
     '() const::{lambda()#2}::operator()() const::{lambda(float)#1}, s'
     'td::arra'),
]
OTHERS_SEEN = [
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::'
     'native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 3, '
     '64, 64>(at::native::(anonymous namespace)::OpaqueType<4u>*, at::'
     'native::'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::AU'
     'naryFunctor<float, float, float, at::native::binary_internal::Mu'
     'lFunctor<float> >, std::array<char*, 2ul> >(int, at::native::AUn'
     'aryFunct'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_alig'
     'nedK_contig<at::native::(anonymous namespace)::OpaqueType<4u>, u'
     'nsigned int, 2, 128, 1, 16>(at::native::(anonymous namespace)::O'
     'paqueTyp'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kern'
     'el_impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIte'
     'ratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::ope'
     'rator()('),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kern'
     'el_impl_nocast<at::native::BinaryFunctor<float, float, float, at'
     '::native::binary_internal::MulFunctor<float> > >(at::TensorItera'
     'torBase&'),
    ('void cascade_outputs<4, false>(float const*, float const*, float'
     ' const*, float*, float*, float const*, long long, int, int, int,'
     ' Params)'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_vect'
     'orized<at::native::(anonymous namespace)::OpaqueType<4u>, unsign'
     'ed int, 2, 128, 1, 16, 4>(char*, at::native::(anonymous namespac'
     'e)::CatA'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CU'
     'DAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::'
     'CUDAFunctor_add<float>, std::array<char*, 3ul>)'),
    ('void lookahead_limiter_kernel<2>(float const*, float*, float*, u'
     'nsigned long long*, float const*, long long, int, int, float, fl'
     'oat)'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kern'
     'el_impl_nocast<at::native::CUDAFunctor_add<float> >(at::TensorIt'
     'eratorBase&, at::native::CUDAFunctor_add<float> const&)::{lambda'
     '(int)#1}'),
    ('void cascade_ends<4, false>(float const*, float*, float*, float '
     'const*, long long, int, int, int, Params)'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::(a'
     'nonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&'
     ', c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{l'
     'ambda()#'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::Bi'
     'naryFunctor<float, float, float, at::native::binary_internal::Mu'
     'lFunctor<float> >, std::array<char*, 3ul> >(int, at::native::Bin'
     'aryFunct'),
    ('void cascade_outputs<2, false>(float const*, float const*, float'
     ' const*, float*, float*, float const*, long long, int, int, int,'
     ' Params)'),
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kern'
     'el_impl_nocast<at::native::BinaryFunctor<float, float, float, at'
     '::native::binary_internal::DivFunctor<float> > >(at::TensorItera'
     'torBase&'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_vect'
     'orized<at::native::(anonymous namespace)::OpaqueType<4u>, unsign'
     'ed int, 1, 128, 1, 16, 4>(char*, at::native::(anonymous namespac'
     'e)::CatA'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::Fi'
     'llFunctor<float>, std::array<char*, 1ul> >(int, at::native::Fill'
     'Functor<float>, std::array<char*, 1ul>)'),
    ('void (anonymous namespace)::elementwise_kernel_with_index<int, a'
     't::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const'
     '&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() '
     'const::{'),
    ('void cascade_ends<2, false>(float const*, float*, float*, float '
     'const*, long long, int, int, int, Params)'),
    ('void cascade_outputs<1, false>(float const*, float const*, float'
     ' const*, float*, float*, float const*, long long, int, int, int,'
     ' Params)'),
    ('Memcpy DtoD (Device -> Device)'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::BU'
     'naryFunctor<float, float, float, at::native::binary_internal::Mu'
     'lFunctor<float> >, std::array<char*, 2ul> >(int, at::native::BUn'
     'aryFunct'),
    ('void cascade_carries<4>(float const*, float const*, float*, floa'
     't const*, long long, int, Params)'),
    ('void cascade_ends<1, false>(float const*, float*, float*, float '
     'const*, long long, int, int, int, Params)'),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::(a'
     'nonymous namespace)::launch_clamp_scalar(at::TensorIteratorBase&'
     ', c10::Scalar, c10::Scalar, at::native::detail::ClampLimits)::{l'
     'ambda()#'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::ta'
     'nh_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator('
     ')() const::{lambda()#2}::operator()() const::{lambda(float)#1}, '
     'std::arr'),
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_'
     'copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operato'
     'r()() const::{lambda()#7}::operator()() const::{lambda(float)#1}'
     ', std::a'),
    ('void cascade_carries<2>(float const*, float const*, float*, floa'
     't const*, long long, int, Params)'),
    ('void cascade_carries<1>(float const*, float const*, float*, floa'
     't const*, long long, int, Params)'),
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::'
     'native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 2, '
     '64, 64>(at::native::(anonymous namespace)::OpaqueType<4u>*, at::'
     'native::'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CU'
     'DAFunctorOnOther_add<float>, std::array<char*, 2ul> >(int, at::n'
     'ative::CUDAFunctorOnOther_add<float>, std::array<char*, 2ul>)'),
    ('Memcpy HtoD (Pageable -> Device)'),
    ('Memset (Device)'),
    ('void at::native::vectorized_elementwise_kernel<2, at::native::Fi'
     'llFunctor<double>, std::array<char*, 1ul> >(int, at::native::Fil'
     'lFunctor<double>, std::array<char*, 1ul>)'),
    ('void (anonymous namespace)::elementwise_kernel_with_index<int, a'
     't::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const'
     '&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() '
     'const::{'),
]


def test_compressor_kernel_names_pick_the_compressor_only():
    names = Spec().config(CONFIG)["compressor_kernels"]
    for op in COMPRESSOR_SEEN:
        assert any(n in op for n in names), op
    for op in OTHERS_SEEN:
        assert not any(n in op for n in names), op
    for n in names:
        assert any(n in op for op in COMPRESSOR_SEEN), n


@pytest.mark.cuda
def test_compressor_kernels_run_only_in_the_stage_on_the_card(tmp_path):
    """On the card, over ``master_file`` at each of the mix's 12 lengths
    (cuBLAS picks the level's product by shape), every kernel that the
    names pick runs inside one of the stage's ``multiband.*`` ranges, and
    each name picks one. (The profiler copies a range onto the device's
    timeline only where kernels launch inside it and no inner range, so
    ``chain.multiband`` has no copy of its own there.)"""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from ame_tpu_torch.utils import telemetry
    spec = Spec()
    config = spec.config(CONFIG)
    names = config["compressor_kernels"]
    paths = []
    for i, tr in enumerate(traffic.make_pool(spec.mix("album_hot"), SEED,
                                             "cuda")):
        paths.append(tmp_path / f"in{i}.wav")
        paths[-1].write_bytes(wav.encode(tr.pcm, tr.sample_rate))
    api.master_file(str(paths[0]), str(tmp_path / "out.wav"),
                    config["settings"], device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with telemetry.tracing(), torch.profiler.profile(activities=acts) as p:
        for path in paths:
            api.master_file(str(path), str(tmp_path / "out.wav"),
                            config["settings"], device="cuda")
        torch.cuda.synchronize()
    stage, picked = [], []
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("ame.multiband."):
            stage.append((a, b))
        elif not e.name.startswith("ame.") and any(n in e.name
                                                   for n in names):
            picked.append((e.name, a, b))
    assert len(stage) >= 4 * len(paths)
    for name, a, b in picked:
        assert any(s <= a and b <= t for s, t in stage), name
    for n in names:
        assert any(n in name for name, _, _ in picked), n

"""The port's sequence-parallel COMPAT chain (ame_tpu_torch.parallel
.sp_compat) on the CPU, D = 8 shards on the CPU, against ame_tpu's on its 8
virtual CPU devices at tests/test_parallel.py's shapes, settings and
tolerances, and against the port's one-device master_graph. Each
reference is computed once per module, with COMPAT_CHUNK_SECONDS = 1 in
both packages where the case is chunked, as there; the random sweeps are
held to the port's one-device chain."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.parallel.mesh import make_mesh
from tests.conftest import make_test_signal

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _mesh(n=8):
    return make_mesh({"sp": n}, devices=["cpu"] * n)


def _ref_mesh():
    from ame_tpu.parallel.mesh import make_mesh as ref_make_mesh
    return ref_make_mesh({"sp": 8}, devices=jax.devices()[:8])


def _int16_grid(x):
    return (np.trunc(np.clip(x, -1, 1) * 32767.0) / 32768.0).astype(
        np.float32)


@contextlib.contextmanager
def _chunk_seconds(seconds):
    """COMPAT_CHUNK_SECONDS in both packages, for the chunked cases."""
    import ame_tpu.config as ref_config
    import ame_tpu_torch.config as port_config
    with pytest.MonkeyPatch.context() as mp:
        if seconds is not None:
            mp.setattr(ref_config, "COMPAT_CHUNK_SECONDS", seconds)
            mp.setattr(port_config, "COMPAT_CHUNK_SECONDS", seconds)
        yield


def _chunked_input():
    """tests/test_parallel.py:348-355: 8 shards x one 1 s chunk."""
    sr = 16000
    n = 8 * sr
    x = make_test_signal("noise", n, sr, seed=11) * 0.15
    t = np.arange(n) / sr
    x[:, 0] += 0.2 * np.sin(2 * np.pi * 120.0 * t)
    x[:, 1] += 0.2 * np.sin(2 * np.pi * 120.0 * t + 0.2)
    return sr, _int16_grid(np.clip(x, -0.99, 0.99))


def _eq_input():
    """tests/test_parallel.py:378-382: 4 s sweep at 8 kHz."""
    sr = 8000
    x = make_test_signal("sweep", 8 * 4000, sr, seed=3) * 0.3
    x[:, 1] *= 0.7
    return sr, _int16_grid(x)


def _dynamic_input():
    """tests/test_parallel.py:403-411: a quiet tone and a hot transient."""
    sr = 16000
    n = 8 * sr
    t = np.arange(n) / sr
    x = np.stack([0.05 * np.sin(2 * np.pi * 330.0 * t),
                  0.05 * np.sin(2 * np.pi * 331.0 * t)], 1)
    x[3 * n // 5: 3 * n // 5 + 64] = 0.9
    return sr, _int16_grid(x)


def _padded_input():
    """tests/test_parallel.py:485-488: 6.7 s, no chunk or hop multiple."""
    sr = 16000
    x = make_test_signal("noise", int(6.7 * sr), sr, seed=13) * 0.2
    return sr, _int16_grid(x)


def _mb_input():
    """tests/test_parallel.py:511-518."""
    sr = 16000
    n = 8 * sr
    x = make_test_signal("noise", n, sr, seed=17) * 0.1
    t = np.arange(n) / sr
    x[:, 0] += 0.25 * np.sin(2 * np.pi * 150.0 * t)
    x[:, 1] += 0.25 * np.sin(2 * np.pi * 150.0 * t + 0.3)
    x[n // 2: n // 2 + sr // 2] *= 3.0
    return sr, _int16_grid(x)


def _random_case(seed):
    """tests/test_parallel.py:567-604: random sliders, chunked for odd
    seeds."""
    rng = np.random.default_rng(seed)
    sr = 16000
    n = 8 * sr
    x = make_test_signal("noise", n, sr, seed=seed) * float(
        rng.uniform(0.05, 0.3))
    t = np.arange(n) / sr
    x[:, 0] += 0.15 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
    x[:, 1] *= 0.9
    s = MasterSettings(
        analog_character=float(rng.uniform(0, 40)),
        bass_boost=float(rng.uniform(-2, 3)),
        mid_cut=float(rng.uniform(0, 2)),
        presence_boost=float(rng.uniform(-1, 2)),
        treble_boost=float(rng.uniform(-1, 2)),
        width=float(rng.uniform(0.8, 1.5)),
        multiband=True,
        low_thresh=float(rng.uniform(-35, -20)),
        mid_thresh=float(rng.uniform(-35, -20)),
        high_thresh=float(rng.uniform(-35, -20)),
        low_ratio=float(rng.uniform(2, 6)),
        mid_ratio=float(rng.uniform(2, 6)),
        high_ratio=float(rng.uniform(2, 6)),
        lufs=float(rng.uniform(-18, -10)),
        mode="compat", compat_chunked=bool(seed % 2))
    return (lambda: (sr, _int16_grid(x))), s


# name: (input, settings, chunk seconds, padded, info keys and their
# tolerance, output atol)
CASES = {
    "chunked": (_chunked_input, MasterSettings(
        analog_character=20.0, bass_boost=2.0, width=1.2, multiband=True,
        low_thresh=-28.0, mid_thresh=-26.0, high_thresh=-28.0, lufs=-14.0,
        mode="compat", compat_chunked=True), 1.0, False,
        (("input_i", "input_thresh", "gain_db", "target_offset"), 5e-2),
        2e-3),
    "unchunked_eq": (_eq_input, MasterSettings(
        bass_boost=3.0, mid_cut=1.0, presence_boost=2.0, treble_boost=1.0,
        width=1.3, lufs=-16.0, mode="compat"), None, False,
        (("input_i",), 5e-2), 2e-3),
    "dynamic": (_dynamic_input, MasterSettings(
        lufs=-14.0, mode="compat", compat_chunked=True), 1.0, False,
        (("output_i",), 5e-2), 2e-3),
    "padded": (_padded_input, MasterSettings(
        bass_boost=2.0, multiband=True, lufs=-14.0, mode="compat",
        compat_chunked=True), 1.0, True, (("input_i",), 0.1), 3e-3),
    "unchunked_mb": (_mb_input, MasterSettings(
        bass_boost=1.5, multiband=True, low_thresh=-30.0, mid_thresh=-28.0,
        high_thresh=-30.0, low_ratio=4.0, mid_ratio=3.0, high_ratio=4.0,
        lufs=-14.0, mode="compat"), None, False, (("input_i",), 5e-2), 2e-3),
    **{f"random_{seed}": (*_random_case(seed), 1.0, False,
                          (("input_i",), 0.1), 3e-3)
       for seed in (31, 32)},
}


# the random sweeps are held to the port's one-device chain only (the port
# against the port); ame_tpu's sharded chain is compiled for the others
PORT_ONLY = {"random_31", "random_32"}


@pytest.fixture(scope="module")
def refs():
    """ame_tpu's sequence-parallel master of each case, once."""
    from ame_tpu.config import MasterSettings as RefSettings
    from ame_tpu.parallel.sp_master import (
        master_sequence_parallel as ref_sp,
        master_sequence_parallel_padded as ref_sp_padded)
    out = {}
    for name, (make, s, seconds, padded, _, _) in CASES.items():
        if name in PORT_ONLY:
            continue
        sr, x = make()
        with _chunk_seconds(seconds):
            fn = ref_sp_padded if padded else ref_sp
            y, info = fn(jnp.asarray(x), sr, RefSettings(**s.to_dict()),
                         _ref_mesh())
            out[name] = (np.asarray(y),
                         {k: float(v) for k, v in info.items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_sp_compat_matches_reference(case, refs):
    """D = 8 against ame_tpu's sharded compat chain (not for PORT_ONLY)
    and the port's one-device master_graph: info within
    tests/test_parallel.py's tolerance, linear_mode equal, output within
    its atol (rtol 5e-3)."""
    from ame_tpu_torch.parallel.sp_master import (
        master_sequence_parallel, master_sequence_parallel_padded)
    make, s, seconds, padded, (keys, tol), atol = CASES[case]
    sr, x = make()
    with _chunk_seconds(seconds):
        fn = master_sequence_parallel_padded if padded else \
            master_sequence_parallel
        y, info = fn(torch.from_numpy(x), sr, s, _mesh())
        y_one, info_one = master_graph(torch.from_numpy(x), sr, s)
    assert y.shape == x.shape
    others = [(y_one.numpy(), {k: float(v) for k, v in info_one.items()})]
    if case not in PORT_ONLY:
        others.append(refs[case])
    for y_other, info_other in others:
        for k in keys:
            if np.isfinite(info_other[k]) or np.isfinite(float(info[k])):
                assert abs(float(info[k]) - info_other[k]) < tol, (
                    k, float(info[k]), info_other[k])
        assert float(info["linear_mode"]) == info_other["linear_mode"]
        np.testing.assert_allclose(y.numpy(), y_other, atol=atol, rtol=5e-3)
    if case == "dynamic":                       # the gates must fail
        assert float(info["linear_mode"]) == 0.0


def test_sp_compat_without_lufs_and_silence():
    """No loudnorm: the pre stages and the sharded alimiter; silence: the
    Q9 passthrough branch (input_i -inf, linear_mode 0)."""
    from ame_tpu_torch.parallel.sp_master import master_sequence_parallel
    sr, x = _eq_input()
    s = MasterSettings(bass_boost=3.0, width=1.3, lufs=None, mode="compat")
    y, info = master_sequence_parallel(torch.from_numpy(x), sr, s, _mesh())
    y_one, _ = master_graph(torch.from_numpy(x), sr, s)
    assert info == {}
    np.testing.assert_allclose(y.numpy(), y_one.numpy(), atol=2e-3,
                               rtol=5e-3)
    z = torch.zeros_like(torch.from_numpy(x))
    y, info = master_sequence_parallel(z, sr, MasterSettings(mode="compat"),
                                       _mesh())
    assert float(info["input_i"]) == -np.inf
    assert float(info["linear_mode"]) == 0.0 and not y.any()


def test_sp_alimiter_matches_one_device():
    """tests/test_parallel.py:320-335 on the port: the exact cross-shard
    piece carries against the one-device alimiter_compat and against
    ame_tpu's sharded alimiter on its 8 devices (atol 2e-6, rtol 1e-5)."""
    from ame_tpu.parallel.sp_compat import _alimiter_sp as ref_alimiter_sp
    from ame_tpu_torch.ops.limiter import alimiter_compat
    from ame_tpu_torch.parallel.sp_compat import _alimiter_sp
    sr, n = 8000, 8 * 4000
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((n, 2)) * 0.4).astype(np.float32)
    x[n // 3: n // 3 + 600] *= 4.0          # hard limiting episode
    x[2 * n // 3] = 3.0                     # isolated spike (attack side)
    got = torch.cat(_alimiter_sp(list(torch.from_numpy(x).chunk(8)),
                                 sr)).numpy()
    one = alimiter_compat(torch.from_numpy(x), sr).numpy()
    np.testing.assert_allclose(got, one, atol=2e-6, rtol=1e-5)
    want = np.asarray(ref_alimiter_sp(jnp.asarray(x), sr, _ref_mesh(), "sp"))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_sp_compat_guards():
    """tests/test_parallel.py:423-436, plus the n_valid and short-track
    guards."""
    from ame_tpu_torch.parallel.sp_compat import (
        master_compat_sequence_parallel)
    from ame_tpu_torch.parallel.sp_master import master_sequence_parallel
    x = torch.zeros((8 * 800, 2))
    with pytest.raises(ValueError, match="whole"):    # not whole chunks
        master_sequence_parallel(
            x, 8000.0, MasterSettings(mode="compat", compat_chunked=True,
                                      lufs=None), _mesh())
    with pytest.raises(ValueError, match="quality-mode only"):
        master_sequence_parallel(
            x, 16000.0, MasterSettings(mode="compat", mb_edges=(500.0,),
                                       lufs=None), _mesh())
    x4 = torch.zeros((8 * 4000, 2))
    with pytest.raises(ValueError, match="concrete"):
        master_sequence_parallel(x4, 8000.0, MasterSettings(mode="compat"),
                                 _mesh(), n_valid=torch.tensor(8 * 4000))
    with pytest.raises(ValueError, match="3.1 s"):    # true length 2 s
        master_sequence_parallel(x4, 8000.0, MasterSettings(mode="compat"),
                                 _mesh(), n_valid=16000)
    with pytest.raises(ValueError, match="detector window"):
        master_sequence_parallel(
            torch.zeros((8 * 30, 2)), 16000.0, MasterSettings(
                mode="compat", multiband=True, lufs=None), _mesh())
    with pytest.raises(ValueError, match="mode"):
        master_compat_sequence_parallel(x, 8000.0, MasterSettings(), _mesh())

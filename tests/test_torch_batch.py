"""The port's master_batch (ame_tpu_torch.parallel.batch) on the CPU against
ame_tpu.parallel.batch.master_batch (mesh None, and a mesh of 8 devices)
and against the port's own single-track master_graph."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.graph.chain import master_graph
from ame_tpu_torch.parallel.batch import master_batch

SR = 44100
N = 1 << 15
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)


def _batch(b=2, n=N):
    rng = np.random.default_rng(11)
    scale = np.array([0.1, 0.3, 0.05, 0.2])[:b, None, None]
    return (scale * rng.standard_normal((b, n, 2))).astype(np.float32)


def test_master_batch_matches_reference():
    """[2, 2^15, 2] through both packages' master_batch: within 2e-4 (the
    quality gate of PERF.md section 2); each track equal to the port's
    master_graph on that track alone (the same chain, run B times)."""
    from ame_tpu.parallel.batch import master_batch as ref_master_batch
    xs = _batch()
    want = np.asarray(ref_master_batch(jnp.asarray(xs), float(SR), FLAGSHIP))
    got = master_batch(xs, SR, FLAGSHIP, device="cpu")
    assert got.shape == (2, N, 2) and got.device.type == "cpu"
    assert np.abs(got.numpy() - want).max() <= 2e-4
    settings = MasterSettings(**FLAGSHIP)
    for b in range(2):
        y, _ = master_graph(torch.from_numpy(xs[b]), SR, settings)
        torch.testing.assert_close(got[b], y, rtol=0, atol=0)


def test_master_batch_runs_the_quality_chain_whatever_the_mode():
    """As ame_tpu's does, the batch runs the quality chain even for compat
    settings (the mode is not part of its program)."""
    xs = _batch(1, 4096)
    a = master_batch(xs, SR, dict(FLAGSHIP, mode="compat"), device="cpu")
    b = master_batch(torch.from_numpy(xs), SR, MasterSettings(**FLAGSHIP),
                     device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_master_batch_mesh_matches_reference_and_no_mesh():
    """tests/test_parallel.py:15-30 on the port: 8 tracks of 4096 over a
    'data' axis of 8 (the CPU 8 times) against ame_tpu's master_batch on
    its 8-device mesh (the quality gate, 2e-4), bit-equal to mesh=None, and
    identical tracks give identical masters; a batch that does not split
    over the axis raises."""
    import jax
    from ame_tpu.parallel.batch import master_batch as ref_master_batch
    from ame_tpu.parallel.mesh import make_mesh as ref_make_mesh
    from ame_tpu_torch.parallel.mesh import make_mesh
    from tests.conftest import make_test_signal
    xs = np.stack([make_test_signal("noise", 4096, SR, seed=i) * 0.2
                   for i in range(8)])
    s = dict(bass_boost=1.5, lufs=-14.0, mode="quality")
    mesh = make_mesh({"data": 8}, devices=["cpu"] * 8)
    got = master_batch(xs, SR, s, mesh=mesh)
    want = np.asarray(ref_master_batch(
        jnp.asarray(xs), float(SR), s,
        mesh=ref_make_mesh({"data": 8}, devices=jax.devices()[:8])))
    assert got.shape == xs.shape and np.abs(got.numpy() - want).max() <= 2e-4
    torch.testing.assert_close(got, master_batch(xs, SR, s, device="cpu"),
                               rtol=0, atol=0)
    same = master_batch(np.stack([xs[0]] * 4), SR, s, mesh=make_mesh(
        {"data": 2}, devices=["cpu"] * 2))
    for b in range(1, 4):
        torch.testing.assert_close(same[b], same[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not split"):
        master_batch(xs[:3], SR, s, mesh=mesh)


def test_master_batch_rejects_other_shapes():
    with pytest.raises(ValueError, match=r"\[B, N, 2\]"):
        master_batch(np.zeros((1024, 2), np.float32), SR, FLAGSHIP,
                     device="cpu")


def test_master_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        master_batch(_batch(1, 1024), SR, FLAGSHIP)

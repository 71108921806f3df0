"""Training in the port against ame_tpu on the CPU: the mood CNN's
training forward, loss and gradients against flax, Adam against optax, the
dropout draw, flax-format weights written by the port, checkpoints and the
training data loader.

Tolerances: the loss and the gradients within 1e-5 of the largest entry
(float32 convolutions in both, TF32 off; the sums run in other orders);
parameters after three Adam steps within 1e-5 absolute, 1 % of one step
(lr 1e-3 moves a weight by at most ~lr a step; the update formulas agree
up to rounding, but Adam divides by sqrt(v), so an entry whose gradient is
near eps turns its float32 difference into a step difference: 2.3e-6
measured on one of 18 432 entries, the others within 1e-6).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from ame_tpu.models import mood_cnn as JC
from ame_tpu_torch import convert
from ame_tpu_torch.io.wav import write_wav
from ame_tpu_torch.models import _msgpack, checkpoint, synth_corpus
from ame_tpu_torch.models import mood_cnn as TC
from ame_tpu_torch.models import train_mood

B = 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0.0, 1.0, (B, 128, 128, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    return images, labels


def _flax_loss(params, images, labels):
    """flax's training loss with dropout off (apply(train=False))."""
    logits = JC.MoodCNN().apply({"params": params}, images, train=False)
    one_hot = jax.nn.one_hot(labels, len(JC.MOOD_CLASSES))
    return -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits), axis=-1))


def _port_model(params):
    model = TC.MoodCNN()
    model.load_state_dict(convert.mood_cnn_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


def _assert_tree_close(got: dict, want, rel):
    for layer, leaves in want.items():
        for name, w in leaves.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[layer][name], w, rtol=0,
                                       atol=rel * np.abs(w).max(),
                                       err_msg=f"{layer}/{name}")


@pytest.fixture(scope="module")
def flax_params():
    return JC.init_params(5)


def test_loss_and_grads_match_flax(flax_params):
    images, labels = _batch()
    loss_j, grads_j = jax.value_and_grad(_flax_loss)(
        flax_params, jnp.asarray(images), jnp.asarray(labels))
    model = _port_model(flax_params)
    loss, acc = TC.loss_fn(model, torch.from_numpy(images),
                           torch.from_numpy(labels).long(), dropout=0.0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert 0.0 <= acc.item() <= 1.0
    grads = convert.mood_cnn_params({k: p.grad for k, p in
                                     model.named_parameters()})
    _assert_tree_close(grads, grads_j, 1e-5)


def test_three_adam_steps_match_optax(flax_params):
    images, labels = _batch(1)
    opt = optax.adam(1e-3)
    p, state = flax_params, opt.init(flax_params)
    for _ in range(3):
        g = jax.grad(_flax_loss)(p, jnp.asarray(images), jnp.asarray(labels))
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
    model = _port_model(flax_params)
    topt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    for _ in range(3):
        topt.zero_grad()
        TC.loss_fn(model, x, y, dropout=0.0)[0].backward()
        topt.step()
    got = convert.mood_cnn_params(model.state_dict())
    for layer, leaves in p.items():
        for name, w in leaves.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(w),
                                       rtol=0, atol=1e-5)


def test_adam_state_continues_optax():
    """optax's state after two steps, carried over by convert.adam_state,
    gives optax's third step in torch.optim.Adam (on a quadratic)."""
    names = ("a", "b")
    p = {"a": jnp.asarray([1.0, -2.0, 0.5]), "b": jnp.asarray([[0.3, 4.0]])}
    target = {"a": jnp.asarray([0.1, 0.2, 0.3]), "b": jnp.asarray([[1., 1.]])}

    def loss(q):
        return sum(jnp.sum((q[k] - target[k]) ** 2 * (i + 1))
                   for i, k in enumerate(names))
    opt = optax.adam(0.05)
    state = opt.init(p)
    for _ in range(2):
        upd, state = opt.update(jax.grad(loss)(p), state, p)
        p = optax.apply_updates(p, upd)
    tp = {k: torch.tensor(np.asarray(p[k]), requires_grad=True)
          for k in names}
    topt = torch.optim.Adam(tp.values(), lr=0.05)
    topt.state.update(convert.adam_state(state, tp))
    upd, state = opt.update(jax.grad(loss)(p), state, p)
    p = optax.apply_updates(p, upd)
    tl = sum(torch.sum((tp[k] - torch.tensor(np.asarray(target[k]))) ** 2
                       * (i + 1)) for i, k in enumerate(names))
    tl.backward()
    topt.step()
    for k in names:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(p[k]),
                                   rtol=0, atol=1e-6)
    assert int(topt.state[tp["a"]]["step"]) == 3


def test_dropout_rate_scale_and_generator():
    x = torch.ones(20000, 128)
    g1 = torch.Generator().manual_seed(11)
    y = TC._dropout(x, 0.3, g1)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    y2 = TC._dropout(x, 0.3, torch.Generator().manual_seed(11))
    assert torch.equal(y, y2)
    y3 = TC._dropout(x, 0.3, torch.Generator().manual_seed(12))
    assert not torch.equal(y, y3)
    with pytest.raises(ValueError, match="torch.Generator"):
        TC._dropout(x, 0.3, None)
    # the training forward draws from the generator; inference never does
    model = TC.init_params(0)
    imgs = torch.from_numpy(_batch()[0])
    a = model(imgs, train=True, generator=torch.Generator().manual_seed(3))
    b = model(imgs, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(model(imgs), model(imgs))


def test_init_params_is_flax_lecun_normal():
    model = TC.init_params(0)
    again = TC.init_params(0)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert (p == 0).all()
        else:
            fan_in = p[0].numel()
            std = np.sqrt(1.0 / fan_in)
            bound = 2.0 * std / 0.87962566103423978
            assert p.abs().max().item() <= bound + 1e-6
            # truncated normal with variance 1/fan_in
            assert abs(p.std().item() / std - 1.0) < 0.15, name
    flax_p = JC.init_params(0)
    assert np.shape(flax_p["Conv_1"]["kernel"]) == (3, 3, 32, 64)
    assert tuple(model.convs[1].weight.shape) == (64, 32, 3, 3)


# --- weights in flax's format --------------------------------------------------

def test_msgpack_writer_matches_flax_bytes(flax_params):
    """The port writes the bytes flax.serialization.to_bytes writes."""
    tree = jax.tree_util.tree_map(np.asarray, flax_params)
    got = _msgpack.dump(convert.mood_cnn_params(
        convert.mood_cnn_state_dict(tree)))
    assert got == serialization.to_bytes(flax_params)
    with pytest.raises(ValueError, match="cannot write"):
        _msgpack.dump({"a": [1, 2]})


def test_saved_weights_load_in_both_packages(tmp_path, monkeypatch):
    model = TC.init_params(7)
    path = str(tmp_path / "w.msgpack")
    assert TC.save_params(model, path) == path
    with open(path, "rb") as f:
        restored = serialization.msgpack_restore(f.read())
    assert sorted(restored) == ["Conv_0", "Conv_1", "Conv_2", "Dense_0",
                                "Dense_1"]
    monkeypatch.setattr(JC, "_params_cache", None)
    params, trained = JC.load_params(path)
    assert trained
    np.testing.assert_array_equal(
        np.asarray(params["Dense_0"]["kernel"]),
        model.dense0.weight.detach().numpy().T)
    np.testing.assert_array_equal(
        np.asarray(params["Conv_2"]["kernel"]),
        model.convs[2].weight.detach().numpy().transpose(2, 3, 1, 0))
    ported, trained = TC.load_params(path, device="cpu")
    assert trained
    for a, b in zip(ported.state_dict().values(),
                    model.state_dict().values()):
        assert torch.equal(a, b)


# --- checkpoints -------------------------------------------------------------------

def test_train_checkpoint_roundtrip(tmp_path):
    """save -> restore reproduces the model and the optimizer state exactly
    and resumes at the next epoch; no checkpoint -> untouched, epoch 0
    (mirrors tests/test_mood_model.py's orbax test)."""
    model = TC.init_params(3)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    images, labels = _batch()
    TC.make_train_step(opt)(model, torch.from_numpy(images),
                            torch.from_numpy(labels).long(),
                            torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck")
    fresh = TC.init_params(9)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    _, _, e0 = checkpoint.restore_train_state(ck, fresh, fresh_opt)
    assert e0 == 0

    checkpoint.save_train_state(ck, 4, model, opt)
    m1, o1, e1 = checkpoint.restore_train_state(ck, fresh, fresh_opt)
    assert e1 == 5 and m1 is fresh and o1 is fresh_opt
    for a, b in zip(m1.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)
    sa, sb = o1.state_dict()["state"], opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][key], sb[i][key])


def test_checkpoints_keep_newest_three(tmp_path):
    model = TC.init_params(0)
    opt = torch.optim.Adam(model.parameters())
    ck = str(tmp_path / "ck")
    for epoch in range(5):
        checkpoint.save_train_state(ck, epoch, model, opt)
    assert sorted(os.listdir(ck)) == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]
    assert checkpoint.restore_train_state(ck, model, opt)[2] == 5


# --- the data and the trainer ------------------------------------------------------

def test_load_examples_on_labelled_directory(tmp_path):
    """The documented layout <root>/<class-name>/*.wav, as ame_tpu's
    trainer ingests it (mirrors tests/test_mood_model.py)."""
    sr = 22050
    for cls, f0 in (("Angry-Anxious", 330.0), ("Calm-Content", 110.0)):
        d = tmp_path / cls
        d.mkdir()
        t = np.arange(sr * 2) / sr
        x = (0.3 * np.sin(2 * np.pi * f0 * t)).astype(np.float32)
        write_wav(str(d / "track.wav"), np.stack([x, x], 1), sr)
    (tmp_path / "Angry-Anxious" / "notes.txt").write_text("not audio")

    examples = list(train_mood._load_examples(
        str(tmp_path), np.random.default_rng(0), per_track=2, augment=1.0))
    assert len(examples) == 4  # 2 classes x 1 track x per_track 2
    assert sorted({lab for _, lab in examples}) == [0, 1]
    for img, _ in examples:
        assert tuple(img.shape) == (128, 128, 3)
        assert torch.isfinite(img).all()
    with pytest.raises(SystemExit, match="no class directories"):
        train_mood._class_dirs(str(tmp_path / "Angry-Anxious"))


@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("strength", [1.0, 0.5])
def test_augment_matches_ame_tpu(seed, strength):
    """The augmentations are the reference's: the same draws from the same
    generator give the same segment, within 1e-5 (the tilt's FFT pair
    runs in float64 torch, the reference's numpy FFT in float32; every
    other step is the same numpy code)."""
    from ame_tpu.models.train_mood import _augment as ref
    seg = (0.3 * np.random.default_rng(1).standard_normal(22050)).astype(
        np.float32)
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    got = train_mood._augment(seg, 22050, rng_a, strength)
    want = ref(seg, 22050, rng_b, strength)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert rng_a.random() == rng_b.random()    # the same number of draws


def test_synth_corpus_matches_ame_tpu(tmp_path):
    from ame_tpu.models import synth_corpus as ref
    for cls in TC.MOOD_CLASSES:
        np.testing.assert_array_equal(
            synth_corpus.synth_track(cls, np.random.default_rng(2), 2.0),
            ref.synth_track(cls, np.random.default_rng(2), 2.0))
    assert synth_corpus.generate(str(tmp_path), per_class=1, seconds=1.0) == 4
    assert sorted(os.listdir(tmp_path)) == [
        c.replace("/", "-") for c in TC.MOOD_CLASSES]


def test_train_mood_main_trains_checkpoints_and_resumes(tmp_path):
    synth_corpus.generate(str(tmp_path / "data"), per_class=1, seconds=3.0)
    out = str(tmp_path / "w.msgpack")
    ck = str(tmp_path / "ck")
    args = [str(tmp_path / "data"), "--batch", "4", "--checkpoint-dir", ck,
            "--device", "cpu", "--out", out]
    assert train_mood.main(args + ["--epochs", "1"]) == 0
    assert os.listdir(ck) == ["ckpt_0.pt"]
    first = _msgpack.load(out)
    assert train_mood.main(args + ["--epochs", "2"]) == 0
    assert sorted(os.listdir(ck)) == ["ckpt_0.pt", "ckpt_1.pt"]
    second = _msgpack.load(out)
    assert not np.array_equal(first["Dense_1"]["kernel"],
                              second["Dense_1"]["kernel"])
    model, trained = TC.load_params(out, device="cpu")
    assert trained


def test_train_mood_refuses_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mood.main([str(tmp_path)])

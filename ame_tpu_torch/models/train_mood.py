"""Retrain the mood CNN (port of ``ame_tpu/models/train_mood.py``).

Data layout: a directory of audio files arranged as
    <root>/<class-name>/<track>.{wav,aif,aiff}
with class names from mood_cnn.MOOD_CLASSES ('/' replaced by '-', e.g.
"Angry-Anxious"). Each file becomes the same 128x128x3 normalized
mel-spectrogram image the inference path uses, with the reference's
augmentations (random 30 s offset, gain, vari-speed, spectral tilt,
background noise, soft drive).

Usage:
    python -m ame_tpu_torch.models.train_mood <data_root> [--epochs N]
        [--lr LR] [--batch B] [--out weights.msgpack]
        [--checkpoint-dir DIR] [--device cuda|cpu]

    torchrun --nproc_per_node=W -m ame_tpu_torch.models.train_mood <data_root>

Trains with ``torch.optim.Adam`` on ``--device`` (the card by default).
``main`` calls ``parallel/mesh.init_distributed``: started by torchrun (or
with its environment set) with W > 1 processes, it trains over a
{"data": W, "model": 1} mesh (``parallel/train.make_sharded_train_step``,
one card a process, NCCL; gloo with ``--device cpu``), as ``ame_tpu``'s
trainer does over its devices. Every rank loads the same examples from the
same seed and takes its rows of each global batch of ``--batch`` // W * W;
rank 0 alone logs the epochs and writes the checkpoints and the weights,
and every rank restores from the checkpoint on resume. With one process it
trains on one device with ``mood_cnn.make_train_step``. With
``--checkpoint-dir`` the model and optimizer are saved every epoch and a
restart resumes after the newest checkpoint (``models/checkpoint.py``).
The weights are written as a flax checkpoint (``mood_cnn.save_params``),
which both packages load.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ame_tpu_torch.device import resolve_device

log = logging.getLogger("ame_tpu_torch.train")


def _class_dirs(root: str) -> dict[int, str]:
    from ame_tpu_torch.models.mood_cnn import MOOD_CLASSES
    out = {}
    for i, cls in enumerate(MOOD_CLASSES):
        d = os.path.join(root, cls.replace("/", "-"))
        if os.path.isdir(d):
            out[i] = d
    if not out:
        raise SystemExit(f"no class directories found under {root} "
                         f"(expected e.g. {MOOD_CLASSES[0].replace('/','-')})")
    return out


def _augment(seg: np.ndarray, sr: int, rng: np.random.Generator,
             strength: float = 1.0, device="cpu") -> np.ndarray:
    """Augmentations that randomize everything that is not a mood cue:
    gain, vari-speed (pitch and tempo together), spectral tilt, background
    noise colour and level, and soft drive, drawing from ``rng`` in the
    reference's order. numpy on the host, but for the tilt's FFT pair,
    which runs in float64 on ``device``: the vari-speed length is
    arbitrary, and on a CPU core the pair costs ~0.3 s a 30 s segment."""
    seg = seg * rng.uniform(0.5, 1.3)
    # vari-speed +-8%: resample by index interpolation
    r = rng.uniform(1.0 - 0.08 * strength, 1.0 + 0.08 * strength)
    if abs(r - 1.0) > 1e-3:
        idx = np.arange(int(len(seg) / r)) * r
        seg = np.interp(idx, np.arange(len(seg)), seg).astype(np.float32)
    # spectral tilt: dark or bright by up to ~6 dB/octave
    s = rng.uniform(-1.2, 1.2) * strength
    if abs(s) > 0.05:
        corner = rng.uniform(500.0, 3000.0)
        x = torch.from_numpy(np.asarray(seg, np.float64)).to(device)
        f = torch.fft.rfftfreq(len(seg), 1.0 / sr, dtype=torch.float64,
                               device=device)
        g = torch.clamp((1.0 + f / corner) ** (-s), 0.1, 4.0)
        seg = torch.fft.irfft(torch.fft.rfft(x) * g, len(seg)).to(
            torch.float32).cpu().numpy()
    # background noise: white or pink-ish, -50..-28 dB
    amp = 10.0 ** (rng.uniform(-50, -28) / 20.0)
    w = rng.normal(0, 1, len(seg))
    if rng.uniform() < 0.5:
        w = np.cumsum(w)
        w -= np.linspace(w[0], w[-1], len(w))
        w /= max(np.abs(w).max(), 1e-9) * 0.3
    seg = seg + (amp * w).astype(np.float32)
    # soft drive
    d = rng.uniform(1.0, 1.0 + 1.5 * strength)
    return (np.tanh(seg * d) / d).astype(np.float32)


def _load_examples(root: str, rng: np.random.Generator,
                   per_track: int = 3, augment: float = 1.0,
                   device="cpu"):
    """Yield (image [128, 128, 3] float32 tensor on ``device``, label)
    pairs; the resample and the image run on ``device``."""
    from ame_tpu_torch.analysis import musicologist as M
    from ame_tpu_torch.io import read_audio
    from ame_tpu_torch.ops.resample import resample

    win = int(M.ANALYSIS_SECONDS * M.ANALYSIS_SR)
    for label, d in _class_dirs(root).items():
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            try:
                audio, sr = read_audio(path)
            except Exception as e:
                log.warning("skip %s: %s", path, e)
                continue
            mono = np.mean(audio, axis=1).astype(np.float32)
            y = torch.from_numpy(mono).to(device)
            if sr != M.ANALYSIS_SR:
                y = resample(y, sr, M.ANALYSIS_SR)
            y = y.cpu().numpy()
            for _ in range(per_track):
                if len(y) > win:
                    off = int(rng.integers(0, len(y) - win))
                    seg = y[off:off + win]
                else:
                    seg = y
                if augment > 0:
                    seg = _augment(seg, M.ANALYSIS_SR, rng, augment, device)
                seg = torch.from_numpy(np.ascontiguousarray(seg)).to(device)
                yield M.spectrogram_image(seg).contiguous(), label


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--out", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save model + optimizer state every epoch and "
                         "resume after the newest checkpoint on restart "
                         "(models/checkpoint.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ame_tpu_torch.models import checkpoint, mood_cnn
    from ame_tpu_torch.parallel.mesh import init_distributed, make_mesh

    started = not dist.is_initialized()
    world = init_distributed(device=args.device)
    dev = resolve_device(args.device, "training")
    if dev.type == "cuda" and world > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    lead = world == 1 or dist.get_rank() == 0
    rng = np.random.default_rng(0)
    examples = list(_load_examples(args.data_root, rng, device=dev))
    if not examples:
        raise SystemExit("no training examples found")
    images = torch.stack([e[0] for e in examples])
    labels = torch.tensor([e[1] for e in examples], dtype=torch.int64,
                          device=dev)
    log.info("loaded %d examples", len(examples))

    bsz = max(min(args.batch, len(examples)), 1)
    if world == 1:
        model = mood_cnn.init_params(0, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=args.lr)
        step = mood_cnn.make_train_step(opt)
    else:
        from ame_tpu_torch.parallel.train import make_sharded_train_step
        # each process names its own device for every rank: a rank uses
        # only its own entry
        mesh = make_mesh({"data": world, "model": 1}, devices=[dev] * world)
        init_fn, sharded_step, place_batch = make_sharded_train_step(
            mesh, learning_rate=args.lr)
        model, opt = init_fn(0)
        bsz = max(bsz // world * world, world)

        def step(model, images, labels, gen):
            return sharded_step(model, opt, *place_batch(images, labels),
                                gen)[2:]
    start_epoch = 0
    if args.checkpoint_dir:
        model, opt, start_epoch = checkpoint.restore_train_state(
            args.checkpoint_dir, model, opt)
        if start_epoch and lead:
            log.info("resumed from checkpoint at epoch %d", start_epoch - 1)
    gen = torch.Generator(device=dev).manual_seed(0)
    model.train()
    for epoch in range(start_epoch, args.epochs):
        perm = rng.permutation(len(examples))
        # the dropout stream depends on the epoch only, so a resumed run
        # draws what an uninterrupted one would
        gen.manual_seed(epoch)
        losses, accs = [], []
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(0, len(perm) - bsz + 1, bsz):
            idx = torch.from_numpy(perm[i:i + bsz]).to(dev)
            loss, acc = step(model, images[idx], labels[idx], gen)
            losses.append(loss)
            accs.append(acc)
        _sync(dev)
        secs = time.perf_counter() - t0
        loss = float(torch.stack(losses).mean())
        acc = float(torch.stack(accs).mean())
        if not lead:
            continue
        log.info("epoch %d: loss %.4f acc %.3f (%d steps, %.3f ms a step)",
                 epoch, loss, acc, len(losses), secs / len(losses) * 1e3)
        if args.checkpoint_dir:
            checkpoint.save_train_state(args.checkpoint_dir, epoch, model,
                                        opt)
    if lead:
        path = mood_cnn.save_params(model, args.out)
        log.info("saved weights to %s", path)
    if world > 1 and started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""ame_tpu_torch — the PyTorch / CUDA port of ``ame_tpu``.

A second package beside the JAX reference (``ame_tpu/``), tested against it
module by module. It imports ``torch`` and never ``jax``. It runs, on one
NVIDIA card (or on the CPU through the plain PyTorch versions):

  * both mastering chains on WAV/AIFF, file in and file out: quality
    (with the 3- or G-band multiband) and compat (unchunked or chunked);
    every Pallas kernel of ``ame_tpu`` is a hand-written CUDA kernel here
    (``csrc/cascade_scan.cu``, ``csrc/wedge_env.cu``, ``csrc/pydub_gain.cu``);
  * the Musicologist (``analysis/``): resample, STFT / mel features and
    the mood CNN with the shipped trained weights (``models/``), and the
    creative prompt built from its brief (``creative/prompts.py``);
  * streaming (``streaming.py``): ``StreamingMaster`` (the quality chain
    block by block, every filter's zi carried; on the card each cascade of
    a block is one K5 launch) and ``StreamingCompatMaster`` (30 s compat
    blocks, the compat limiter continuous across them), on
    ``device="cuda"`` by default or ``device="cpu"``;
    ``convert.streaming_state`` takes an ``ame_tpu`` streamer's state over;
  * fitting and training (``models/``): ``automaster.fit_settings`` (the
    quality sub-chain's settings by Adam; on the card every cascade runs
    K5 with a backward of two more kernels, K5 in reverse and
    ``csrc/sos_grad.cu``) and ``train_mood`` (the mood CNN's training
    loop with checkpoints, writing weights both packages load).

MP3 export, art generation and the front ends are still to be ported
(ROADMAP.md).

Entry points: ``ame_tpu_torch.api.master_file`` / ``master_array`` /
``process_audio``, ``ame_tpu_torch.graph.chain.master_graph``,
``ame_tpu_torch.analysis.musicologist.analyze_song`` / ``analyze_batch``
and ``ame_tpu_torch.StreamingMaster`` / ``StreamingCompatMaster``.
"""

__version__ = "0.1.0"

__all__ = ["StreamingMaster", "StreamingCompatMaster", "__version__"]


def __getattr__(name):
    # lazy: importing the package builds nothing and pulls in no stage
    if name in ("StreamingMaster", "StreamingCompatMaster"):
        from ame_tpu_torch import streaming
        return getattr(streaming, name)
    raise AttributeError(f"module 'ame_tpu_torch' has no attribute {name!r}")

"""ame_tpu_torch — the PyTorch / CUDA port of ``ame_tpu``.

A second package beside the JAX reference (``ame_tpu/``), tested against it
module by module. It imports ``torch`` and never ``jax``. It runs, on one
NVIDIA card (or on the CPU through the plain PyTorch versions):

  * both mastering chains, file in and file out: quality
    (with the 3- or G-band multiband) and compat (unchunked or chunked);
    every Pallas kernel of ``ame_tpu`` is a hand-written CUDA kernel here
    (``csrc/cascade_scan.cu``, ``csrc/wedge_env.cu``, ``csrc/pydub_gain.cu``);
    ``graph.chain.master_graph_fused`` runs the whole chain as one CUDA
    graph, its data-dependent branches conditional nodes decided on the
    card (``ops/_branch.py``, ``csrc/graph_if.cu``);
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

  * the product surfaces: the command line (``python -m ame_tpu_torch
    master|analyze|measure|automaster|serve|gui|profile|fleet
    [--device cuda|cpu]``, ``cli.py``), the HTTP server
    (``serve/server.py``: jobs on the card, one worker thread a card by
    default) and the desktop GUI (``gui.py`` over the headless
    ``gui_logic.GuiController``); the codecs (``io/``: MP3 through LAME /
    mpg123, FLAC, and the FFmpeg shim where it builds; the C++ shims in
    ``io/native/`` are compiled with ``g++`` into ``_build/`` at first use)
    and ``process_audio``'s MP3 and cover-art sidecars
    (``creative/art.py``, ``creative/procedural.py``);
  * fleet mastering (``parallel/``): ``fleet.run_fleet`` (a directory,
    resumable from a manifest, decoded ahead by the native prefetch loader
    ``io/loader.py``) and ``batch.master_batch`` (B same-length tracks on
    one device); the profiler (``utils/profiler.profile_master``, a
    torch.profiler Chrome trace through ``utils/telemetry.profile_trace``);
    the real-FFmpeg golden harness (``io/avfilter.py``) and the mood CNN's
    evaluation corpora (``models/oof_corpus.py``, ``oof2_corpus.py``).

The multi-device paths are still to be ported (ROADMAP.md).

Entry points: ``ame_tpu_torch.api.master_file`` / ``master_array`` /
``process_audio``, ``ame_tpu_torch.graph.chain.master_graph`` /
``master_graph_fused``,
``ame_tpu_torch.analysis.musicologist.analyze_song`` / ``analyze_batch``,
``ame_tpu_torch.StreamingMaster`` / ``StreamingCompatMaster``,
``ame_tpu_torch.serve.server.make_server`` / ``run_server``,
``ame_tpu_torch.parallel.fleet.run_fleet``,
``ame_tpu_torch.parallel.batch.master_batch``,
``ame_tpu_torch.utils.profiler.profile_master``,
``ame_tpu_torch.gui.run_gui`` and ``ame_tpu_torch.cli.main``.
"""

__version__ = "0.1.0"

__all__ = ["StreamingMaster", "StreamingCompatMaster", "__version__"]


def __getattr__(name):
    # lazy: importing the package builds nothing and pulls in no stage
    if name in ("StreamingMaster", "StreamingCompatMaster"):
        from ame_tpu_torch import streaming
        return getattr(streaming, name)
    raise AttributeError(f"module 'ame_tpu_torch' has no attribute {name!r}")

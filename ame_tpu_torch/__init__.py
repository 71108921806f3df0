"""ame_tpu_torch — the PyTorch / CUDA port of ``ame_tpu``.

A second package beside the JAX reference (``ame_tpu/``), tested against it
module by module. It imports ``torch`` and never ``jax``. Today it runs the
quality mastering chain on WAV/AIFF, file in and file out, on one NVIDIA
card (or on the CPU through the plain PyTorch versions); its one
hand-written CUDA kernel, ``csrc/cascade_scan.cu``, runs every IIR cascade
of the chain. ROADMAP.md lists what is still to be ported.

Entry points: ``ame_tpu_torch.api.master_file`` / ``master_array`` /
``process_audio`` and ``ame_tpu_torch.graph.chain.master_graph``.
"""

__version__ = "0.1.0"

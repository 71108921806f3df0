"""Benchmark of the PyTorch and CUDA port (``ame_tpu_torch``) on one NVIDIA
H100: file-to-file mastering through ``ame_tpu_torch.api.master_file``.
Run as ``python3 cudabench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout."""

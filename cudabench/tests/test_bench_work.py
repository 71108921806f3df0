"""The cascade-work count (``work/cascade.py``) equals the K5 launches that
a master makes, shape for shape: on the CPU every cascade the chain runs is
recorded at ``scan_iir.sosfilt``, where on the card each is one launch of
``sosfilt_cuda`` (at most 8 sections a cascade)."""

import json
import sys

import numpy as np
import torch

from ame_tpu_torch import api
from ame_tpu_torch.ops import scan_iir
from cudabench.spec import Spec
from cudabench.work import cascade


def test_work_matches_the_launch_shapes(tmp_path, monkeypatch):
    spec = Spec()
    seen = []
    real = scan_iir.sosfilt

    def counting(sos, x, *args, **kwargs):
        k = np.asarray(sos).shape[0]
        assert k <= 8            # one launch a call on the card
        seen.append((k, tuple(x.shape)))
        return real(sos, x, *args, **kwargs)

    for name, mod in list(sys.modules.items()):
        if name.startswith("ame_tpu_torch.") and \
                getattr(mod, "sosfilt", None) is real:
            monkeypatch.setattr(mod, "sosfilt", counting)
    for w in spec.benchmark["workloads"]:
        config = spec.config(w["config"])
        n = 44100 * 5 + 17
        rng = np.random.default_rng(3)
        pcm = (rng.standard_normal((n, 2)) * 3000).astype(np.int16)
        seen.clear()
        api.master_array(pcm, 44100, str(tmp_path / "o.wav"),
                         config["settings"], device="cpu")
        assert [(c["sections"], (n, c["channels"]))
                for c in config["cascades"]] == seen
        assert cascade.bytes_for(config, n) == sum(
            2 * shape[0] * shape[1] * 4 for _, shape in seen)
        assert cascade.kernel_names(config)


def test_kernel_names_are_the_cascade_kernels():
    src = (Spec().dir.parent / "ame_tpu_torch" / "csrc" /
           "cascade_scan.cu").read_text()
    config = json.loads((Spec().dir / "configs" /
                         "quality_flagship_nolufs.json").read_text())
    for name in cascade.kernel_names(config):
        assert f"{name}(" in src.replace("\n    ", "")
    assert torch.float32.itemsize == cascade.F32

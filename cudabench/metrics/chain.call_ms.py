"""Mean host ms a track of ``ame_tpu_torch.graph.chain.master_graph``, the
staged chain: its launches and the host reads inside it, over the window's
calls of a traced run."""

from cudabench.metrics import _spans


def read(run):
    return _spans.mean_ms(run, "chain")

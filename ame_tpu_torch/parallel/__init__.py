"""Parallel and fleet mastering, and sharded training (port of
``ame_tpu/parallel/``).

Ported: ``fleet`` (a directory of tracks with a resumable manifest),
``batch`` (``master_batch``: B same-length tracks, optionally split over a
mesh's 'data' axis), ``stacked`` (``master_batch_stacked``: B tracks as
one [N, 2B] signal), ``mesh`` (``make_mesh``, ``init_distributed``),
``sequence`` (``sosfilt_sequence_parallel``), ``sp_master`` /
``sp_compat`` (one track sharded over a mesh's time axis, quality and
compat), ``bands`` (one multiband band a device) and ``train`` (the mood
CNN's data x tensor-parallel training step). The mastering paths run in
one process, shard i on mesh device i; the training step runs one process
a rank over ``torch.distributed``.
"""

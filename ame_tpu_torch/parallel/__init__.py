"""Parallel and fleet mastering (port of ``ame_tpu/parallel/``).

Ported: ``fleet`` (a directory of tracks with a resumable manifest),
``batch`` (``master_batch``: B same-length tracks, optionally split over a
mesh's 'data' axis), ``mesh`` (``make_mesh``), ``sequence``
(``sosfilt_sequence_parallel``), ``sp_master`` / ``sp_compat`` (one track
sharded over a mesh's time axis, quality and compat) and ``bands`` (one
multiband band a device). The multi-device paths run in one process,
shard i on mesh device i. The multi-process pieces of ``ame_tpu.parallel``
(``mesh.init_distributed``, ``train``) are not ported yet.
"""

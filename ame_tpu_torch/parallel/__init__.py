"""Parallel and fleet mastering (port of ``ame_tpu/parallel/``).

Ported: ``fleet`` (a directory of tracks with a resumable manifest) and
``batch`` (``master_batch``: B same-length tracks, the single-track chain
B times on one device). The multi-device modules of ``ame_tpu.parallel``
(mesh, sequence, sp_master, sp_compat, bands, train) are not ported yet.
"""

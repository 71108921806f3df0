"""The port's serving layer (ame_tpu_torch.serve.server) against a live
in-process server on the CPU (make_server(device="cpu")): the reference
web client's endpoint contract, the counterparts of tests/test_serve.py's
cases, and the served master and /measure against ame_tpu's."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ame_tpu_torch.creative import art
from ame_tpu_torch.io import codecs
from ame_tpu_torch.io.wav import read_wav, write_wav
from ame_tpu_torch.serve import server as S
from tests.conftest import make_test_signal

SR = 44100
FLAGSHIP = dict(analog_character=20.0, bass_boost=2.0, presence_boost=1.5,
                width=1.2, lufs=-14.0)


def _start(tmp_path, name="srv", **kw):
    srv, store = S.make_server(host="127.0.0.1", port=0,
                               workdir=str(tmp_path / name), device="cpu",
                               **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, store, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv, store, base = _start(tmp_path_factory.mktemp("serve"))
    yield base
    srv.shutdown()


def _post(base, path, payload, headers=None):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json",
                                  **(headers or {})})
    return json.loads(urllib.request.urlopen(req).read())


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path).read())


def _upload(base, path, name=None):
    r = _post(base, "/generate-upload-url",
              {"filename": name or os.path.basename(path),
               "contentType": "audio/wav"})
    with open(path, "rb") as f:
        req = urllib.request.Request(base + r["url"], f.read(), method="PUT")
        put = json.loads(urllib.request.urlopen(req).read())
    assert put["ok"]
    return r


def _run_job(base, tmp_path, name, settings, n=4096, x=None):
    p = str(tmp_path / name)
    write_wav(p, make_test_signal("noise", n, SR) * 0.2 if x is None else x,
              SR)
    r = _upload(base, p)
    r2 = _post(base, "/start-processing",
               {"gcs_uri": r["gcs_uri"], "settings": settings})
    return r2["processed_filename"], r2["image_filename"]


def _wait_done(base, audio, image, deadline_s=240):
    deadline = time.time() + deadline_s
    st = {"status": "processing"}
    while time.time() < deadline and st["status"] == "processing":
        st = _get(base, f"/status?audio_filename={audio}"
                        f"&image_filename={image}")
        time.sleep(0.2)
    return st


def test_full_flow(server, tmp_path):
    r = _post(server, "/generate-upload-url",
              {"filename": "in.wav", "contentType": "audio/wav"})
    assert r["url"].startswith("/upload/")
    assert r["gcs_uri"].startswith("local://")
    a, i = _run_job(server, tmp_path, "in.wav",
                    {"bass_boost": 1.0, "lufs": None, "create_mp3": False})
    assert a.endswith("_mastered.wav")
    st = _wait_done(server, a, i)
    assert st["status"] == "done", st
    assert st["progress"] == [5, 5] and "mp3_url" not in st
    blob = urllib.request.urlopen(server + st["download_url"]).read()
    assert blob[:4] == b"RIFF"


def test_served_master_matches_reference(server, tmp_path):
    """The served WAV (flagship settings, -14 LUFS) within +-1 LSB of
    ame_tpu.api.master_file on the same 2^16-sample WAV, as
    tests/test_torch_chain.py holds master_file."""
    from ame_tpu.api import master_file as ref_master_file
    x = make_test_signal("noise", 1 << 16, SR) * 0.3
    a, i = _run_job(server, tmp_path, "flag.wav",
                    dict(FLAGSHIP, create_mp3=False), x=x)
    src = str(tmp_path / "flag.wav")
    ref_out = str(tmp_path / "ref.wav")
    ref_master_file(src, ref_out, FLAGSHIP)
    st = _wait_done(server, a, i)
    assert st["status"] == "done", st
    got = str(tmp_path / "got.wav")
    with open(got, "wb") as f:
        f.write(urllib.request.urlopen(server + st["download_url"]).read())
    y, sr = read_wav(got, prefer_int16=True)
    y_ref, _ = read_wav(ref_out, prefer_int16=True)
    assert sr == SR and y.shape == y_ref.shape == (1 << 16, 2)
    assert np.abs(y.astype(np.int32) - y_ref.astype(np.int32)).max() <= 1


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_large_upload_streams_to_disk(server):
    """A 120 MB PUT is streamed to its blob in 1 MiB chunks, not read into
    memory."""
    r = _post(server, "/generate-upload-url", {"filename": "big.bin"})
    size = 120 * 1024 * 1024

    class Body:
        def __init__(self, n):
            self.left = n
            self.chunk = b"\x5a" * (1 << 20)

        def read(self, n=-1):
            if self.left <= 0:
                return b""
            take = min(len(self.chunk), self.left if n < 0 else n)
            self.left -= take
            return self.chunk[:take]

    rss0 = _rss_bytes()
    req = urllib.request.Request(server + r["url"], Body(size), method="PUT")
    req.add_header("Content-Length", str(size))
    resp = json.loads(urllib.request.urlopen(req).read())
    assert resp == {"ok": True, "bytes": size}
    assert _rss_bytes() - rss0 < 60 * 1024 * 1024


def test_oversize_upload_rejected(tmp_path):
    srv, store, base = _start(tmp_path, "cap")
    store.max_upload_bytes = 1024
    try:
        r = _post(base, "/generate-upload-url", {"filename": "big.bin"})
        req = urllib.request.Request(base + r["url"], b"x" * 4096,
                                     method="PUT")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 413
        assert not os.path.exists(
            store.upload_path(r["url"].rsplit("/", 1)[-1]))
    finally:
        srv.shutdown()


def test_status_unknown_job(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/status?audio_filename=bogus.wav")
    assert e.value.code == 404


def test_start_without_upload(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/start-processing",
              {"gcs_uri": "local://missing.wav", "settings": {}})
    assert e.value.code == 404


def test_web_ui_equals_reference(server):
    """The served page is ame_tpu's web UI, byte for byte."""
    from ame_tpu.serve.server import _web_ui as ref_web_ui
    html = urllib.request.urlopen(server + "/").read().decode()
    assert html == ref_web_ui() == S._web_ui()
    for control in ("bass_boost", "multiband", "art_prompt",
                    "auto_generate_prompt", "create_mp3"):
        assert f'id="{control}"' in html


def test_healthz_and_metrics(server):
    h = _get(server, "/healthz")
    assert h["ok"] is True and "queue_depth" in h
    m = _get(server, "/metrics")
    assert isinstance(m["jobs_by_status"], dict) and "queue_depth" in m
    assert m["host_rss_mb"] > 0
    assert m["devices"] == []           # no card touched on this host
    assert set(m["jobs_by_device"]) <= {"cpu"}


def test_measure_endpoint_matches_reference(server, tmp_path):
    """POST /measure: the loudnorm pass-1 stats within 0.01 of
    ame_tpu.ops.loudnorm.loudnorm_pass1 on the same upload; 404 for an
    unknown blob."""
    import jax.numpy as jnp
    from ame_tpu.ops.loudnorm import loudnorm_pass1 as ref_pass1
    x = make_test_signal("noise", SR * 4, SR) * 0.1
    p = str(tmp_path / "m.wav")
    write_wav(p, x, SR)
    r = _upload(server, p)
    stats = _post(server, "/measure", {"gcs_uri": r["gcs_uri"]})
    pcm, _ = read_wav(p)
    ref = ref_pass1(jnp.asarray(pcm), SR, target_i=-14.0)
    assert set(stats) == set(ref) | {"sample_rate", "target_i"}
    for k, v in ref.items():
        assert abs(stats[k] - round(float(v), 2)) <= 0.01 + 1e-9, k
    assert stats["sample_rate"] == SR and stats["target_i"] == -14.0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/measure", {"gcs_uri": "local://nope.wav"})
    assert e.value.code == 404


def test_mp3_sidecar_and_mp3_upload(server, tmp_path):
    """create_mp3 writes the V0 sidecar (status carries mp3_url, the MP3
    decodes to the master's length within the encoder's padding), and an
    MP3 upload masters like a WAV."""
    if not (codecs.have_mp3_encode() and codecs.have_mp3_decode()):
        pytest.skip("no libmp3lame / libmpg123")
    a, i = _run_job(server, tmp_path, "s.wav",
                    {"lufs": None, "create_mp3": True}, n=1 << 14)
    st = _wait_done(server, a, i)
    assert st["status"] == "done", st
    mp3 = str(tmp_path / "s.mp3")
    with open(mp3, "wb") as f:
        f.write(urllib.request.urlopen(server + st["mp3_url"]).read())
    y, _ = codecs.decode_mp3(mp3)
    assert abs(len(y) - (1 << 14)) < 5000

    r = _upload(server, mp3, "up.mp3")
    r2 = _post(server, "/start-processing",
               {"gcs_uri": r["gcs_uri"],
                "settings": {"lufs": -14.0, "create_mp3": False}})
    st = _wait_done(server, r2["processed_filename"], r2["image_filename"])
    assert st["status"] == "done", st


def test_multiband_and_art_settings_reach_graph(tmp_path, monkeypatch):
    """Multiband and art settings POSTed over HTTP drive the job: they are
    recorded on it, the multiband master differs from a plain one, and the
    art prompt (procedural provider) yields a 1024x1024 PNG at art_url."""
    monkeypatch.setattr(art, "_try_register_vertex", lambda: None)
    monkeypatch.setattr(art, "_providers", {})
    monkeypatch.setattr(art, "_active", None)
    monkeypatch.setenv("AME_TPU_ART_PROVIDER", "procedural")
    srv, store, base = _start(tmp_path, workers=2)
    try:
        mb = {"multiband": True, "low_thresh": -35.0, "low_ratio": 8.0,
              "mid_thresh": -30.0, "mid_ratio": 6.0,
              "high_thresh": -30.0, "high_ratio": 8.0,
              "mode": "compat", "lufs": None, "create_mp3": False,
              "art_prompt": "a serene mountain at dusk",
              "auto_generate_prompt": False}
        a1, i1 = _run_job(base, tmp_path, "one.wav", mb)
        a2, i2 = _run_job(base, tmp_path, "one.wav",
                          {"lufs": None, "mode": "compat",
                           "create_mp3": False})
        st1, st2 = _wait_done(base, a1, i1), _wait_done(base, a2, i2)
        assert st1["status"] == "done", st1
        assert st2["status"] == "done", st2
        job = store.job_snapshot(a1)
        assert job["settings"]["multiband"] is True
        assert job["settings"]["low_ratio"] == 8.0
        assert job["settings"]["art_prompt"] == "a serene mountain at dusk"
        assert job["tag"] == "Using manual prompt."
        assert "Success: AI art generation complete!" in job["messages"]
        assert st1["art_url"] == f"/art/{i1}" and "art_url" not in st2
        png = urllib.request.urlopen(base + st1["art_url"]).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert png[16:24] == (1024).to_bytes(4, "big") * 2   # IHDR w, h
        y1, _ = read_wav(store.output_path(a1))
        y2, _ = read_wav(store.output_path(a2))
        assert np.abs(y1 - y2).max() > 1e-4
    finally:
        srv.shutdown()


def test_job_persistence_and_requeue(tmp_path):
    """Jobs survive a restart: done stays done, a job interrupted while
    processing is requeued and completes on the worker's device, one whose
    input is gone becomes an error."""
    workdir = str(tmp_path / "srv")
    store = S.JobStore(workdir)
    store.jobs["done_mastered.wav"] = {"status": "done", "messages": [],
                                       "progress": [5, 5], "tag": "",
                                       "art_file": None}
    up = store.upload_path("abc_in.wav")
    write_wav(up, make_test_signal("noise", 4096, SR) * 0.2, SR)
    out = store.output_path("in_mastered.wav")
    store.jobs["in_mastered.wav"] = {
        "status": "processing", "messages": [], "progress": [1, 5],
        "tag": "", "art_file": None,
        "settings": {"input_file": up, "output_file": out,
                     "lufs": None, "create_mp3": False}}
    store.jobs["lost_mastered.wav"] = {
        "status": "processing", "messages": [], "progress": [1, 5],
        "tag": "", "art_file": None,
        "settings": {"input_file": str(tmp_path / "gone.wav"),
                     "output_file": "x"}}
    store.persist()

    store2 = S.JobStore(workdir)
    assert store2.jobs["done_mastered.wav"]["status"] == "done"
    assert store2.jobs["lost_mastered.wav"]["status"] == "error"
    assert store2.queue.qsize() == 1
    threading.Thread(target=S._worker_loop,
                     args=(store2, torch.device("cpu")), daemon=True).start()
    deadline = time.time() + 240
    while (time.time() < deadline
           and store2.job_status("in_mastered.wav") == "processing"):
        time.sleep(0.2)
    assert store2.job_status("in_mastered.wav") == "done"
    assert store2.job_snapshot("in_mastered.wav")["device"] == "cpu"
    assert os.path.exists(out)


def test_gc_expired_jobs_and_orphan_uploads(tmp_path):
    """TTL GC drops finished jobs with their blobs and orphaned uploads,
    never processing jobs, fresh files or inputs a live job shares."""
    store = S.JobStore(str(tmp_path), ttl_s=100.0)
    now = time.time()

    def blob(path):
        with open(path, "wb") as f:
            f.write(b"x")
        return path

    old_in = blob(os.path.join(store.uploads, "old_in.wav"))
    old_out = blob(store.output_path("old_mastered.wav"))
    old_mp3 = blob(store.output_path("old_mastered.mp3"))
    store.create_job("old_mastered.wav", {
        "status": "done", "created": now - 1000,
        "settings": {"input_file": old_in}})
    live_in = blob(os.path.join(store.uploads, "live_in.wav"))
    live_out = blob(store.output_path("live_mastered.wav"))
    store.create_job("live_mastered.wav", {
        "status": "processing", "created": now - 1000,
        "settings": {"input_file": live_in}})
    fresh_out = blob(store.output_path("fresh_mastered.wav"))
    store.create_job("fresh_mastered.wav", {
        "status": "done", "created": now, "settings": {"input_file": ""}})
    orphan = blob(os.path.join(store.uploads, "orphan.wav"))
    os.utime(orphan, (now - 1000, now - 1000))

    assert store.gc_expired(now=now) == 1
    assert store.job_status("old_mastered.wav") is None
    for p in (old_out, old_mp3, old_in, orphan):
        assert not os.path.exists(p)
    assert store.job_status("live_mastered.wav") == "processing"
    assert os.path.exists(live_out) and os.path.exists(live_in)
    assert os.path.exists(fresh_out)
    assert "old_mastered.wav" not in S.JobStore(str(tmp_path)).jobs

    shared = blob(os.path.join(store.uploads, "shared.wav"))
    store.create_job("a_mastered.wav", {
        "status": "done", "created": now - 1000,
        "settings": {"input_file": shared}})
    store.create_job("b_mastered.wav", {
        "status": "processing", "created": now,
        "settings": {"input_file": shared}})
    assert store.gc_expired(now=now) == 1
    assert os.path.exists(shared)


def test_resolve_input_and_gcs_stub(tmp_path):
    """local:// uploads resolve, unknown ones and gs:// without a backend
    do not; through a stub GCS backend the upload URL, the fetch and the
    GC's bucket delete are delegated."""
    store = S.JobStore(str(tmp_path / "a"))
    url, uri = store.new_upload("track.wav")
    assert url.startswith("/upload/") and uri.startswith("local://")
    with open(store.upload_path(uri.split("://", 1)[-1]), "wb") as f:
        f.write(b"data")
    assert store.resolve_input(uri) == store.upload_path(
        uri.split("://", 1)[-1])
    assert store.resolve_input("local://missing.wav") is None
    assert store.resolve_input("gs://bucket/uploads/x.wav") is None

    class StubGCS:
        def __init__(self):
            self.objects, self.deleted = {}, []

        def new_upload(self, filename):
            uri = f"gs://bkt/uploads/{filename}"
            self.objects[uri] = b"pcm"
            return f"https://signed/{filename}", uri

        def fetch_to(self, uri, dest):
            if uri not in self.objects:
                raise FileNotFoundError(uri)
            with open(dest, "wb") as f:
                f.write(self.objects[uri])
            return True

        def delete(self, uri):
            self.deleted.append(uri)

    store = S.JobStore(str(tmp_path / "b"), ttl_s=100.0)
    store.gcs = StubGCS()
    url, uri = store.new_upload("track.wav")
    assert url.startswith("https://signed/") and uri.startswith("gs://")
    local = store.resolve_input(uri)
    assert local and os.path.exists(local)
    assert store.resolve_input("gs://bkt/uploads/missing.wav") is None
    store.create_job("track_mastered.wav", {
        "status": "done", "created": time.time() - 1000,
        "settings": {"input_file": local, "gcs_uri": uri}})
    assert store.gc_expired() == 1
    assert store.gcs.deleted == [uri] and not os.path.exists(local)


def test_auth_and_quota(tmp_path, monkeypatch):
    """AME_TPU_SERVE_TOKEN gates mutating endpoints (401), reads stay open;
    AME_TPU_SERVE_QUOTA caps in-flight jobs per client (429)."""
    monkeypatch.setenv("AME_TPU_SERVE_TOKEN", "s3cret")
    monkeypatch.setenv("AME_TPU_SERVE_QUOTA", "1")
    srv, store, base = _start(tmp_path, workers=1)
    auth = {"Authorization": "Bearer s3cret"}
    try:
        for hdr in ({}, {"Authorization": "Bearer wrong"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/generate-upload-url", {"filename": "x.wav"},
                      hdr)
            assert ei.value.code == 401
        r = _post(base, "/generate-upload-url", {"filename": "in.wav"}, auth)
        put = urllib.request.Request(base + r["url"], b"data", method="PUT")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(put)
        assert ei.value.code == 401
        p = str(tmp_path / "in.wav")
        write_wav(p, make_test_signal("noise", 4096, SR) * 0.2, SR)
        with open(p, "rb") as f:
            urllib.request.urlopen(urllib.request.Request(
                base + r["url"], f.read(), method="PUT", headers=auth)).read()
        store.create_job("other_mastered.wav", {
            "status": "processing", "messages": [], "progress": [0, 1],
            "tag": "", "art_file": None, "settings": {},
            "created": time.time(), "client": "127.0.0.1"})
        start = {"gcs_uri": r["gcs_uri"],
                 "settings": {"lufs": None, "create_mp3": False}}
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/start-processing", start, auth)
        assert ei.value.code == 429
        store.update_job("other_mastered.wav", status="done")
        r2 = _post(base, "/start-processing", start, auth)
        st = _wait_done(base, r2["processed_filename"], r2["image_filename"])
        assert st["status"] == "done", st
    finally:
        srv.shutdown()


def test_quota_reservation_is_atomic(tmp_path):
    """16 simultaneous reservations against a quota of 2 from one client:
    exactly 2 pass (check and insert under one lock hold)."""
    store = S.JobStore(str(tmp_path / "q"), ttl_s=3600)
    n, quota = 16, 2
    barrier = threading.Barrier(n)
    results = [None] * n

    def go(i):
        barrier.wait()
        results[i] = store.create_job_within_quota(
            f"j{i}_mastered.wav",
            {"status": "processing", "client": "c", "messages": []},
            "c", quota)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert sum(bool(r) for r in results) == quota
    assert store.active_jobs_for("c") == quota
    assert store.create_job_within_quota(
        "other_mastered.wav", {"status": "processing", "client": "d"},
        "d", quota)


def test_concurrent_load(tmp_path):
    """8 clients upload, start, poll and download at once against 3 workers
    with the quota active: every job done exactly once, on its worker's
    device, and the manifest on disk carries them all."""
    srv, store, base = _start(tmp_path, "load", workers=3)
    store.client_quota = 8
    n = 8
    results = [None] * n
    barrier = threading.Barrier(n)

    def client(i):
        try:
            p = str(tmp_path / f"in_{i}.wav")
            write_wav(p, make_test_signal("noise", 4096, SR, seed=i) * 0.2,
                      SR)
            barrier.wait(timeout=60)
            r = _upload(base, p, f"load{i}.wav")
            r2 = _post(base, "/start-processing",
                       {"gcs_uri": r["gcs_uri"],
                        "settings": {"bass_boost": 1.0, "lufs": None,
                                     "create_mp3": False}})
            st = _wait_done(base, r2["processed_filename"],
                            r2["image_filename"])
            assert st["status"] == "done", (i, st)
            blob = urllib.request.urlopen(base + st["download_url"]).read()
            assert blob[:4] == b"RIFF"
            results[i] = r2["processed_filename"]
        except Exception as e:  # noqa: BLE001 — surfaced via results
            results[i] = e

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not [r for r in results if not isinstance(r, str)], results
        assert len(set(results)) == n
        for name in results:
            snap = store.job_snapshot(name)
            terminal = [m for m in snap["messages"]
                        if m.startswith(("Success:", "Error:", "Failed:"))]
            assert snap["status"] == "done" and len(terminal) == 1, snap
            assert snap["device"] == "cpu"
        with open(os.path.join(store.workdir, "jobs.json")) as f:
            persisted = json.load(f)
        assert all(persisted[name]["status"] == "done" for name in results)
    finally:
        srv.shutdown()


def test_serve_devices(monkeypatch):
    """device="cuda" raises where there is no card, and make_server starts
    nothing then; with cards, one cuda:i each, capped by
    AME_TPU_SERVE_DEVICES; "cpu" only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S._serve_devices("cuda")
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_server(port=0)
    assert threading.active_count() == threads
    assert S._serve_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert S._serve_devices() == [torch.device(f"cuda:{i}")
                                  for i in range(4)]
    monkeypatch.setenv("AME_TPU_SERVE_DEVICES", "3")
    assert S._serve_devices("cuda") == [torch.device(f"cuda:{i}")
                                        for i in range(3)]


def test_shard_time_job_runs_the_sharded_chain(tmp_path, monkeypatch):
    """settings.shard_time masters on the sp path (the worker's pool: the
    CPU once, under the process's shard_time lock), with no degrade
    warning, and equals the same job without shard_time within 2e-3."""
    from ame_tpu_torch import api
    from ame_tpu_torch.io.wav import read_wav

    class Recording:
        def __init__(self):
            self.lock, self.entered = threading.Lock(), 0

        def __enter__(self):
            self.lock.acquire()
            self.entered += 1

        def __exit__(self, *exc):
            self.lock.release()

    lock = Recording()
    monkeypatch.setattr(api, "_shard_time_lock", lock)
    srv, store, base = _start(tmp_path, workers=1)
    try:
        x = make_test_signal("noise", 4096 * 8, SR) * 0.2
        settings = {"bass_boost": 1.5, "lufs": None, "create_mp3": False}
        a, i = _run_job(base, tmp_path, "sp.wav",
                        dict(settings, shard_time=True), x=x)
        st = _wait_done(base, a, i)
        assert st["status"] == "done", st
        msgs = store.job_snapshot(a)["messages"]
        assert not any(m.startswith("Warning:") for m in msgs), msgs
        assert ("Running time-sharded mastering graph over 1 devices..."
                in msgs)
        assert "Running mastering graph on device..." not in msgs
        assert lock.entered == 1
        b, j = _run_job(base, tmp_path, "one.wav", settings, x=x)
        st_one = _wait_done(base, b, j)
        assert st_one["status"] == "done", st_one
        outs = []
        for name, done in ((a, st), (b, st_one)):
            path = tmp_path / ("got_" + name)
            path.write_bytes(urllib.request.urlopen(
                base + done["download_url"]).read())
            outs.append(read_wav(str(path))[0])
        np.testing.assert_allclose(outs[0], outs[1], atol=2e-3)
    finally:
        srv.shutdown()


def test_shard_time_job_degrades_to_one_device(tmp_path):
    """A shard_time job the sharded chain cannot take (compat loudnorm on
    a track under 3.1 s) masters on the worker's one device after the
    reference's exact degrade warning."""
    srv, store, base = _start(tmp_path, workers=1)
    try:
        a, i = _run_job(base, tmp_path, "sp.wav",
                        {"mode": "compat", "lufs": -14.0, "shard_time": True,
                         "create_mp3": False}, n=4096 * 8)
        st = _wait_done(base, a, i)
        assert st["status"] == "done", st
        msgs = store.job_snapshot(a)["messages"]
        warn = [m for m in msgs if m.startswith("Warning: time-sharding")]
        assert warn == ["Warning: time-sharding unavailable (compat "
                        "loudnorm needs >= 3.1 s of audio (the controller's "
                        "priming window); use the single-chip graph for "
                        "short tracks); falling back to one device."], msgs
        assert msgs.index(warn[0]) < msgs.index(
            "Running mastering graph on device...")
        blob = urllib.request.urlopen(base + st["download_url"]).read()
        assert blob[:4] == b"RIFF"
    finally:
        srv.shutdown()

"""HTTP serving layer satisfying the reference web client's implied contract
(templates/index.html — SURVEY.md C19, §3.5):

    POST /generate-upload-url {filename, contentType}
        -> {"url": <signed upload url>, "gcs_uri": <opaque input id>}
    PUT  <signed upload url>           (raw file body)
    POST /start-processing {gcs_uri, settings}
        -> {"processed_filename": ..., "image_filename": ...}
    GET  /status?audio_filename=..&image_filename=..
        -> {"status": "processing"} | {"status": "done",
            "download_url": ..., "art_url": ...} | {"status": "error", ...}
    GET  /download/<name>, /art/<name>, /  (web UI)

Port of ``ame_tpu/serve/server.py``. Jobs master on the card: each worker
thread is bound to one CUDA device (``_serve_devices``), passes it to
``process_audio`` and runs under ``torch.cuda.device``; the server refuses
to start where no card is present unless the caller asks for the CPU
(``make_server(device="cpu")``, which the tests use). ``/measure`` runs
``ops.loudnorm.loudnorm_pass1`` on the server's first device.

Implementation: Python stdlib ThreadingHTTPServer; local-disk object store
standing in for GCS signed URLs (set AME_TPU_SERVE_GCS_BUCKET to issue
real V4 signed PUT URLs against a bucket instead — GCSBlobBackend; any
backend failure degrades to the local store); a pool of worker threads
drains a job queue (jobs run the same ``process_audio`` orchestration as
the desktop path, so the serving tier inherits the degrade-and-continue
error policy). Jobs are asynchronous exactly like the implied App Engine
backend — the client polls /status (index.html:291-334 behavior). A
janitor thread expires done/error jobs and their blobs after
AME_TPU_SERVE_TTL_S (default 24 h).

Concurrency: every job-state mutation and read goes through lock-guarded
JobStore methods (worker callbacks fire on worker threads while request
threads read and persist() serializes). Downloads stream in chunks
instead of whole-file reads.

The served page mirrors the reference UI's full control set
(index.html:188-202: 7 main sliders + multiband toggle with 6 band
sliders; :39-42 art-prompt textarea + auto-generate toggle; MP3 toggle;
progress bar; art rendering on done :360-380) with original markup.
"""

from __future__ import annotations

import contextlib
import hmac
import json
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ame_tpu_torch.device import resolve_device

log = logging.getLogger("ame_tpu_torch.serve")

_DOWNLOAD_CHUNK = 256 * 1024


class GCSBlobBackend:
    """Real GCS signed-URL backend for the reference contract
    (index.html:251-268: POST /generate-upload-url returns a V4 signed PUT
    URL + a gs:// uri; the job later reads the object server-side).

    Requires google-cloud-storage and signing credentials; constructed
    lazily only when AME_TPU_SERVE_GCS_BUCKET is set, and any failure
    falls back to the local-disk store (degrade-and-continue, the
    project-wide error policy)."""

    def __init__(self, bucket_name: str):
        from google.cloud import storage  # optional dep; gated by caller
        self.client = storage.Client()
        self.bucket = self.client.bucket(bucket_name)
        self.bucket_name = bucket_name

    def new_upload(self, filename: str) -> tuple[str, str]:
        blob_id = f"{uuid.uuid4().hex}_{os.path.basename(filename)}"
        blob = self.bucket.blob(f"uploads/{blob_id}")
        url = blob.generate_signed_url(version="v4", method="PUT",
                                       expiration=3600)
        return url, f"gs://{self.bucket_name}/uploads/{blob_id}"

    def fetch_to(self, gcs_uri: str, dest_path: str) -> bool:
        prefix = f"gs://{self.bucket_name}/"
        if not gcs_uri.startswith(prefix):
            return False
        self.bucket.blob(gcs_uri[len(prefix):]).download_to_filename(
            dest_path)
        return True

    def delete(self, gcs_uri: str) -> None:
        prefix = f"gs://{self.bucket_name}/"
        if gcs_uri.startswith(prefix):
            self.bucket.blob(gcs_uri[len(prefix):]).delete()


class JobStore:
    """Job/state registry + on-disk blobs.

    Jobs persist to ``jobs.json`` in the workdir (the manifest pattern of
    parallel/fleet): a restarted server reloads job states, and jobs that
    were mid-flight when the process died are REQUEUED (their uploads are
    still on disk) — the serving tier's checkpoint/resume story
    (SURVEY.md §5.4, where the reference has none).

    All reads/writes of job state go through the lock: callbacks mutate
    from worker threads while request handlers read concurrently."""

    def __init__(self, workdir: str, ttl_s: float | None = None):
        self.workdir = workdir
        self.uploads = os.path.join(workdir, "uploads")
        self.outputs = os.path.join(workdir, "outputs")
        os.makedirs(self.uploads, exist_ok=True)
        os.makedirs(self.outputs, exist_ok=True)
        self.lock = threading.Lock()
        self._persist_lock = threading.Lock()  # serializes disk writes
        self.jobs: dict[str, dict] = {}   # output name -> state
        self.queue: "queue.Queue[tuple[str, dict]]" = queue.Queue()
        self._jobs_path = os.path.join(workdir, "jobs.json")
        self.ttl_s = (float(os.environ.get("AME_TPU_SERVE_TTL_S", 86400))
                      if ttl_s is None else float(ttl_s))
        # Upload ceiling (bytes). 2 GiB default ~= 3.3 h of 44.1k/16/stereo
        # WAV — far past any single-track master, small enough to bound disk.
        self.max_upload_bytes = int(float(os.environ.get(
            "AME_TPU_SERVE_MAX_UPLOAD_MB", 2048)) * 1024 * 1024)
        # Abuse controls — both OFF by default (the reference's implied App
        # Engine backend had platform-level controls; a standalone server
        # needs its own): AME_TPU_SERVE_TOKEN gates every mutating endpoint
        # behind `Authorization: Bearer <token>`; AME_TPU_SERVE_QUOTA caps
        # in-flight (queued or running) jobs per client address.
        self.auth_token = os.environ.get("AME_TPU_SERVE_TOKEN") or None
        self.client_quota = int(os.environ.get("AME_TPU_SERVE_QUOTA", "0"))
        self.gcs = None
        bucket = os.environ.get("AME_TPU_SERVE_GCS_BUCKET")
        if bucket:
            try:
                self.gcs = GCSBlobBackend(bucket)
                log.info("GCS blob backend active: bucket %s", bucket)
            except Exception:
                log.exception("GCS backend unavailable; using local store")
        self._load_jobs()

    def _load_jobs(self) -> None:
        if not os.path.exists(self._jobs_path):
            return
        try:
            with open(self._jobs_path) as f:
                self.jobs = json.load(f)
        except Exception:
            log.exception("could not load persisted jobs; starting fresh")
            return
        for name, state in self.jobs.items():
            if state.get("status") == "processing":
                settings = state.get("settings")
                if settings and os.path.exists(
                        settings.get("input_file", "")):
                    log.info("requeueing interrupted job %s", name)
                    state["messages"] = state.get("messages", [])
                    self.queue.put((name, settings))
                else:
                    state["status"] = "error"
                    state["error"] = "interrupted; input lost"

    # -- lock-guarded state access -------------------------------------------
    def create_job(self, name: str, state: dict) -> None:
        with self.lock:
            self.jobs[name] = state

    def active_jobs_for(self, client: str) -> int:
        """In-flight (queued or running) jobs attributed to one client
        address — the AME_TPU_SERVE_QUOTA accounting unit."""
        with self.lock:
            return sum(1 for j in self.jobs.values()
                       if j.get("client") == client
                       and j.get("status") == "processing")

    def create_job_within_quota(self, name: str, state: dict, client: str,
                                quota: int) -> bool:
        """Atomically check the per-client in-flight quota AND register the
        job under ONE lock hold. A separate check-then-create (the obvious
        handler-side shape) races: two simultaneous /start-processing
        requests from the same client both observe quota-1 in-flight jobs
        and both insert — exceeding the quota. Returns False when the
        quota is full (the handler answers 429)."""
        with self.lock:
            if quota > 0:
                active = sum(1 for j in self.jobs.values()
                             if j.get("client") == client
                             and j.get("status") == "processing")
                if active >= quota:
                    return False
            self.jobs[name] = state
            return True

    def update_job(self, name: str, **fields) -> None:
        with self.lock:
            job = self.jobs.get(name)
            if job is not None:
                job.update(fields)

    def append_message(self, name: str, msg: str) -> None:
        with self.lock:
            job = self.jobs.get(name)
            if job is not None:
                job.setdefault("messages", []).append(msg)
                if msg.startswith("Error:"):
                    job["status"] = "error"
                    job["error"] = msg

    def job_snapshot(self, name: str) -> dict | None:
        with self.lock:
            job = self.jobs.get(name)
            return None if job is None else json.loads(
                json.dumps(job, default=str))

    def job_status(self, name: str) -> str | None:
        with self.lock:
            job = self.jobs.get(name)
            return None if job is None else job.get("status")

    def persist(self) -> None:
        tmp = self._jobs_path + ".tmp"
        with self.lock:
            snapshot = json.dumps(self.jobs, default=str, indent=1)
        # two workers finishing together must not race write/replace on the
        # same tmp file (the loser's os.replace would find it gone)
        with self._persist_lock:
            with open(tmp, "w") as f:
                f.write(snapshot)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._jobs_path)

    # -- blobs ----------------------------------------------------------------
    def new_upload(self, filename: str) -> tuple[str, str]:
        if self.gcs is not None:
            try:
                return self.gcs.new_upload(filename)
            except Exception:
                log.exception("GCS signed-url failed; local fallback")
        blob_id = f"{uuid.uuid4().hex}_{os.path.basename(filename)}"
        return f"/upload/{blob_id}", f"local://{blob_id}"

    def resolve_input(self, uri: str) -> str | None:
        """gcs_uri (local:// or gs://) -> local input path, or None."""
        if uri.startswith("gs://") and self.gcs is not None:
            dest = self.upload_path(uri.rsplit("/", 1)[-1])
            try:
                if self.gcs.fetch_to(uri, dest):
                    return dest
            except Exception:
                log.exception("GCS fetch failed for %s", uri)
            return None
        path = self.upload_path(uri.split("://", 1)[-1])
        return path if os.path.exists(path) else None

    def upload_path(self, blob_id: str) -> str:
        return os.path.join(self.uploads, os.path.basename(blob_id))

    def output_path(self, name: str) -> str:
        return os.path.join(self.outputs, os.path.basename(name))

    # -- TTL garbage collection ----------------------------------------------
    def gc_expired(self, now: float | None = None) -> int:
        """Drop done/error jobs older than ttl_s and their blobs (outputs,
        art, mp3, and the uploaded input). Never touches queued/processing
        jobs. Orphaned uploads older than ttl_s are removed too. Returns
        the number of jobs collected."""
        now = time.time() if now is None else now
        expired = []
        with self.lock:
            for name, job in list(self.jobs.items()):
                if (job.get("status") in ("done", "error")
                        and now - job.get("created", now) > self.ttl_s):
                    expired.append((name, self.jobs.pop(name)))
            # inputs still referenced by surviving jobs (a client may
            # reuse one upload across jobs) must not be deleted
            live_inputs = set()
            for job in self.jobs.values():
                fp = (job.get("settings") or {}).get("input_file")
                if fp:
                    live_inputs.add(os.path.basename(fp))
        for name, job in expired:
            stem = os.path.splitext(name)[0]
            doomed = [self.output_path(name),
                      self.output_path(stem + ".mp3"),
                      self.output_path(stem + "_art.png")]
            in_file = (job.get("settings") or {}).get("input_file", "")
            if in_file and os.path.basename(in_file) not in live_inputs:
                doomed.append(in_file)
                gcs_uri = (job.get("settings") or {}).get("gcs_uri", "")
                if gcs_uri.startswith("gs://") and self.gcs is not None:
                    try:
                        self.gcs.delete(gcs_uri)
                    except Exception:
                        log.exception("gc: GCS delete failed %s", gcs_uri)
            if job.get("art_file"):
                doomed.append(self.output_path(
                    os.path.basename(job["art_file"])))
            for fp in doomed:
                if fp and os.path.isfile(fp):
                    try:
                        os.remove(fp)
                    except OSError:
                        pass
            log.info("gc: expired job %s", name)
        try:
            for fn in os.listdir(self.uploads):
                fp = os.path.join(self.uploads, fn)
                if (fn not in live_inputs and os.path.isfile(fp)
                        and now - os.path.getmtime(fp) > self.ttl_s):
                    os.remove(fp)
        except OSError:
            pass
        if expired:
            self.persist()
        return len(expired)


def _serve_devices(device: str = "cuda") -> list[torch.device]:
    """Device pool for the worker threads. Round-robinning workers over
    cards turns the serve queue into a multi-card throughput scheduler
    (each mastering job runs on one card). ``device="cuda"``: every CUDA
    card, capped by AME_TPU_SERVE_DEVICES (0/unset = all); raises where
    there is none — the server never falls back to the CPU. ``"cpu"``:
    one host device, on request only."""
    if resolve_device(device, "the server").type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count()
    cap = int(os.environ.get("AME_TPU_SERVE_DEVICES", 0))
    if cap > 0:
        n = min(n, cap)
    return [torch.device(f"cuda:{i}") for i in range(n)]


def _on(device: torch.device):
    """The scope that makes `device` current: torch.cuda.device on a card,
    nothing on the host."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _worker_loop(store: JobStore, device: torch.device):
    """Drain the job queue on `device`: every job runs ``process_audio``
    with ``device=`` under ``torch.cuda.device`` (decode staging, the
    mastering graph, the Musicologist), and records the device on the
    job."""
    from ame_tpu_torch.api import process_audio

    device = torch.device(device)
    while True:
        job_name, settings = store.queue.get()
        store.update_job(job_name, device=str(device))

        def status_cb(msg):
            store.append_message(job_name, msg)

        def progress_cb(cur, total):
            store.update_job(job_name, progress=[cur, total])

        def art_cb(path):
            if path:
                store.update_job(job_name, art_file=path)

        def tag_cb(msg):
            store.update_job(job_name, tag=msg)

        try:
            with _on(device):
                process_audio(settings, status_cb, progress_cb, art_cb,
                              tag_cb, device=device)
            if store.job_status(job_name) != "error":
                store.update_job(job_name, status="done")
        except Exception as e:  # pragma: no cover — process_audio catches
            log.exception("job failed")
            store.update_job(job_name, status="error", error=str(e))
        finally:
            store.persist()
            store.queue.task_done()


class Handler(BaseHTTPRequestHandler):
    store: JobStore = None  # set by make_server
    device: torch.device = None  # the pool's first device (/measure)
    protocol_version = "HTTP/1.1"

    # -- helpers ------------------------------------------------------------
    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length else b""

    def log_message(self, fmt, *args):
        log.info("%s %s", self.address_string(), fmt % args)

    def _authorized(self) -> bool:
        """Bearer-token gate on mutating endpoints (AME_TPU_SERVE_TOKEN;
        off when unset). Reads stay open — /status and /download names are
        unguessable (uuid-suffixed) and the web UI must keep working."""
        token = self.store.auth_token
        if not token:
            return True
        hdr = self.headers.get("Authorization", "")
        return hmac.compare_digest(hdr, f"Bearer {token}")

    # -- routes ---------------------------------------------------------------
    def do_POST(self):
        path = urlparse(self.path).path
        if not self._authorized():
            self._json(401, {"error": "missing or bad bearer token"})
            return
        if path == "/generate-upload-url":
            try:
                req = json.loads(self._read_body() or b"{}")
                filename = req.get("filename") or "upload.wav"
                url, uri = self.store.new_upload(filename)
                self._json(200, {"url": url, "gcs_uri": uri})
            except Exception as e:
                self._json(400, {"error": str(e)})
        elif path == "/measure":
            # synchronous BS.1770 / loudnorm pass-1 report for an uploaded
            # blob: {"gcs_uri": ...} -> the full JSON stats analog
            # (input_*/output_*/target_offset — cli.py `measure` over HTTP)
            try:
                req = json.loads(self._read_body() or b"{}")
                input_path = self.store.resolve_input(req.get("gcs_uri", ""))
                if input_path is None:
                    self._json(404, {"error": "no upload for that uri"})
                    return
                from ame_tpu_torch.io import force_stereo, read_audio
                from ame_tpu_torch.ops.loudnorm import loudnorm_pass1
                audio, sr = read_audio(input_path)
                target = float(req.get("target_i", -14.0))
                x = torch.from_numpy(np.ascontiguousarray(
                    force_stereo(audio), np.float32)).to(self.device)
                with _on(self.device):
                    stats = loudnorm_pass1(x, sr, target_i=target)
                self._json(200, {k: round(float(v), 2)
                                 for k, v in stats.items()}
                           | {"sample_rate": sr, "target_i": target})
            except Exception as e:
                log.exception("measure failed")
                self._json(400, {"error": str(e)})
        elif path == "/start-processing":
            try:
                req = json.loads(self._read_body() or b"{}")
                uri = req.get("gcs_uri", "")
                settings = dict(req.get("settings") or {})
                input_path = self.store.resolve_input(uri)
                if input_path is None:
                    self._json(404, {"error": f"no upload for {uri}"})
                    return
                client = self.client_address[0]
                quota = self.store.client_quota
                stem = os.path.splitext(os.path.basename(input_path))[0]
                out_name = f"{stem}_mastered.wav"
                art_name = f"{stem}_mastered_art.png"
                settings["input_file"] = input_path
                settings["gcs_uri"] = uri   # lets TTL GC drop the object
                settings["output_file"] = self.store.output_path(out_name)
                # quota check + job registration are ONE atomic store op:
                # check-then-create here would let two simultaneous
                # requests from one client both pass the check
                if not self.store.create_job_within_quota(out_name, {
                        "status": "processing", "messages": [],
                        "progress": [0, 1], "tag": "", "art_file": None,
                        "settings": settings, "created": time.time(),
                        "client": client,
                }, client, quota):
                    self._json(429, {"error":
                                     f"quota exceeded: {quota} in-flight "
                                     f"job(s) per client"})
                    return
                self.store.persist()
                self.store.queue.put((out_name, settings))
                self._json(200, {"processed_filename": out_name,
                                 "image_filename": art_name})
            except Exception as e:
                log.exception("start-processing failed")
                self._json(400, {"error": str(e)})
        else:
            self._json(404, {"error": "not found"})

    _UPLOAD_CHUNK = 1 << 20  # 1 MiB

    def do_PUT(self):
        path = urlparse(self.path).path
        if not self._authorized():
            self._json(401, {"error": "missing or bad bearer token"})
            return
        if not path.startswith("/upload/"):
            self._json(404, {"error": "not found"})
            return
        blob_id = path[len("/upload/"):]
        length = self.headers.get("Content-Length")
        if length is None:
            # BaseHTTPRequestHandler doesn't decode chunked bodies; the
            # reference PUT contract (templates/index.html:263-268) always
            # sends a sized body.
            self._json(411, {"error": "Content-Length required"})
            return
        length = int(length)
        cap = self.store.max_upload_bytes
        if length > cap:
            # drain nothing — signal before the client streams the body
            self.close_connection = True
            self._json(413, {"error": f"upload exceeds {cap} byte limit"})
            return
        # Stream to disk in 1 MiB chunks: constant memory for GB uploads.
        dest = self.store.upload_path(blob_id)
        written = 0
        try:
            with open(dest, "wb") as f:
                while written < length:
                    chunk = self.rfile.read(
                        min(self._UPLOAD_CHUNK, length - written))
                    if not chunk:
                        raise ConnectionError("client closed mid-upload")
                    f.write(chunk)
                    written += len(chunk)
        except (ConnectionError, OSError) as e:
            with contextlib.suppress(OSError):
                os.remove(dest)
            self.close_connection = True
            log.warning("upload %s aborted after %d bytes: %s",
                        blob_id, written, e)
            return
        self._json(200, {"ok": True, "bytes": written})

    def do_GET(self):
        parsed = urlparse(self.path)
        path = parsed.path
        if path == "/status":
            q = parse_qs(parsed.query)
            name = (q.get("audio_filename") or [""])[0]
            job = self.store.job_snapshot(os.path.basename(name))
            if job is None:
                self._json(404, {"status": "error",
                                 "error": "unknown job"})
                return
            if job["status"] == "done":
                resp = {"status": "done",
                        "download_url": f"/download/{os.path.basename(name)}",
                        "progress": job["progress"],
                        "tag": job.get("tag", "")}
                mp3 = os.path.splitext(os.path.basename(name))[0] + ".mp3"
                if os.path.exists(self.store.output_path(mp3)):
                    resp["mp3_url"] = f"/download/{mp3}"
                if job.get("art_file"):
                    resp["art_url"] = (
                        f"/art/{os.path.basename(job['art_file'])}")
                self._json(200, resp)
            elif job["status"] == "error":
                self._json(200, {"status": "error",
                                 "error": job.get("error", "unknown")})
            else:
                resp = {"status": "processing",
                        "progress": job["progress"],
                        "queue_depth": self.store.queue.qsize()}
                if job.get("device"):
                    resp["device"] = job["device"]
                self._json(200, resp)
        elif path.startswith("/download/") or path.startswith("/art/"):
            name = os.path.basename(path)
            fp = self.store.output_path(name)
            if not os.path.exists(fp):
                self._json(404, {"error": "not found"})
                return
            ctype = ("audio/wav" if name.endswith(".wav") else
                     "audio/mpeg" if name.endswith(".mp3") else
                     "image/png" if name.endswith(".png") else
                     "application/octet-stream")
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(os.path.getsize(fp)))
            self.end_headers()
            with open(fp, "rb") as f:  # stream, don't slurp
                while True:
                    chunk = f.read(_DOWNLOAD_CHUNK)
                    if not chunk:
                        break
                    self.wfile.write(chunk)
        elif path in ("/", "/index.html"):
            page = _web_ui().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)
        elif path == "/healthz":
            self._json(200, {"ok": True,
                             "queue_depth": self.store.queue.qsize()})
        elif path == "/metrics":
            # observability snapshot (SURVEY.md §5.5): job mix, queue
            # depth, device pool, host/device memory
            with self.store.lock:
                by_status: dict[str, int] = {}
                by_device: dict[str, int] = {}
                for j in self.store.jobs.values():
                    st = j.get("status", "unknown")
                    by_status[st] = by_status.get(st, 0) + 1
                    d = j.get("device")
                    if d:
                        by_device[d] = by_device.get(d, 0) + 1
            out = {"jobs_by_status": by_status,
                   "jobs_by_device": by_device,
                   "queue_depth": self.store.queue.qsize(),
                   "gcs_backend": self.store.gcs is not None,
                   "ttl_s": self.store.ttl_s}
            try:
                from ame_tpu_torch.utils.telemetry import (
                    device_memory_stats, host_rss_mb)
                out["host_rss_mb"] = host_rss_mb()
                out["devices"] = device_memory_stats()
            except Exception:  # telemetry is best-effort
                log.exception("metrics: telemetry failed")
            self._json(200, out)
        else:
            self._json(404, {"error": "not found"})


def _web_ui() -> str:
    """Single-page client with the reference UI's full control set (own
    markup; same endpoint flow: upload-url -> PUT -> start-processing ->
    poll status -> download + art, index.html:249-380)."""
    return """<!doctype html>
<html><head><meta charset="utf-8"><title>ame_tpu mastering</title>
<style>
 body{font-family:system-ui;margin:2rem auto;max-width:680px;color:#ddd;background:#191b1f}
 fieldset{border:1px solid #333;margin-bottom:1rem} label{display:block;margin:.4rem 0}
 input[type=range]{width:250px;vertical-align:middle}
 textarea{width:100%;background:#111;color:#ddd;border:1px solid #333}
 #log{white-space:pre-wrap;background:#111;padding:.6rem;font-size:.8rem;min-height:6rem}
 button{padding:.5rem 1.2rem}
 progress{width:100%;height:1rem}
 #mb_panel{margin-left:1rem}
 #art{max-width:100%;margin-top:.6rem;display:none}
 .val{color:#8ab;font-size:.85em;margin-left:.4em}
</style></head><body>
<h1>ame_tpu mastering service</h1>
<fieldset><legend>Track</legend><input type="file" id="file"></fieldset>
<fieldset><legend>Master settings</legend>
 <label>Bass (dB) <input type="range" id="bass_boost" min="-6" max="6" step="0.5" value="0"><span class="val"></span></label>
 <label>Mid cut (dB) <input type="range" id="mid_cut" min="0" max="6" step="0.5" value="0"><span class="val"></span></label>
 <label>Presence (dB) <input type="range" id="presence_boost" min="-6" max="6" step="0.5" value="0"><span class="val"></span></label>
 <label>Treble (dB) <input type="range" id="treble_boost" min="-6" max="6" step="0.5" value="0"><span class="val"></span></label>
 <label>Analog character (%) <input type="range" id="analog_character" min="0" max="100" step="1" value="0"><span class="val"></span></label>
 <label>Stereo width <input type="range" id="width" min="0" max="2" step="0.1" value="1"><span class="val"></span></label>
 <label>Target LUFS <input type="range" id="lufs" min="-20" max="-6" step="0.5" value="-14"><span class="val"></span></label>
</fieldset>
<fieldset><legend><label><input type="checkbox" id="multiband"> Multiband compressor</label></legend>
 <div id="mb_panel" style="display:none">
  <label>Low thresh (dB) <input type="range" id="low_thresh" min="-40" max="0" step="1" value="-25"><span class="val"></span></label>
  <label>Low ratio <input type="range" id="low_ratio" min="1" max="10" step="0.5" value="6"><span class="val"></span></label>
  <label>Mid thresh (dB) <input type="range" id="mid_thresh" min="-40" max="0" step="1" value="-20"><span class="val"></span></label>
  <label>Mid ratio <input type="range" id="mid_ratio" min="1" max="10" step="0.5" value="3"><span class="val"></span></label>
  <label>High thresh (dB) <input type="range" id="high_thresh" min="-40" max="0" step="1" value="-15"><span class="val"></span></label>
  <label>High ratio <input type="range" id="high_ratio" min="1" max="10" step="0.5" value="4"><span class="val"></span></label>
 </div>
</fieldset>
<fieldset><legend>Cover art</legend>
 <label><input type="checkbox" id="auto_generate_prompt" checked> Auto-generate prompt from analysis</label>
 <textarea id="art_prompt" rows="2" placeholder="Manual art prompt…" disabled></textarea>
</fieldset>
<fieldset><legend>Export</legend>
 <label><input type="checkbox" id="create_mp3" checked> Also create MP3 (V0)</label>
 <label><input type="checkbox" id="shard_time"> Distribute this track across all chips (long tracks)</label>
</fieldset>
<button id="go">Master it</button>
<progress id="bar" max="1" value="0"></progress>
<h3>Log</h3><div id="log"></div>
<p id="tag"></p>
<p id="result"></p>
<img id="art" alt="cover art">
<script>
const $ = id => document.getElementById(id);
const log = m => $('log').textContent += m + "\\n";
const SLIDERS = ['bass_boost','mid_cut','presence_boost','treble_boost',
                 'analog_character','width','lufs','low_thresh','low_ratio',
                 'mid_thresh','mid_ratio','high_thresh','high_ratio'];
for (const id of SLIDERS) {
  const el = $(id), out = el.parentElement.querySelector('.val');
  const upd = () => { if (out) out.textContent = el.value; };
  el.addEventListener('input', upd); upd();
}
$('multiband').onchange = () =>
  $('mb_panel').style.display = $('multiband').checked ? '' : 'none';
$('auto_generate_prompt').onchange = () =>
  $('art_prompt').disabled = $('auto_generate_prompt').checked;
const setBusy = b => {
  for (const el of document.querySelectorAll('input,textarea,button'))
    el.disabled = b;
  if (!b) $('art_prompt').disabled = $('auto_generate_prompt').checked;
};
$('go').onclick = async () => {
  const f = $('file').files[0];
  if (!f) { log('pick a file first'); return; }
  const settings = {};
  for (const id of SLIDERS) settings[id] = parseFloat($(id).value);
  settings.multiband = $('multiband').checked;
  settings.create_mp3 = $('create_mp3').checked;
  settings.shard_time = $('shard_time').checked;
  settings.auto_generate_prompt = $('auto_generate_prompt').checked;
  settings.art_prompt = $('art_prompt').value;
  settings.original_filename = f.name;
  setBusy(true);
  try {
    log('requesting upload URL…');
    let r = await fetch('/generate-upload-url', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({filename: f.name, contentType: f.type})});
    const {url, gcs_uri} = await r.json();
    log('uploading…');
    await fetch(url, {method:'PUT', body: f});
    log('starting job…');
    r = await fetch('/start-processing', {method:'POST',
      headers:{'Content-Type':'application/json'},
      body: JSON.stringify({gcs_uri, settings})});
    const {processed_filename, image_filename} = await r.json();
    let failures = 0;  // 5 CONSECUTIVE failures give up (index.html:293-331)
    const poll = async () => {
      try {
        const r = await fetch(`/status?audio_filename=${processed_filename}&image_filename=${image_filename}`);
        if (!r.ok) throw new Error(`status check failed: ${r.status}`);
        const s = await r.json();
        failures = 0;  // reset on a successful poll, as the reference does
        if (s.status === 'done') {
          $('bar').value = 1;
          if (s.tag) $('tag').textContent = s.tag;
          log('done');
          $('result').innerHTML =
            `<a href="${s.download_url}">download master</a>` +
            (s.mp3_url ? ` · <a href="${s.mp3_url}">MP3</a>` : '');
          if (s.art_url) { $('art').src = s.art_url; $('art').style.display = 'block'; }
          setBusy(false);
          return;
        }
        if (s.status === 'error') { log('error: ' + s.error); setBusy(false); return; }
        if (s.progress && s.progress[1] > 0) $('bar').value = s.progress[0] / s.progress[1];
        log(`processing ${s.progress[0]}/${s.progress[1]}…`);
      } catch (e) {
        if (++failures >= 5) { log('error: could not check status, connection lost'); setBusy(false); return; }
      }
      setTimeout(poll, 2000);
    };
    poll();
  } catch (e) { log('error: ' + e); setBusy(false); }
};
</script></body></html>"""


def _janitor_loop(store: JobStore, interval_s: float):
    while True:
        time.sleep(interval_s)
        try:
            store.gc_expired()
        except Exception:  # pragma: no cover — keep the janitor alive
            log.exception("gc pass failed")


def make_server(host: str = "127.0.0.1", port: int = 8080,
                workdir: str | None = None, workers: int | None = None,
                device: str = "cuda"):
    """Build (server, store) without blocking — used by tests.

    device: "cuda" (default: every card, raises where there is none) or
    "cpu" (the host, on request only). workers: size of the job-worker
    pool (env AME_TPU_SERVE_WORKERS, default max(2, cards) — two queued
    jobs overlap decode/encode/analysis); worker i runs on device
    i mod cards. A janitor thread GCs done/error jobs and their blobs
    after AME_TPU_SERVE_TTL_S seconds (default 24 h; <= 0 disables)."""
    devices = _serve_devices(device)
    workdir = workdir or tempfile.mkdtemp(prefix="ame_tpu_torch_serve_")
    store = JobStore(workdir)
    if workers is None:
        env = os.environ.get("AME_TPU_SERVE_WORKERS")
        # default: at least one worker per card — an idle card behind a
        # 2-thread pool is wasted capacity. An explicit count wins.
        workers = int(env) if env else max(2, len(devices))
    workers = max(workers, 1)
    for i in range(workers):
        threading.Thread(target=_worker_loop,
                         args=(store, devices[i % len(devices)]),
                         daemon=True).start()
    if store.ttl_s > 0:
        threading.Thread(
            target=_janitor_loop,
            args=(store, min(store.ttl_s / 4, 900.0)),
            daemon=True).start()
    handler = type("BoundHandler", (Handler,),
                   {"store": store, "device": devices[0]})
    server = ThreadingHTTPServer((host, port), handler)
    return server, store


def run_server(host: str = "127.0.0.1", port: int = 8080,
               workdir: str | None = None, workers: int | None = None,
               device: str = "cuda"):
    server, store = make_server(host, port, workdir, workers, device)
    log.info("serving on http://%s:%d (workdir %s)", host, port,
             store.workdir)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass

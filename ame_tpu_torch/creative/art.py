"""Pluggable cover-art provider (reference C16, engine:151-170).

Port of ``ame_tpu/creative/art.py``. Providers register through one
interface; the Vertex AI Imagen provider is used when its SDK and
credentials exist (an optional import), otherwise art generation reports
unavailable and the pipeline continues (the reference's degrade contract:
art failure never fails the master, engine:124-127). The local procedural
provider (``creative/procedural.py``) is opt-in through
``AME_TPU_ART_PROVIDER=procedural``.

Art output path convention preserved: ``<master-stem>_art.png`` beside the
output (engine:163-166).
"""

from __future__ import annotations

import logging
import os
import subprocess
from typing import Callable, Optional

log = logging.getLogger("ame_tpu_torch.creative")

Provider = Callable[[str, str], str]  # (prompt, out_png_path) -> path

_providers: dict[str, Provider] = {}
_active: Optional[str] = None


def register_provider(name: str, fn: Provider, activate: bool = True) -> None:
    global _active
    _providers[name] = fn
    if activate or _active is None:
        _active = name


def _gcloud_project_id() -> Optional[str]:
    """Project-id fallback when ADC carries credentials but no project:
    ask the gcloud CLI, as the reference does (engine:157-159). None when
    gcloud is absent or unconfigured (the caller degrades)."""
    try:
        out = subprocess.run(
            ["gcloud", "config", "get-value", "project"],
            capture_output=True, text=True, timeout=15, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    # unconfigured gcloud prints "(unset)" (to stdout or stderr by version)
    if not out or out.startswith("("):
        return None
    return out


def _try_register_vertex() -> None:
    if "vertex" in _providers:
        return
    try:
        import google.auth  # type: ignore
        import vertexai  # type: ignore
        from vertexai.preview.vision_models import ImageGenerationModel  # type: ignore
    except ImportError:
        return

    def vertex_provider(prompt: str, out_path: str) -> str:
        credentials, project_id = google.auth.default()
        if not project_id:
            project_id = _gcloud_project_id()
        if not project_id:
            raise RuntimeError("could not determine GCP project id")
        vertexai.init(project=project_id, location="us-central1",
                      credentials=credentials)
        model = ImageGenerationModel.from_pretrained("imagegeneration@005")
        images = model.generate_images(prompt=prompt, number_of_images=1,
                                       aspect_ratio="1:1")
        images[0].save(location=out_path, include_generation_parameters=False)
        return out_path

    # never steal the active slot from an explicitly registered provider
    register_provider("vertex", vertex_provider, activate=False)


def _try_register_procedural() -> None:
    """Opt-in local provider (AME_TPU_ART_PROVIDER=procedural). Kept
    opt-in so the default matches the reference (no credentials, no
    art)."""
    if os.environ.get("AME_TPU_ART_PROVIDER", "").lower() == "procedural" \
            and "procedural" not in _providers:
        from ame_tpu_torch.creative import procedural
        procedural.activate()


def available() -> bool:
    _try_register_vertex()
    _try_register_procedural()
    return _active is not None


def art_path_for(audio_output_path: str) -> str:
    d, base = os.path.split(audio_output_path)
    stem = os.path.splitext(base)[0]
    return os.path.join(d, f"{stem}_art.png")


def generate_cover_art(prompt: str, audio_output_path: str) -> str:
    """Generate cover art beside the master. Raises on provider failure
    (the caller degrades, as the reference does)."""
    if not available():
        raise RuntimeError("no art provider available")
    out_path = art_path_for(audio_output_path)
    log.info("generating cover art via %s -> %s", _active, out_path)
    return _providers[_active](prompt, out_path)

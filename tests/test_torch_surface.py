"""The port's public surface against ame_tpu's, read with ``ast`` (neither
package is imported).

For every module of ``ame_tpu/`` with a counterpart at the same path in
``ame_tpu_torch/``: each public function, each public class and each of
its public methods (with ``__init__`` and ``__call__``) exists in the
port, takes every parameter the reference takes, and takes the
reference's positional parameters at the same positions, so that a call
written for ``ame_tpu`` means the same on the port. ``ame_tpu.__all__``
is a subset of ``ame_tpu_torch.__all__``. Every deliberate difference is
an entry of ALLOWED with its reason; an entry that no longer matches a
difference fails too."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(REPO, "ame_tpu"), os.path.join(REPO, "ame_tpu_torch")

_DEVICE = "the port's device parameter: the card or the CPU, the caller's"
_INTERPRET = "a Pallas knob (interpret mode); the port's kernels are CUDA"
_FORCE_SCAN = "a vmap knob of the JAX engine; the port runs no vmap"
_MODEL = "the mood CNN is an nn.Module: the model in place of flax's params"
_GENERATOR = "dropout draws from a torch.Generator in place of a JAX PRNG key"

# (module, qualified name or None, parameter or None) -> reason. A module
# entry allows a module with no counterpart; a name entry a public name the
# port does not carry; a parameter entry a parameter of the reference the
# port does not take, or one of the port's own that shifts the reference's
# positions.
ALLOWED = {
    ("ops/pallas_scan.py", None, None):
        "the Pallas engine; its kernel is csrc/cascade_scan.cu behind "
        "ops/cascade_scan.py (ROADMAP, Not carried)",
    ("utils/compile_cache.py", None, None):
        "XLA's persistent compile cache; the port compiles no XLA",
    ("ops/scan_iir.py", "sosfilt_scan", None):
        "the XLA Kogge-Stone engine; the port's sosfilt routes to K5 or "
        "the tile-conv",
    ("ops/tile_conv.py", "sosfilt_tileconv_bank", None):
        "batches cascades into one XLA program; the port runs one K5 "
        "launch a cascade",
    ("models/mood_cnn.py", "predict_logits", None):
        "MoodCNN.forward",
    ("models/mood_cnn.py", "MoodCNN.__call__", None):
        "nn.Module.__call__ runs MoodCNN.forward",
    ("api.py", "master_file", "device"): _DEVICE,
    ("api.py", "master_array", "device"): _DEVICE,
    ("ops/compressor.py", "pydub_compress_exact", "force_scan"): _FORCE_SCAN,
    ("ops/compressor.py", "pydub_compress_exact_multi_chunked",
     "force_scan"): _FORCE_SCAN,
    ("ops/pydub_gain.py", "pydub_gain", "interpret"): _INTERPRET,
    ("ops/pydub_gain.py", "pydub_gain_ends", "interpret"): _INTERPRET,
    ("ops/pydub_gain.py", "pydub_gain_multi", "interpret"): _INTERPRET,
    ("ops/pydub_gain.py", "pydub_gain_multi", "force_scan"): _FORCE_SCAN,
    ("ops/pydub_gain.py", "pydub_gain_chunked", "interpret"): _INTERPRET,
    ("ops/pydub_gain.py", "pydub_gain_chunked", "force_scan"): _FORCE_SCAN,
    ("models/mood_cnn.py", "init_params", "rng_seed"):
        "a torch.manual_seed seed in place of a JAX PRNG seed",
    ("models/mood_cnn.py", "init_params", "seed"):
        "a torch.manual_seed seed in place of a JAX PRNG seed",
    ("models/mood_cnn.py", "save_params", "params"): _MODEL,
    ("models/mood_cnn.py", "save_params", "model"): _MODEL,
    ("models/mood_cnn.py", "predict_mood", "params"): _MODEL,
    ("models/mood_cnn.py", "predict_mood", "model"): _MODEL,
    ("models/mood_cnn.py", "loss_fn", "params"): _MODEL,
    ("models/mood_cnn.py", "loss_fn", "model"): _MODEL,
    ("models/mood_cnn.py", "loss_fn", "batch"):
        "the images tensor, named so",
    ("models/mood_cnn.py", "loss_fn", "images"):
        "the images tensor, named so",
    ("models/mood_cnn.py", "loss_fn", "dropout_rng"): _GENERATOR,
    ("models/mood_cnn.py", "loss_fn", "generator"): _GENERATOR,
    ("models/checkpoint.py", "save_train_state", "step"):
        "checkpoints are numbered by epoch, the trainer's unit",
    ("models/checkpoint.py", "save_train_state", "epoch"):
        "checkpoints are numbered by epoch, the trainer's unit",
    ("models/checkpoint.py", "save_train_state", "params"): _MODEL,
    ("models/checkpoint.py", "save_train_state", "model"): _MODEL,
    ("models/checkpoint.py", "save_train_state", "opt_state"):
        "a torch.optim optimizer carries its own state",
    ("models/checkpoint.py", "save_train_state", "optimizer"):
        "a torch.optim optimizer carries its own state",
    ("models/checkpoint.py", "restore_train_state", "params"): _MODEL,
    ("models/checkpoint.py", "restore_train_state", "model"): _MODEL,
    ("models/checkpoint.py", "restore_train_state", "opt_state"):
        "a torch.optim optimizer carries its own state",
    ("models/checkpoint.py", "restore_train_state", "optimizer"):
        "a torch.optim optimizer carries its own state",
    ("parallel/train.py", "param_sharding_rules", "path"):
        "a parameter is named by its state_dict key, not a pytree path",
    ("parallel/train.py", "param_sharding_rules", "name"):
        "a parameter is named by its state_dict key, not a pytree path",
    ("parallel/train.py", "shard_params", "params"): _MODEL,
    ("parallel/train.py", "shard_params", "model"): _MODEL,
}


def _modules() -> list:
    out = []
    for root, dirs, files in os.walk(REF):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.relpath(os.path.join(root, f), REF).replace(os.sep,
                                                                    "/")
                for f in sorted(files) if f.endswith(".py")]
    return out


def _surface(path: str) -> dict:
    """Public name -> (positional parameters, keyword-only parameters), or
    None for a class."""
    with open(path) as f:
        tree = ast.parse(f.read())

    def params(fn):
        a = fn.args
        return ([p.arg for p in a.posonlyargs + a.args
                 if p.arg not in ("self", "cls")],
                [p.arg for p in a.kwonlyargs])

    out = {}
    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in tree.body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, funcs) and (
                        not sub.name.startswith("_")
                        or sub.name in ("__init__", "__call__")):
                    out[f"{node.name}.{sub.name}"] = params(sub)
    return out


def _gaps(module: str) -> tuple:
    """(the differences ALLOWED does not cover, the entries of ALLOWED for
    this module that matched a difference)."""
    port = os.path.join(PORT, module)
    if not os.path.exists(port):
        key = (module, None, None)
        return ([] if key in ALLOWED else [f"{module}: no counterpart"],
                {key} & set(ALLOWED))
    ref_s, port_s = _surface(os.path.join(REF, module)), _surface(port)
    gaps, used = [], set()
    for name, sig in ref_s.items():
        if name not in port_s:
            if (module, name, None) in ALLOWED:
                used.add((module, name, None))
            else:
                gaps.append(f"{module}: {name} is missing")
            continue
        if sig is None:
            continue
        (r_pos, r_kw), (p_pos, p_kw) = sig, port_s[name]

        def allowed(p):
            return (module, name, p) in ALLOWED

        for p in r_pos + r_kw:
            if p not in p_pos + p_kw:
                if allowed(p):
                    used.add((module, name, p))
                else:
                    gaps.append(f"{module}: {name} lacks {p!r}")
        r_at = [p for p in r_pos if not allowed(p)]
        p_at = [p for p in p_pos if not allowed(p)]
        used |= {(module, name, p) for p in r_pos + p_pos if allowed(p)}
        if p_at[:len(r_at)] != r_at:
            gaps.append(f"{module}: {name} takes {p_at} by position, the "
                        f"reference {r_at}")
    return gaps, used


@pytest.mark.parametrize("module", _modules())
def test_module_surface_matches_reference(module):
    gaps, used = _gaps(module)
    assert not gaps, "\n".join(gaps)
    stale = {k for k in ALLOWED if k[0] == module} - used
    assert not stale, f"ALLOWED entries that match no difference: {stale}"


def test_allowed_entries_name_reference_modules():
    mods = set(_modules())
    assert {k[0] for k in ALLOWED} <= mods
    assert all(reason.strip() for reason in ALLOWED.values())


def _all(path: str) -> list:
    with open(os.path.join(path, "__init__.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "__all__"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path}/__init__.py has no __all__")


def test_top_level_all_covers_reference():
    """ame_tpu.__all__ is in ame_tpu_torch.__all__, in the same order."""
    ref, port = _all(REF), _all(PORT)
    assert [n for n in port if n in ref] == ref

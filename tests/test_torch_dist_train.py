"""The port's multi-process training (ame_tpu_torch.parallel.mesh
.init_distributed, parallel/train.py, train_mood's data-parallel route) on
the CPU over gloo, against ame_tpu.parallel.train and the port's one-device
step.

The ranks are subprocesses of this interpreter that meet through a
``file://`` store in the test's temporary directory (no TCP port to
collide between workers), each with OMP_NUM_THREADS=1; every wait has a
timeout, and the children are killed when it runs out. The rank processes
import neither jax nor ame_tpu (each rank checks it before it exits).

Tolerances: the sharded step is held to the one-device step and to optax
within 1e-5 absolute after three Adam steps, and its first gradients to
the one-device ones within 1e-9 of each leaf's largest entry, in float64
on both sides. In float32 the sharded convolutions round their sums in
other orders than the whole ones, and max pooling routes a gradient to
whichever element of a window is largest: where two are within float32's
rounding, the two steps route it to different pixels, and Adam's division
by sqrt(v) turns that into parameter differences of 1.1e-5 to 3.5e-5
(measured at 2 model ranks, batch 8). float64 holds the algebra, layout
and collectives exactly (measured ~1e-15); the float32 step is held on
its losses (rtol 1e-5).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ame_tpu.models import mood_cnn as JC
from ame_tpu_torch import convert
from ame_tpu_torch.models import _msgpack, synth_corpus, train_mood
from ame_tpu_torch.models import mood_cnn as TC
from ame_tpu_torch.parallel import train as T
from ame_tpu_torch.parallel.mesh import init_distributed, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
B = 8                      # the global batch
STEPS = 3
SEED = 5                   # the flax parameters every case starts from
DROP_SEED = 7              # the dropout generator's seed
LAYOUTS = [(1, 2), (2, 1), (2, 2), (4, 2)]
LEAVES = [f"convs.{i}.{k}" for i in range(3) for k in ("weight", "bias")] \
    + [f"dense{j}.{k}" for j in range(2) for k in ("weight", "bias")]

# One rank of a sharded run. From the flax parameters in the input file:
# the slices shard_params gives this rank; then STEPS steps with dropout
# on and STEPS with it off in float64 (the first step's gradients too), and
# STEPS with dropout on in float32; from init_fn(0), 8 float32 steps on one
# batch with one dropout mask (the generator re-seeded every step).
_RANK = r'''
import copy
import sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from ame_tpu_torch.models import mood_cnn as TC
from ame_tpu_torch.parallel import train as T
from ame_tpu_torch.parallel.mesh import init_distributed, make_mesh

store, rank, dp, tp, inp, out = sys.argv[1:]
rank, dp, tp = int(rank), int(dp), int(tp)
assert init_distributed(f"file://{store}", dp * tp, rank, device="cpu",
                        timeout=120) == dp * tp
mesh = make_mesh({"data": dp, "model": tp}, devices=["cpu"] * (dp * tp))
init_fn, step_fn, place_batch = T.make_sharded_train_step(mesh, 1e-3)
d = torch.load(inp, weights_only=True)
model = TC.MoodCNN()
model.load_state_dict(d["state"])


def slices(params):
    return {n: p.detach().clone() for n, p in params.named_parameters()}


res = {"init": slices(T.shard_params(model, mesh))}
for phase, dtype, dropout in (("dropout", torch.float64, TC.DROPOUT),
                              ("plain", torch.float64, 0.0),
                              ("f32", torch.float32, TC.DROPOUT)):
    params = T.shard_params(copy.deepcopy(model).to(dtype), mesh)
    batch, labels = place_batch(d["images"].to(dtype), d["labels"])
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    gen = torch.Generator().manual_seed(int(d["drop_seed"]))
    losses = []
    for i in range(int(d["steps"])):
        _, _, loss, acc = step_fn(params, opt, batch, labels, gen,
                                  dropout=dropout)
        losses.append(float(loss))
        if i == 0:
            res[phase + "_grad"] = {n: p.grad.clone()
                                    for n, p in params.named_parameters()}
    res[phase] = slices(params)
    res[phase + "_losses"] = losses
params, opt = init_fn(0)
res["init_fn"] = slices(params)
batch, labels = place_batch(d["images"], d["labels"])
losses = []
for _ in range(8):
    gen = torch.Generator().manual_seed(0)
    losses.append(float(step_fn(params, opt, batch, labels, gen)[2]))
res["descend"] = losses
dist.destroy_process_group()
for name in ("jax", "ame_tpu"):
    assert name not in sys.modules, name
torch.save(res, out)
'''

# One rank of train_mood.main under torchrun's environment (set by the
# test): the parameters it ends with and the files it wrote.
_MAIN = r'''
import sys
import torch

torch.set_num_threads(1)
from ame_tpu_torch.models import checkpoint, mood_cnn, train_mood
from ame_tpu_torch.parallel import train as T

seen = {"weights": 0, "checkpoints": 0}
make = T.make_sharded_train_step
save_params, save_train_state = mood_cnn.save_params, checkpoint.save_train_state


def spy(*args, **kwargs):
    init_fn, step_fn, place_batch = make(*args, **kwargs)

    def init(*a, **k):
        seen["params"], opt = init_fn(*a, **k)
        return seen["params"], opt
    return init, step_fn, place_batch


def count(key, fn):
    def wrapped(*a, **k):
        seen[key] += 1
        return fn(*a, **k)
    return wrapped


T.make_sharded_train_step = spy
mood_cnn.save_params = count("weights", save_params)
checkpoint.save_train_state = count("checkpoints", save_train_state)
assert train_mood.main(sys.argv[2:]) == 0
for name in ("jax", "ame_tpu"):
    assert name not in sys.modules, name
seen["params"] = seen["params"].state_dict()
torch.save(seen, sys.argv[1])
'''


def _launch(tmp, script: str, argv_of, world: int, env_of=lambda r: {}):
    """Run ``world`` ranks of ``script`` (argv_of(rank) its arguments,
    env_of(rank) its extra environment) to their end; kill them all when
    the time runs out."""
    path = os.path.join(tmp, "rank.py")
    with open(path, "w") as f:
        f.write(script)
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "AME_TPU_DISTRIBUTED",
              "AME_TPU_COORDINATOR_ADDRESS"):
        base.pop(k, None)
    procs = [subprocess.Popen([sys.executable, path, *argv_of(r)], cwd=REPO,
                              env={**base, **env_of(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def flax_params():
    return jax.tree_util.tree_map(np.asarray, JC.init_params(SEED))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = rng.uniform(0.0, 1.0, (B, 128, 128, 3)).astype(np.float32)
    return images, rng.integers(0, 4, B).astype(np.int64)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, flax_params, batch):
    """layout -> each rank's results of _RANK, run once a layout."""
    done = {}

    def get(dp, tp):
        if (dp, tp) not in done:
            tmp = str(tmp_path_factory.mktemp(f"ranks_{dp}x{tp}"))
            inp = os.path.join(tmp, "in.pt")
            torch.save({"state": convert.mood_cnn_state_dict(flax_params),
                        "images": torch.from_numpy(batch[0]),
                        "labels": torch.from_numpy(batch[1]),
                        "steps": STEPS, "drop_seed": DROP_SEED}, inp)
            store = os.path.join(tmp, "store")
            _launch(tmp, _RANK, lambda r: [store, str(r), str(dp), str(tp),
                                           inp, os.path.join(tmp, f"{r}.pt")],
                    dp * tp)
            done[dp, tp] = [torch.load(os.path.join(tmp, f"{r}.pt"))
                            for r in range(dp * tp)]
        return done[dp, tp]
    return get


def _whole(ranks: list, key: str, dp: int, tp: int) -> dict:
    """The whole parameters from the ranks' slices: the model ranks'
    slices of data index 0 in order along the output features (a leaf of
    the whole shape is replicated and must be equal on every model rank),
    each leaf equal on every data rank."""
    shapes = {n: p.shape for n, p in
              TC.MoodCNN(device="meta").named_parameters()}
    out = {}
    for name in ranks[0][key]:
        for d in range(1, dp):
            for m in range(tp):
                assert torch.equal(ranks[d * tp + m][key][name],
                                   ranks[m][key][name]), name
        parts = [ranks[m][key][name] for m in range(tp)]
        if parts[0].shape == shapes[name]:
            assert all(torch.equal(p, parts[0]) for p in parts), name
            out[name] = parts[0]
        else:
            out[name] = torch.cat(parts)
        assert out[name].shape == shapes[name], name
    return out


def _one_device(state: dict, images, labels, dropout: bool,
                dtype=torch.float64):
    """mood_cnn.make_train_step (dropout off: loss_fn with dropout 0) for
    STEPS steps from ``state`` in ``dtype``: (model, first step's
    gradients, losses)."""
    model = TC.MoodCNN()
    model.load_state_dict(state)
    model.to(dtype)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = TC.make_train_step(opt)
    gen = torch.Generator().manual_seed(DROP_SEED)
    x, y = torch.from_numpy(images).to(dtype), torch.from_numpy(labels)
    grads, losses = None, []
    for _ in range(STEPS):
        if dropout:
            loss = step(model, x, y, gen)[0]
        else:
            opt.zero_grad()
            loss = TC.loss_fn(model, x, y, dropout=0.0)[0]
            loss.backward()
            opt.step()
        losses.append(float(loss))
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return model, grads, losses


@pytest.fixture(scope="module")
def one_device(flax_params, batch):
    """The one-device make_train_step with dropout on from the flax
    parameters: (model, first gradients, losses) in float64, and the
    float32 losses."""
    state = convert.mood_cnn_state_dict(flax_params)
    return (_one_device(state, *batch, dropout=True),
            _one_device(state, *batch, dropout=True,
                        dtype=torch.float32)[2])


# --- init_distributed --------------------------------------------------------------

def test_init_distributed_without_signal_is_a_noop(monkeypatch):
    """tests/test_parallel.py:616-627 on the port: with no launcher's
    environment it returns 1 and starts no process group (it would wait
    for a coordinator on a single-card box)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "AME_TPU_DISTRIBUTED",
              "AME_TPU_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 1
    assert init_distributed(device="cpu") == 1
    assert not torch.distributed.is_initialized()


# --- the layout against ame_tpu's ----------------------------------------------------

# flax leaf -> (port name, the permutation that takes the flax layout to
# torch's: HWIO -> OIHW, [in, out] -> [out, in])
def _flax_leaf(name: str):
    layer, _, kind = name.rpartition(".")
    flax_layer = (f"Conv_{layer[-1]}" if layer.startswith("convs")
                  else f"Dense_{layer[-1]}")
    perm = {4: (3, 2, 0, 1), 2: (1, 0), 1: (0,)}
    return flax_layer, "kernel" if kind == "weight" else "bias", perm


def _torch_spec(spec, perm) -> tuple:
    """A JAX PartitionSpec in the flax layout -> the spec in torch's, one
    entry a dimension."""
    full = tuple(spec) + (None,) * (len(perm) - len(tuple(spec)))
    return tuple(full[p] for p in perm)


@pytest.fixture(scope="module")
def jax_sharded(flax_params):
    """model size -> (JAX mesh, the flax parameters through ame_tpu's
    shard_params on it)."""
    from ame_tpu.parallel.mesh import make_mesh as jax_mesh
    from ame_tpu.parallel.train import shard_params
    out = {}
    for tp, dp in ((2, 4), (3, 2)):
        mesh = jax_mesh({"data": dp, "model": tp})
        out[tp] = mesh, shard_params(flax_params, mesh)
    return out


@pytest.mark.parametrize("tp", [2, 3])
@pytest.mark.parametrize("name", LEAVES)
def test_sharding_rules_match_ame_tpu(name, tp, flax_params, jax_sharded):
    """param_sharding_rules gives the spec of ame_tpu's rules in torch's
    layout, and the placement after shard_params (replicated where the
    dimension does not divide: at 3 model ranks dense1's 4 classes) is
    the placement of ame_tpu's shard_params."""
    from ame_tpu.parallel.train import param_sharding_rules as jax_rules
    jmesh, jparams = jax_sharded[tp]
    layer, kind, perm = _flax_leaf(name)
    leaf = flax_params[layer][kind]
    perm = perm[leaf.ndim]
    mesh = make_mesh({"data": jmesh.shape["data"], "model": tp},
                     devices=["cpu"] * (jmesh.shape["data"] * tp))
    t = convert.mood_cnn_state_dict(flax_params)[name]
    path = (jax.tree_util.DictKey(layer), jax.tree_util.DictKey(kind))
    want = _torch_spec(jax_rules(path, jnp.asarray(leaf), jmesh), perm)
    got = T.param_sharding_rules(name, t, mesh)
    assert got + (None,) * (t.ndim - len(got)) == want
    placed = _torch_spec(jparams[layer][kind].sharding.spec, perm)
    d = T._split_dim(name, t, mesh)
    assert tuple("model" if i == d else None for i in range(t.ndim)) \
        == placed


@pytest.mark.parametrize("rank", range(8))
def test_rank_slices_match_ame_tpu_shards(rank, runs, jax_sharded):
    """At (data 4, model 2) each rank's slices after shard_params (in its
    own process) are the addressable shards of ame_tpu's shard_params on
    the mesh's device at the same flat index."""
    jmesh, jparams = jax_sharded[2]
    device = list(jmesh.devices.flat)[rank]
    got = runs(4, 2)[rank]["init"]
    for name in LEAVES:
        layer, kind, perm = _flax_leaf(name)
        leaf = jparams[layer][kind]
        (shard,) = [s for s in leaf.addressable_shards if s.device == device]
        want = np.transpose(np.asarray(shard.data), perm[leaf.ndim])
        np.testing.assert_array_equal(got[name].numpy(), want,
                                      err_msg=name)


# --- the sharded step ----------------------------------------------------------------

def test_world_of_one_runs_without_collectives(batch):
    """Without a process group (world size 1) the step is the one-device
    make_train_step, bit for bit, dropout on; init_fn(seed) is
    init_params(seed); a mesh larger than the world raises."""
    assert not torch.distributed.is_initialized()
    mesh = make_mesh({"data": 1, "model": 1}, devices=["cpu"])
    init_fn, step_fn, place_batch = T.make_sharded_train_step(mesh, 1e-3)
    params, opt = init_fn(3)
    model = TC.init_params(3)
    for a, b in zip(params.parameters(), model.parameters()):
        assert torch.equal(a, b)
    step = TC.make_train_step(torch.optim.Adam(model.parameters(), lr=1e-3))
    images, labels = batch
    x, y = place_batch(images, labels)
    g1, g2 = (torch.Generator().manual_seed(1) for _ in range(2))
    for _ in range(2):
        loss = step_fn(params, opt, x, y, g1)[2]
        want = step(model, torch.from_numpy(images),
                    torch.from_numpy(labels), g2)[0]
        assert loss.item() == want.item()
    for a, b in zip(params.parameters(), model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="world"):
        T.make_sharded_train_step(
            make_mesh({"data": 2, "model": 1}, devices=["cpu"] * 2))


@pytest.mark.parametrize("dp,tp", LAYOUTS)
def test_sharded_step_matches_one_device_with_dropout(dp, tp, runs,
                                                      one_device):
    """dp x tp ranks over gloo with dropout on (each rank draws the global
    mask and takes its rows and columns) == the one-device
    make_train_step on the whole batch: the first gradients within 1e-9 of
    each leaf's largest entry and the parameters after 3 steps within 1e-5
    (float64), the float32 losses within rtol 1e-5, and every rank reports
    the same global loss. A gather whose backward summed over 'model'
    would double a sharded layer's gradients at 2 model ranks."""
    ranks = runs(dp, tp)
    (model, grads, losses), losses32 = one_device
    want = model.state_dict()
    got, got_grad = (_whole(ranks, k, dp, tp) for k in ("dropout",
                                                        "dropout_grad"))
    for name in LEAVES:
        g = grads[name].numpy()
        np.testing.assert_allclose(got_grad[name].numpy(), g, rtol=0,
                                   atol=1e-9 * np.abs(g).max(),
                                   err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(ranks[0]["dropout_losses"], losses,
                               rtol=1e-12)
    np.testing.assert_allclose(ranks[0]["f32_losses"], losses32, rtol=1e-5)
    for r in ranks:
        for key in ("dropout_losses", "f32_losses"):
            assert r[key] == ranks[0][key]


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2)])
def test_sharded_step_matches_optax(dp, tp, runs, flax_params, batch):
    """With dropout off, 3 sharded Adam steps == optax's Adam on the flax
    loss (tests/test_torch_train.py's test-local loss), both in float64,
    within 1e-5."""
    images, labels = batch
    with jax.enable_x64(True):
        def flax_loss(params):
            logits = JC.MoodCNN().apply(
                {"params": params}, jnp.asarray(images, jnp.float64),
                train=False)
            one_hot = jax.nn.one_hot(labels, len(JC.MOOD_CLASSES))
            return -jnp.mean(jnp.sum(one_hot * jax.nn.log_softmax(logits),
                                     -1))
        opt = optax.adam(1e-3)
        p = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), flax_params)
        state = opt.init(p)
        for _ in range(STEPS):
            upd, state = opt.update(jax.grad(flax_loss)(p), state, p)
            p = optax.apply_updates(p, upd)
        p = jax.tree_util.tree_map(np.asarray, p)
    want = _as_state64(p)
    got = _whole(runs(dp, tp), "plain", dp, tp)
    for name in LEAVES:
        assert got[name].dtype == torch.float64
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def _as_state64(params) -> dict:
    """The flax tree as numpy in MoodCNN's state-dict layout
    (convert.mood_cnn_state_dict's, without its float32 cast)."""
    out = {}
    for i in range(3):
        layer = params[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = np.transpose(layer["kernel"],
                                                (3, 2, 0, 1))
        out[f"convs.{i}.bias"] = layer["bias"]
    for j in range(2):
        layer = params[f"Dense_{j}"]
        out[f"dense{j}.weight"] = layer["kernel"].T
        out[f"dense{j}.bias"] = layer["bias"]
    return out


def test_sharded_step_learns_and_init_fn_is_init_params(runs):
    """tests/test_parallel.py:64-87 on the port, at (4, 2): from init_fn(0)
    on one batch with one dropout mask the loss falls; init_fn gave each
    rank its slice of init_params(0)."""
    ranks = runs(4, 2)
    losses = ranks[0]["descend"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for r in ranks:
        assert r["descend"] == losses
    mesh = make_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    model = TC.init_params(0)
    for rank, r in enumerate(ranks):
        want = T.shard_params(model, mesh, rank)
        for name, p in want.named_parameters():
            assert torch.equal(r["init_fn"][name], p), (rank, name)


# --- train_mood.main at W = 2 ------------------------------------------------------

@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """train_mood.main over 2 gloo ranks for 1 epoch, then resumed to 2,
    and in this process at W = 1 for 1 epoch; all at a global batch of
    4."""
    tmp = str(tmp_path_factory.mktemp("train_main"))
    data = os.path.join(tmp, "data")
    synth_corpus.generate(data, per_class=1, seconds=3.0)
    out = {}
    for epochs in (1, 2):
        run = os.path.join(tmp, f"w2_{epochs}")
        os.makedirs(run)
        weights = os.path.join(run, "w.msgpack")
        args = [data, "--batch", "4", "--epochs", str(epochs),
                "--checkpoint-dir", os.path.join(tmp, "ck"), "--out",
                weights, "--device", "cpu"]
        store = os.path.join(run, "store")
        logs = _launch(run, _MAIN,
                       lambda r: [os.path.join(run, f"{r}.pt")] + args, 2,
                       lambda r: {"AME_TPU_COORDINATOR_ADDRESS":
                                  f"file://{store}", "WORLD_SIZE": "2",
                                  "RANK": str(r), "LOCAL_RANK": str(r)})
        out[epochs] = {
            "ranks": [torch.load(os.path.join(run, f"{r}.pt"))
                      for r in range(2)],
            "logs": [err for _, err in logs],
            "weights": _msgpack.load(weights),
            "ck": sorted(os.listdir(os.path.join(tmp, "ck")))}
    one = os.path.join(tmp, "w1.msgpack")
    assert train_mood.main([data, "--batch", "4", "--epochs", "1", "--out",
                            one, "--device", "cpu"]) == 0
    out["w1"] = _msgpack.load(one)
    return out


def test_train_main_ranks_agree_and_only_rank0_writes(main_runs):
    """Both ranks end with the same parameters; rank 0 alone logged the
    epochs and wrote the checkpoints and the weights (which are those
    parameters)."""
    for epochs, run in ((1, main_runs[1]), (2, main_runs[2])):
        a, b = run["ranks"]
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
        assert (a["weights"], a["checkpoints"]) == (1, 1)
        assert (b["weights"], b["checkpoints"]) == (0, 0)
        assert f"epoch {epochs - 1}: loss" in run["logs"][0]
        assert "epoch " not in run["logs"][1]
        want = convert.mood_cnn_params(a["params"])
        for layer, leaves in want.items():
            for k, v in leaves.items():
                np.testing.assert_array_equal(run["weights"][layer][k], v)
    assert main_runs[1]["ck"] == ["ckpt_0.pt"]


def test_train_main_two_ranks_equal_one(main_runs):
    """W = 2 at a global batch of 4 (two rows a rank) == W = 1 at batch 4
    after an epoch, within 1e-5."""
    got, want = main_runs[1]["weights"], main_runs["w1"]
    for layer, leaves in want.items():
        for k, v in leaves.items():
            np.testing.assert_allclose(got[layer][k], v, rtol=0, atol=1e-5,
                                       err_msg=f"{layer}/{k}")


def test_train_main_resumes_over_two_ranks(main_runs):
    """The second W = 2 run restores the checkpoint on both ranks and
    trains epoch 1 only: a new checkpoint, other weights, ranks equal."""
    assert main_runs[2]["ck"] == ["ckpt_0.pt", "ckpt_1.pt"]
    first, second = main_runs[1]["weights"], main_runs[2]["weights"]
    assert not np.array_equal(first["Dense_1"]["kernel"],
                              second["Dense_1"]["kernel"])

"""Sharded mood-CNN training step: data parallelism over the batch and
tensor parallelism over every layer's output features (mesh axes 'data' x
'model'), on ``torch.distributed`` (port of ``ame_tpu/parallel/train.py``).

One process a rank (``mesh.init_distributed``); rank r is the mesh's flat
row-major entry r, as JAX orders a ``make_mesh`` mesh's devices, so rank r
sits at data index r // model and model index r % model, and computes on
``mesh.devices.flat[r]``. Without a process group (world size 1) the same
code runs with no collective.

* Layout (``param_sharding_rules``, JAX's rules): a layer's weight and bias
  are split over 'model' along the output features (the first dimension
  of torch's ``[out, in]`` and ``[out, in, kh, kw]``); a parameter whose
  dimension does not divide is replicated. Each rank holds only its slice.
* Forward: a sharded layer computes its output slice from the whole
  input, its pointwise tail (ReLU, max pool; for the last convolution also
  the global average pool) runs on the slice, and the slices are gathered
  over 'model' after the tail, which moves 4x fewer bytes than before the
  pool. Every model rank then runs the same computation on the gathered
  activation, so the gather's backward takes the rank's slice of the
  gradient without summing (``_Gather``), and a sharded layer's input,
  whose gradient each rank holds only for its own features, sums it over
  'model' (``_Replicated``).
* Data: ``place_batch`` gives a rank its rows of the global batch; after
  the backward the gradients are averaged over 'data' (one all-reduce),
  and ``torch.optim.Adam`` steps each rank's shards (Adam is elementwise,
  so the sharded update is the whole one). The step returns the global
  loss and accuracy on every rank.
* Dropout: each rank draws the mask at the global [B, 128] shape from the
  same ``torch.Generator`` and takes its rows and columns, so a dp x tp
  step equals ``mood_cnn.make_train_step`` on the whole batch.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ame_tpu_torch import precision
from ame_tpu_torch.models import mood_cnn


def param_sharding_rules(name: str, leaf: torch.Tensor, mesh) -> tuple:
    """The tensor-parallel layout of one ``MoodCNN`` parameter (its
    state-dict name and tensor) as a spec of one entry a dimension,
    'model' where it is split over the model axis, None elsewhere; ()
    replicated. Dense and conv kernels split their output features, a bias
    where 'model' divides it; ``shard_params`` replicates a kernel whose
    features do not divide."""
    if leaf.ndim == 2:                  # dense kernel [out, in]
        return ("model", None)
    if leaf.ndim == 4:                  # conv kernel [out, in, kh, kw]
        return ("model", None, None, None)
    if leaf.ndim == 1 and "bias" in name:
        return ("model",) if leaf.shape[0] % mesh.shape["model"] == 0 else ()
    return ()


def _split_dim(name: str, leaf: torch.Tensor, mesh):
    """The dimension of the whole ``leaf`` split over 'model', or None:
    replicated by the rules, where it does not divide, or with one model
    rank."""
    spec = param_sharding_rules(name, leaf, mesh)
    tp = mesh.shape["model"]
    if tp == 1 or "model" not in spec:
        return None
    d = spec.index("model")
    return d if leaf.shape[d] % tp == 0 else None


def _rank(rank):
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def shard_params(model: mood_cnn.MoodCNN, mesh, rank: int | None = None):
    """A copy of ``model`` that holds only ``rank``'s slice of each
    parameter (default: this process's rank), on the model's device."""
    tp = mesh.shape["model"]
    m = _rank(rank) % tp
    out = copy.deepcopy(model)
    for name, p in list(out.named_parameters()):
        d = _split_dim(name, p, mesh)
        if d is None:
            continue
        size = p.shape[d] // tp
        owner, _, attr = name.rpartition(".")
        setattr(out.get_submodule(owner), attr, nn.Parameter(
            p.detach().narrow(d, m * size, size).clone()))
    return out


class _Gather(torch.autograd.Function):
    """All-gather of each model rank's slice along ``dim``. The backward
    takes this rank's slice of the gradient WITHOUT summing: every model
    rank runs the same computation after the gather, so each already holds
    the whole gradient (a backward that reduce-scatters with a sum, as
    ``torch.distributed.nn.functional.all_gather``'s does, gives each
    slice tp times its gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        size = g.shape[ctx.dim] // n
        return (g.narrow(ctx.dim, dist.get_rank(ctx.group) * size,
                         size).contiguous(), None, None)


class _Replicated(torch.autograd.Function):
    """The input of a sharded layer, which every model rank holds whole:
    identity forward; the backward sums the gradient over the model ranks,
    since each rank's layer gives only its own output features' part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _axis_groups(dp: int, tp: int, rank: int):
    """(data group, model group) of ``rank``: every rank creates every
    group in one order, as ``new_group`` requires; no model group with one
    model rank."""
    data = model = None
    for m in range(tp):
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data = g
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if rank // tp == d:
                model = g
    return data, model


def _all_mean(tensors: list, group, n: int) -> None:
    """Average ``tensors`` in place over ``group``'s n ranks, as one
    all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def make_sharded_train_step(mesh, learning_rate: float = 1e-3):
    """(init_fn, step_fn, place_batch) for this process's rank of ``mesh``
    (a ``parallel/mesh.Mesh`` with axes 'data' and 'model' whose size is
    the world size):

      init_fn(seed=0) -> (params, optimizer): ``mood_cnn.init_params(seed)``
        (the same whole model on every rank) sliced by ``shard_params``,
        and ``torch.optim.Adam`` over the slices;
      step_fn(params, optimizer, batch, labels, generator)
          -> (params, optimizer, loss, acc): one Adam step on the global
        batch (this rank's rows from ``place_batch``); loss and acc are
        the global batch's, on every rank; the dropout mask comes from
        ``generator`` (on the rank's device), one draw a step at the
        global batch's shape;
      place_batch(batch, labels) -> this rank's rows of a global batch
        ([B, 128, 128, 3] images in the parameters' float dtype, [B]
        labels; B divisible by the data axis) on its device."""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh over a world of {world} "
                         f"process(es); init_distributed first")
    rank = _rank(None)
    di, mi = divmod(rank, tp)
    device = torch.device(mesh.devices.flat[rank])
    data_group, model_group = (_axis_groups(dp, tp, rank)
                               if dist.is_initialized() else (None, None))
    template = mood_cnn.MoodCNN(device="meta")
    sharded = {name.rpartition(".")[0] for name, p in
               template.named_parameters()
               if _split_dim(name, p, mesh) is not None}

    def enter(x, layer: str):
        if layer in sharded and x.requires_grad:
            return _Replicated.apply(x, model_group)
        return x

    def leave(y, layer: str):
        return _Gather.apply(y, model_group, 1) if layer in sharded else y

    def forward(params, images, generator, dropout):
        x = images.permute(0, 3, 1, 2)
        last = len(params.convs) - 1
        for i, conv in enumerate(params.convs):
            y = F.conv2d(enter(x, f"convs.{i}"), conv.weight, conv.bias,
                         padding=1)
            y = F.max_pool2d(F.relu(y), 2)
            if i == last:
                y = y.mean(dim=(2, 3))           # global average pool
            x = leave(y, f"convs.{i}")
        h = F.relu(F.linear(enter(x, "dense0"), params.dense0.weight,
                            params.dense0.bias))
        if dropout > 0.0:
            b, c = h.shape
            split = "dense0" in sharded
            mask = mood_cnn._keep_mask((b * dp, c * (tp if split else 1)),
                                       dropout, generator, h.device)
            mask = mask[di * b:(di + 1) * b]
            if split:
                mask = mask[:, mi * c:(mi + 1) * c]
            h = mood_cnn._apply_dropout(h, mask, dropout)
        h = leave(h, "dense0")
        return leave(F.linear(enter(h, "dense1"), params.dense1.weight,
                              params.dense1.bias), "dense1")

    def init_fn(seed: int = 0):
        params = shard_params(mood_cnn.init_params(seed), mesh, rank)
        params = params.to(device)
        return params, torch.optim.Adam(params.parameters(),
                                        lr=learning_rate)

    def step_fn(params, optimizer, batch, labels, generator,
                dropout: float = mood_cnn.DROPOUT):
        precision.apply()
        optimizer.zero_grad(set_to_none=True)
        logits = forward(params, batch, generator, dropout)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        loss.backward()
        stats = torch.stack([loss.detach(), acc])
        if data_group is not None:
            _all_mean([p.grad for p in params.parameters()], data_group, dp)
            _all_mean([stats], data_group, dp)
        optimizer.step()
        return params, optimizer, stats[0], stats[1]

    def place_batch(batch, labels):
        b = batch.shape[0]
        if b % dp:
            raise ValueError(f"a batch of {b} does not split over the "
                             f"mesh's {dp} data ranks")
        rows = slice(di * (b // dp), (di + 1) * (b // dp))
        return (torch.as_tensor(batch[rows]).to(device),
                torch.as_tensor(labels[rows]).to(device, torch.int64))

    return init_fn, step_fn, place_batch

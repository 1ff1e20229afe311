"""Data and tensor parallelism over processes (counterpart of
vlgae_tpu/parallel/mesh.py).

One process per device under ``torchrun``: NCCL on ``cuda:LOCAL_RANK``,
gloo when the caller asks for the CPU. Every rank draws the same global
batch from the same seeded sampler, pads it as the JAX package pads its
batches (:func:`pad_batch_to_devices`) and uploads only its contiguous
slice of rows (:func:`shard_batch`), so which sentences share a batch and
which filler rows take part in the cross-image argmax are the JAX
package's. Parameters start equal on every rank (:func:`replicate`); the
gradient all-reduce that XLA derives from the shardings is one bucketed
``all_reduce(SUM)`` after backward and before the clip
(:func:`all_reduce_grads`), because the loss each rank computes is its
share of the global loss and the global gradient is their sum. With
``trainer.fsdp`` the large leaves and their Adam moments are sharded with
FSDP2 (:func:`shard_params`, by the JAX package's shape rule
:func:`fsdp_leaf_spec`); the small leaves stay whole and take the same
all-reduce. Metric states are summed (:func:`sum_across_processes`) and
predictions merged by sample id (:func:`gather_predictions`).

With ``trainer.model_parallel = m`` the world splits into a ``(data,
model)`` grid as the JAX package reshapes its devices, ``n // m`` rows of
``m`` adjacent ranks (:func:`split_mesh`): a data group (the ranks of one
model rank, which split the batch) and a model group (the ``m`` ranks that
hold the same rows). :data:`DEFAULT_MODEL_RULES` shards the visual factor
heads column-parallel and ``vis_mlp_pre_matching`` row-parallel over the
model group (:func:`tensor_parallel`), Megatron style: the heads' input is
copied in (its gradient summed over the model group, :func:`copy_to_model`),
the row-parallel product is summed (:func:`reduce_from_model`) and the
pre-projection features that the text side reads whole are gathered
(:func:`gather_from_model`). The batch split, the gradient sum, the
sharded matching and the metric and prediction merges span the data group
only; FSDP shards only what no tensor-parallel rule takes, over the data
group; checkpoints hold every leaf whole.

Without ``torchrun``'s variables the world is one process with no process
group, and every helper here is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace
from ..utils.pinned import host_empty, is_pinned, pinned_rows


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """This process's place in the data-parallel world: its rank, the world
    size, the ``torch.distributed`` group (``None`` in a single process
    without ``torchrun``) and its device."""

    rank: int = 0
    world: int = 1
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")

    @property
    def sharded(self) -> bool:
        """Whether the batch is split over more than one process."""
        return self.world > 1

    def rows(self, batch_size: int):
        """``(start, stop)``: this rank's contiguous rows of a global batch
        of ``batch_size`` (a multiple of the world size)."""
        if batch_size % self.world:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.world} processes")
        n = batch_size // self.world
        return self.rank * n, (self.rank + 1) * n


def init_distributed(device: torch.device,
                     timeout: datetime.timedelta = datetime.timedelta(minutes=10)
                     ) -> DataGroup:
    """The data group of this process. Under ``torchrun`` (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` set) it joins, or reuses, the default
    process group: NCCL on ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo
    for ``cpu``; a group that cannot be reached raises (the run never goes
    on at world 1). Without those variables it is world 1, no group, on
    ``device``."""
    device = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return DataGroup(0, 1, None, device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism runs on cuda or cpu, not {device}")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=timeout,
                                device_id=device if backend == "nccl" else None)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"device {device} needs {backend}")
    return DataGroup(dist.get_rank(), dist.get_world_size(), dist.group.WORLD, device)


def data_parallel_mesh(dp: DataGroup):
    """The 1-D ``("data",)`` device mesh over the group's processes."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dp.device.type, (dp.world,), mesh_dim_names=("data",))


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """This process's place on the model axis: its rank among the ``size``
    processes that hold the same rows, and their group (``None`` when the
    axis has one process)."""

    rank: int = 0
    size: int = 1
    group: Optional[dist.ProcessGroup] = None

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def cols(self, n: int) -> Tuple[int, int]:
        """``(start, stop)``: this rank's contiguous slice of ``n`` features."""
        if n % self.size:
            raise ValueError(f"{n} features do not split over model={self.size}")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def split_mesh(world: DataGroup, model: int = 1):
    """``(data group, model group, device mesh)`` of a world of processes laid
    out as the JAX package's ``("data", "model")`` mesh: ``world // model``
    rows of ``model`` adjacent ranks. ``model=1`` is the world itself as the
    data group (no mesh). A world that ``model`` does not divide raises the
    JAX package's ``ValueError``."""
    model = max(1, int(model))
    if world.world % model:
        raise ValueError(f"{world.world} devices not divisible by model={model}")
    if model == 1:
        return world, ModelGroup(), None
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(world.device.type, (world.world // model, model),
                            mesh_dim_names=("data", "model"))
    dp = DataGroup(mesh.get_local_rank("data"), world.world // model,
                   mesh.get_group("data"), world.device)
    mp = ModelGroup(mesh.get_local_rank("model"), model, mesh.get_group("model"))
    return dp, mp, mesh


# -- batches --------------------------------------------------------------------
def pad_batch_to_devices(batch: dict, n_devices: int, pow2: bool = False,
                         min_b: int = 8):
    """Pad the batch axis to a multiple of ``n_devices``; with ``pow2`` first
    to the next power of two (at least ``min_b``). Filler rows replicate row
    0 with ``seq_len`` zeroed; losses mask zero-length rows. An array in
    page-locked memory is padded into page-locked memory. Returns
    ``(batch, real_size)``."""
    some = next(iter(batch.values()))
    B = some.shape[0]
    target = B
    if pow2:
        target = max(min_b, 1 << (B - 1).bit_length())
    target = target + ((-target) % n_devices)
    pad = target - B
    if pad == 0:
        return batch, B
    out = {}
    with trace.span("vlgae.data.pad"):
        for k, v in batch.items():
            filler = np.repeat(np.asarray(v[:1]), pad, axis=0)
            if k == "seq_len":
                filler = np.zeros_like(filler)
            if is_pinned(v):
                padded = host_empty((target,) + v.shape[1:], v.dtype)
                padded[:B], padded[B:] = v, filler
                out[k] = padded
            else:
                out[k] = np.concatenate([np.asarray(v), filler], axis=0)
    return out, B


def shard_batch(batch: Dict[str, np.ndarray], dp: DataGroup) -> Dict[str, torch.Tensor]:
    """This rank's contiguous rows of a padded host batch, on its device
    (the whole batch at world 1). Every copy is ``non_blocking`` on the
    current stream: rows in page-locked memory are copied asynchronously
    from a view of their pinned tensor (the caching host allocator keeps
    the block until the copy is done), pageable ones are staged by CUDA
    into its own buffer before the call returns. Counts ``upload.bytes``
    and, of them, ``upload.pageable_bytes``."""
    B = next(iter(batch.values())).shape[0]
    start, stop = dp.rows(B)
    out = {}
    with trace.span("vlgae.upload"):
        for k, v in batch.items():
            rows = np.asarray(v)[start:stop]
            src = pinned_rows(rows)
            if src is None:
                src = torch.as_tensor(rows)
                trace.count("upload.pageable_bytes", rows.nbytes)
            trace.count("upload.bytes", rows.nbytes)
            out[k] = src.to(dp.device, non_blocking=True)
    return out


# -- collectives with autograd --------------------------------------------------------
class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward reduce-scatters the cotangent
    (a sum over ranks, in its own dtype)."""

    @staticmethod
    def forward(ctx, x, group, world):
        ctx.group, ctx.world = group, world
        x = x.contiguous()
        out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0] // ctx.world,) + tuple(grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        return out, None, None


class _SumAcross(torch.autograd.Function):
    """All-reduce (sum); every rank's loss reads the sum, so the backward
    sums the cotangents too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order (``x`` itself at world 1),
    differentiable."""
    return _GatherRows.apply(x, dp.group, dp.world) if dp.sharded else x


def sum_across(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable."""
    return _SumAcross.apply(x, dp.group) if dp.sharded else x


def global_sum(x: torch.Tensor, dp) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``dp`` (a data or a model group),
    outside autograd (counts, normalisers, norms)."""
    if not dp.sharded:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=dp.group)
    return out


def global_max(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """The elementwise max of ``x`` over ranks, outside autograd."""
    if not dp.sharded:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=dp.group)
    return out


def log_softmax_across(x: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """``log_softmax(x, 0)`` where dim 0 is split over the ranks: the
    log-sum-exp of the whole axis (max, then the summed exponentials, the
    sum differentiable)."""
    if not dp.sharded:
        return torch.log_softmax(x, 0)
    m = global_max(x.detach().amax(0), dp)
    lse = m + torch.log(sum_across(torch.exp(x - m).sum(0), dp))
    return x - lse


# -- collectives over the model group ------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the cotangent over the model group (the
    input of column-parallel layers, each rank's share of its gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce (sum) over the model group (the partial products of a
    row-parallel layer); every rank's consumer is the same, so the backward
    is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last axis over the model group, in rank order; the
    backward keeps this rank's columns of the (same on every rank)
    cotangent."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        x = x.contiguous()
        parts = x.new_empty((mp.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(parts, x, group=mp.group)
        return torch.cat(parts.chunk(mp.size, 0), -1)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.mp.cols(grad.shape[-1])
        return grad[..., start:stop].contiguous(), None


def copy_to_model(x: torch.Tensor, mp: ModelGroup) -> torch.Tensor:
    """``x``; its gradient summed over the model group."""
    return _CopyToModel.apply(x, mp.group) if mp.sharded else x


def reduce_from_model(x: torch.Tensor, mp: ModelGroup) -> torch.Tensor:
    """The sum of ``x`` over the model group, differentiable."""
    return _ReduceFromModel.apply(x, mp.group) if mp.sharded else x


def gather_from_model(x: torch.Tensor, mp: ModelGroup) -> torch.Tensor:
    """Every model rank's columns (last axis) of ``x``, differentiable."""
    return _GatherFromModel.apply(x, mp) if mp.sharded else x


# -- parameters -------------------------------------------------------------------
def replicate(model: torch.nn.Module, dp: DataGroup) -> None:
    """Broadcast rank 0's parameters and buffers to every rank."""
    if dp.group is None:
        return
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src=0, group=dp.group)


# The model axis of the JAX package's DEFAULT_MODEL_RULES on the port's
# parameter names: the output features of the visual factor heads under
# vis_encoder (box_fc, rel_fc with rel_fc_bias, attr_fc, img_fc; for the ViT
# encoder its head, never the backbone) are column-parallel, the input
# features of vis_mlp_pre_matching row-parallel. A rule gives the axis of the
# torch tensor that is sharded (a Linear's weight is [out, in]).
DEFAULT_MODEL_RULES: Tuple[Tuple[str, int], ...] = (
    (r"(.*\.)?vis_encoder\.(.*\.)?(box_fc|rel_fc|attr_fc|img_fc)(\.[^.]+)?\.(weight|bias)", 0),
    (r"(.*\.)?vis_encoder\.(.*\.)?rel_fc_bias", 0),
    (r"(.*\.)?vis_mlp_pre_matching\.weight", 1),
)


def param_spec(name: str, rules=DEFAULT_MODEL_RULES) -> Optional[int]:
    """The axis the parameter ``name`` is sharded on over the model group
    (the first rule that matches the whole name), ``None`` if none does."""
    for pattern, axis in rules:
        if re.fullmatch(pattern, name):
            return axis
    return None


def tensor_parallel(model: torch.nn.Module, mp: ModelGroup) -> Dict[str, int]:
    """Keep this model rank's slice of each parameter of
    :data:`DEFAULT_MODEL_RULES` (whole on entry, the same on every rank) and
    hand the model group to the modules that communicate over it (those
    with a ``set_model_group`` method: the column-parallel heads and the
    joint model). A sharded parameter carries ``tp = (axis, mp)``. Returns
    ``{name: axis}``; nothing at ``mp.size == 1``."""
    if not mp.sharded:
        return {}
    sharded = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            axis = param_spec(name)
            if axis is None:
                continue
            start, stop = mp.cols(p.shape[axis])
            p.data = p.data.narrow(axis, start, stop - start).clone()
            p.tp = (axis, mp)
            sharded[name] = axis
    for m in model.modules():
        if hasattr(m, "set_model_group"):
            m.set_model_group(mp)
    return sharded


def tp_spec(t) -> Optional[tuple]:
    """``(axis, model group)`` of a tensor-parallel parameter, else ``None``."""
    return getattr(t, "tp", None)


def fsdp_leaf_spec(shape, dp: int, min_size: int = 1 << 16) -> Optional[int]:
    """The axis a leaf of ``shape`` is sharded on over ``dp`` processes (the
    JAX package's ZeRO rule): the largest axis divisible by ``dp`` (the
    first of equal ones), for leaves of at least ``min_size`` elements;
    ``None`` (the leaf stays whole) for small or indivisible leaves."""
    shape = tuple(shape)
    if dp <= 1 or len(shape) == 0 or int(np.prod(shape)) < min_size:
        return None
    for a in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[a] % dp == 0:
            return a
    return None


def shard_params(model: torch.nn.Module, dp: DataGroup, min_size: int = 1 << 16,
                 mesh=None):
    """FSDP2 (``fully_shard``) over the data mesh (the ``"data"`` axis of a
    2-D ``mesh`` under tensor parallelism): each leaf of
    :func:`fsdp_leaf_spec` that no tensor-parallel rule took becomes a
    DTensor sharded on that axis; the rest stay as they are (FSDP's
    ``ignored_params``; their gradients take :func:`all_reduce_grads`, which
    also turns the mean of FSDP's gradient reduce-scatter into the sum).
    Returns the set of sharded parameters: empty at data world 1, where the
    rule shards nothing and the model stays as it is."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    if dp.group is None:
        raise ValueError("trainer.fsdp needs a process group (launch with torchrun)")
    axes = {p: None if tp_spec(p) else fsdp_leaf_spec(p.shape, dp.world, min_size)
            for p in model.parameters()}
    whole = {p for p, a in axes.items() if a is None}
    if whole == set(axes):
        return set()
    fully_shard(model, mesh=mesh["data"] if mesh is not None else data_parallel_mesh(dp),
                shard_placement_fn=lambda p: Shard(axes[p]), ignored_params=whole)
    return {p for p in model.parameters() if is_sharded(p)}


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor's local shard (its storage), else ``t``."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole value of ``t`` (a collective), laid out as the parameter
    ``like`` (``t`` itself by default) is: a DTensor's full tensor, a
    tensor-parallel slice gathered over the model group, else ``t``."""
    tp = tp_spec(t if like is None else like)
    if tp is not None:
        axis, mp = tp
        parts = [torch.empty_like(t) for _ in range(mp.size)]
        dist.all_gather(parts, t.detach().contiguous(), group=mp.group)
        return torch.cat(parts, axis)
    return t.full_tensor() if is_sharded(t) else t


def shard_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor ``value``, laid out as the
    parameter ``like`` is (``value`` itself for a whole ``like``)."""
    tp = tp_spec(like)
    if tp is not None:
        axis, mp = tp
        start, stop = mp.cols(value.shape[axis])
        return value.narrow(axis, start, stop - start)
    if not is_sharded(like):
        return value
    (placement,) = like.placements
    mesh = like.device_mesh
    return value.chunk(mesh.size(), placement.dim)[mesh.get_local_rank()]


def _whole_shape(t: torch.Tensor, like: torch.Tensor) -> tuple:
    shape = list(t.shape)
    tp = tp_spec(like)
    if tp is not None:
        shape[tp[0]] *= tp[1].size
    return tuple(shape)


def full_shapes(model: torch.nn.Module) -> Dict[str, tuple]:
    """The whole shape of every entry of ``model.state_dict()``."""
    params = dict(model.named_parameters())
    return {k: _whole_shape(v, params.get(k, v)) for k, v in model.state_dict().items()}


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded leaf gathered whole, on the
    CPU: the same dict at every world size and ``(data, model)`` shape, with
    FSDP or without."""
    params = dict(model.named_parameters())
    return {k: full_tensor(v, params.get(k)).detach().cpu()
            for k, v in model.state_dict().items()}


def load_full_state_dict(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Load a whole state dict (strict) into ``model``, each sharded leaf
    taking its shard."""
    own = model.state_dict()
    params = dict(model.named_parameters())
    missing, unexpected = set(own) - set(state), set(state) - set(own)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    whole = full_shapes(model)
    wrong = [k for k in own if tuple(state[k].shape) != whole[k]]
    if wrong:
        raise ValueError("state dict shape mismatch: " + ", ".join(
            f"{k} {tuple(state[k].shape)} vs {whole[k]}" for k in wrong))
    with torch.no_grad():
        for k, t in own.items():
            like = params.get(k, t)
            value = state[k].to(device=t.device, dtype=t.dtype)
            local(t).copy_(shard_like(value, like))


# -- gradients ---------------------------------------------------------------------
def all_reduce_grads(params: List[torch.Tensor], dp: DataGroup) -> None:
    """Sum the gradients over ranks: those of the whole (unsharded)
    parameters by one all-reduce of a flat bucket a dtype; sharded ones were
    reduce-scattered in backward as a mean over the ranks (FSDP's default,
    the only one gloo takes), which is scaled back to the sum here. Every
    gradient must be set (zeros where none flowed)."""
    if dp.group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if is_sharded(p):
            local(p.grad).mul_(dp.world)
        else:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=dp.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


# -- metrics and predictions ----------------------------------------------------------
def sum_across_processes(vec, dp: DataGroup) -> np.ndarray:
    """Sum a host vector (metric states, loss sums) over ranks (float64)."""
    vec = np.asarray(vec, dtype=np.float64)
    if dp.group is None:
        return vec
    t = torch.as_tensor(vec, device=dp.device)
    dist.all_reduce(t, group=dp.group)
    return t.cpu().numpy()


def merge_outputs(outputs_per_rank: List[dict]) -> dict:
    """Merge per-rank output dicts keyed by field, then sample id."""
    merged: dict = {}
    for rank_out in outputs_per_rank:
        for key, id2val in rank_out.items():
            merged.setdefault(key, {}).update(id2val)
    return merged


def gather_predictions(outputs: dict, dp: DataGroup) -> dict:
    """Every rank's predictions by sample id, merged, on every rank."""
    if dp.group is None:
        return outputs
    gathered = [None] * dp.world
    dist.all_gather_object(gathered, outputs, group=dp.group)
    return merge_outputs([{"outputs": d} for d in gathered])["outputs"]


def barrier(dp: DataGroup) -> None:
    if dp.group is not None:
        dist.barrier(group=dp.group)


def rank0_value(value, dp: DataGroup):
    """Rank 0's ``value`` (a picklable object) on every rank."""
    if dp.group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=dp.group)
    return box[0]


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()

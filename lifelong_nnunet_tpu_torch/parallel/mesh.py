"""The data x model grid of ranks: the port of
``lifelong_nnunet_tpu/parallel/mesh.py``.

The JAX package runs one program over a ``jax.sharding.Mesh`` with axes
``data`` (the batch) and ``model`` (the output features of the conv and
dense kernels), and GSPMD inserts the collectives.  Here every device is a
rank of ``torch.distributed`` (``launch.py`` starts them) and the grid is
explicit: rank ``r`` sits at data index ``r // M`` and model index ``r % M``
(``M = model_parallel``), with one process group per row and per column of
the grid (:func:`make_mesh`).

The sharding rule (:func:`shard_model`) is the JAX ``param_shardings``
rule, written for PyTorch's layouts: a Conv, ConvTranspose or Linear whose
output features number a multiple of M and at least 2 M is sharded over
the model axis, every other parameter replicated.  Conv and Linear weights
keep their output features in dim 0, a ConvTranspose weight in dim 1
(flax keeps them last).  The biases go with their weights, and a
``ConvNormAct`` block's InstanceNorm scale and bias with its conv: the
InstanceNorm is per channel, so the block's fused conv + InstanceNorm +
LeakyReLU kernel runs on its local slice of the channels (a layout choice
of the port; the JAX rule replicates the 1-D tensors).  The seg heads
(3 classes) stay replicated, as in JAX.

:class:`ShardPlan` maps between the full tensors (the registry, the
checkpoints, ``cl_state`` as saved) and a rank's slices.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from .collectives import DataGroup, ModelShard, all_gather_cat


def visible_devices(device_type: str) -> int:
    """The devices of one type this process can see: CUDA devices, or one
    per CPU core."""
    if device_type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def check_devices(n_devices: int, model_parallel: int, visible: int | None) -> int:
    """The JAX trainer's refusals (``training/trainer.py:_setup_spmd``):
    more devices than are visible (``visible`` None: an explicit device
    list, not counted), a model axis that does not divide them.  Returns
    the data-parallel size."""
    mp = max(1, int(model_parallel))
    if visible is not None and visible < n_devices:
        raise RuntimeError(f"n_devices={n_devices} but only {visible} devices visible")
    if n_devices % mp:
        raise RuntimeError(f"model_parallel={mp} must divide n_devices={n_devices}")
    return n_devices // mp


@dataclass(frozen=True)
class RankSource:
    """Where this process sits: node ``node_index`` of ``n_nodes`` (the JAX
    package's process index and count), rank ``local_rank`` of the
    ``local_world`` ranks on it."""
    node_index: int = 0
    n_nodes: int = 1
    local_rank: int = 0
    local_world: int = 1


def rank_source() -> RankSource:
    """From ``torchrun``'s environment (``GROUP_RANK``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``WORLD_SIZE``), which the launcher also sets in
    the ranks it spawns; one process on one node without it."""
    env = os.environ
    if "LOCAL_RANK" not in env or "WORLD_SIZE" not in env:
        return RankSource()
    local_world = int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))
    return RankSource(node_index=int(env.get("GROUP_RANK", env.get("NODE_RANK", 0))),
                      n_nodes=int(env["WORLD_SIZE"]) // local_world,
                      local_rank=int(env["LOCAL_RANK"]), local_world=local_world)


@dataclass
class Mesh:
    """One rank's view of the ``dp`` x ``mp`` grid."""
    dp: int
    mp: int
    rank: int
    data: DataGroup | None     # None when dp == 1
    model: ModelShard | None   # None when mp == 1
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def rows(self, global_batch: int, source: RankSource) -> tuple:
        """This rank's rows ``[lo, hi)`` of its node's share of the global
        batch: the node's data ranks split it contiguously (the ranks of
        one model group share their rows)."""
        if source.local_world % self.mp:
            raise ValueError(f"{source.local_world} ranks on a node do not hold whole model "
                             f"groups of {self.mp}")
        node_batch = global_batch // source.n_nodes
        local_dp = max(1, source.local_world // self.mp)
        i = source.local_rank // self.mp
        if node_batch % local_dp:
            raise ValueError(f"node batch {node_batch} does not split over {local_dp} "
                             "data-parallel ranks")
        per = node_batch // local_dp
        return i * per, (i + 1) * per


def make_mesh(n_devices: int, data_parallel: int, devices=None) -> Mesh:
    """The ``data_parallel`` x ``n_devices // data_parallel`` grid over the
    initialized default process group, which must have ``n_devices`` ranks.
    ``devices``: the ranks' devices, for the refusal of too many devices
    (None: not checked here)."""
    mp = n_devices // data_parallel
    check_devices(n_devices, mp, len(devices) if devices is not None else None)
    if not dist.is_initialized():
        raise RuntimeError(
            f"n_devices={n_devices} needs {n_devices} ranks: start them with "
            "parallel.launch.spawn (the CLIs' -n_devices) or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_devices:
        raise RuntimeError(f"n_devices={n_devices} but the process group has {world} ranks")
    data = model = None
    # every rank creates every group, in the same order (new_group's rule)
    for m in range(mp):
        ranks = [d * mp + m for d in range(data_parallel)]
        g = dist.new_group(ranks) if data_parallel > 1 else None
        if rank in ranks and g is not None:
            data = DataGroup(g, data_parallel, rank // mp)
    for d in range(data_parallel):
        ranks = [d * mp + m for m in range(mp)]
        g = dist.new_group(ranks) if mp > 1 else None
        if rank in ranks and g is not None:
            model = ModelShard(g, mp, rank % mp)
    return Mesh(dp=data_parallel, mp=mp, rank=rank, data=data, model=model,
                backend=dist.get_backend())


# ------------------------------------------------------------------ sharding

_CONV_T = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)
_DENSE = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)


def _units(model: nn.Module) -> list:
    """(module, [(parameter path, feature dim)], output features) of every
    layer the rule may shard: the ``ConvNormAct`` blocks (``MP_PARAMS``)
    and the Conv / ConvTranspose / Linear modules outside them."""
    units, inside = [], []
    for name, mod in model.named_modules():
        if any(name.startswith(p + ".") for p in inside):
            continue
        params = getattr(type(mod), "MP_PARAMS", None)
        if params is not None:
            units.append((name, mod, list(params), mod.conv.out_channels))
            inside.append(name)
        elif isinstance(mod, _CONV_T):
            units.append((name, mod, [("weight", 1), ("bias", 0)], mod.out_channels))
        elif isinstance(mod, _DENSE):
            out = mod.out_features if isinstance(mod, nn.Linear) else mod.out_channels
            units.append((name, mod, [("weight", 0), ("bias", 0)], out))
    return units


def shardable(out_features: int, m: int) -> bool:
    """The JAX rule: a multiple of ``m``, and at least ``2 m``."""
    return m > 1 and out_features % m == 0 and out_features >= 2 * m


class ShardPlan:
    """The sharded parameters of a model ({state_dict key: feature dim}),
    their full shapes, and this rank's ``ModelShard``."""

    def __init__(self, dims: dict, full_shapes: dict, shard: ModelShard):
        self.dims, self.full_shapes, self.shard = dims, full_shapes, shard

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor of parameter ``name``."""
        d = self.dims[name]
        return t.chunk(self.shard.size, dim=d)[self.shard.index].clone()

    def full(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The full tensor of parameter ``name`` from every rank's slice (a
        collective over the model group)."""
        return all_gather_cat(t, self.shard.group, self.shard.size, self.dims[name])

    def _walk(self, tree, leaf):
        if isinstance(tree, dict):
            return {k: (leaf(k, v) if isinstance(v, torch.Tensor) and k in self.dims
                        else self._walk(v, leaf)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._walk(v, leaf) for v in tree)
        return tree

    def localize(self, tree):
        """Every full-shaped tensor under a sharded parameter's key, sliced."""
        return self._walk(tree, lambda k, v: self.local(k, v)
                          if tuple(v.shape) == self.full_shapes[k] else v)

    def globalize(self, tree):
        """Every slice-shaped tensor under a sharded parameter's key,
        gathered (every rank of the model group calls it on the same tree)."""
        return self._walk(tree, lambda k, v: v if tuple(v.shape) == self.full_shapes[k]
                          else self.full(v, k))


def shard_model(model: nn.Module, shard: ModelShard) -> ShardPlan:
    """Replace the parameters the rule shards by this rank's slices (same
    names) and mark their modules (``module.mp``); returns the plan."""
    dims, full = {}, {}
    for name, mod, params, out in _units(model):
        if not shardable(out, shard.size):
            continue
        for path, d in params:
            owner_path, _, pname = path.rpartition(".")
            owner = mod.get_submodule(owner_path) if owner_path else mod
            p = getattr(owner, pname, None)
            if p is None:
                continue
            key = f"{name}.{path}" if name else path
            dims[key], full[key] = d, tuple(p.shape)
            setattr(owner, pname, nn.Parameter(
                p.detach().chunk(shard.size, dim=d)[shard.index].clone(),
                requires_grad=p.requires_grad))
        mod.mp = shard
    return ShardPlan(dims, full, shard)


def param_bytes(model: nn.Module) -> int:
    """The bytes of the parameters this rank holds."""
    return sum(p.numel() * p.element_size() for p in model.parameters())

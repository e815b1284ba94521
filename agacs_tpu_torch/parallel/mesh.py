"""Process groups, the device mesh and the sharding rules (counterpart of
`agacs_tpu/parallel/mesh.py`).

JAX runs one global program over a `Mesh` with axes ("data", "model") and
lets GSPMD insert the collectives. Here each process drives one device
(torchrun's model: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`), the mesh is a `torch.distributed.device_mesh.DeviceMesh`
with the same axes, ranks laid out data-major as `np.reshape(devices,
(n_data, n_model))` lays JAX's devices out, and the collectives are
explicit:

  * data parallelism: each data rank collates its contiguous row block of
    the global batch (`local_batch_rows`), and the trainer all-reduces the
    trainable gradients over "data" (`train/trainer.py`);
  * tensor parallelism over "model" for the whisper family, by JAX's rule
    table (`param_sharding_rules`), applied to the port's parameters under
    their JAX paths (`parallel/tensor_parallel.py`);
  * ZeRO-1: Adam moments sharded over "data" by JAX's `shard_opt_state`
    rule (`parallel/zero.Zero1`, stepped by `train/trainer.py`).

Sequence, pipeline and expert parallelism are absent, as in JAX (its
docstring, :11-14).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")


def torchrun_env() -> bool:
    """Whether torchrun's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device: str | None = None, backend: str | None = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group torchrun's environment describes (the
    counterpart of `jax.distributed.initialize`) and return this process's
    device, set as the current CUDA device: `device` when it names one
    ("cuda:0": several ranks on one card, over gloo), `cuda:LOCAL_RANK`
    for "cuda" or None, or the CPU for "cpu".

    The backend is `backend` when given, else NCCL for CUDA and gloo for
    the CPU. A group that cannot be formed raises (from
    `init_process_group`); nothing here continues as a world of one."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA run without a CUDA device")
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"init_distributed: device {device!r}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    addr, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logging.info("init_distributed: rank %d of %d, local rank %d, backend %s, %s",
                 rank, world, local, backend, dev)
    return dev


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str = "cpu"):
    """A ("data", "model") `DeviceMesh` over the default group's ranks,
    data-major (rank = data_rank * n_model + model_rank), as JAX's
    `make_mesh` reshapes its devices."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"make_mesh: {n_data} x {n_model} != world size {world}")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=MESH_AXES)


@dataclasses.dataclass(frozen=True)
class Parallel:
    """This process's place on the mesh. `mesh` None: one process and no
    process group (every collective below is then the identity)."""

    mesh: Any = None

    @property
    def n_data(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(0)

    @property
    def n_model(self) -> int:
        return 1 if self.mesh is None else self.mesh.size(1)

    @property
    def data_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.get_local_rank("data")

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.get_local_rank("model")

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else dist.get_rank()

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def group(self, axis: str):
        """The process group of `axis` ("data", "model") holding this rank,
        or the default group for "world"; None without a mesh."""
        if self.mesh is None:
            return None
        return dist.group.WORLD if axis == "world" else self.mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place over `axis` ("sum", "mean", "max", "min");
        the mean is the sum over the group's size (gloo has no AVG)."""
        group = self.group(axis)
        if group is None:
            return t
        red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=group)
        if op == "mean":
            t.div_(dist.get_world_size(group))
        return t

    def all_gather_object(self, obj: Any, axis: str) -> list:
        group = self.group(axis)
        if group is None:
            return [obj]
        out = [None] * dist.get_world_size(group)
        dist.all_gather_object(out, obj, group=group)
        return out

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()


SINGLE = Parallel()


def batch_sharding(mesh=None) -> tuple:
    """The DTensor placements of a batch on the mesh (JAX :39-41): the
    leading axis sharded over "data", replicated over "model"."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def local_batch_rows(par: Parallel, global_b: int) -> slice:
    """The contiguous row block of a global batch this data rank loads
    (JAX :44-59: every rank samples the same global batch list and takes
    its own block; the model ranks of one data rank take the same rows)."""
    if global_b % par.n_data:
        raise ValueError(f"local_batch_rows: batch {global_b} does not divide the "
                         f"data axis {par.n_data}")
    per = global_b // par.n_data
    return slice(par.data_rank * per, (par.data_rank + 1) * per)


def batch_rows(par: Parallel, global_b: int) -> tuple[slice, bool]:
    """(rows to load, whether the batch is sharded): this rank's block when
    `global_b` divides the data axis, else every row (JAX's replicated
    ragged tail)."""
    shardable = global_b % par.n_data == 0
    return (local_batch_rows(par, global_b) if shardable else slice(None)), shardable


def shard_batch(par: Parallel, batch: dict, process_local: bool) -> dict:
    """This rank's part of a FULL batch: with `process_local` each leaf's
    row block (`local_batch_rows`; the batch must divide the data axis),
    else the batch as it is, replicated (JAX :62-113; the caller decides,
    because a local block and a small whole batch look alike)."""
    if not process_local:
        return dict(batch)
    rows = None
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) >= 1 or isinstance(v, list):
            if rows is None:
                rows = local_batch_rows(par, len(v))
            out[k] = v[rows]
        else:
            out[k] = v
    return out


# column-parallel targets: output (last) dim sharded, bias sharded too.
_COL_W = (
    "mlp.fc1.w",
    "query.w", "key.w", "value.w", "query_cs.w", "key_cs.w",  # head parallel
    ".down.w",                       # bottleneck adapter down-projection
    "downsample_input.w", "downsample_encoder_input.w",
    "downsample_layers.w",           # side-ladder downsamples
    "conv1.w",                       # conv stem (k, 80, d): out channels
)
_COL_B = tuple(w[:-2] + ".b" for w in _COL_W)
# row-parallel targets: input (second-to-last) dim sharded, bias replicated
_ROW_W = (
    "mlp.fc2.w",
    "out.w",                         # attention output projection
    ".up.w",                         # adapter up-projection
    "upsample_output.w",             # side-ladder upsample
    "conv2.w",                       # conv stem second conv: in channels
)


def param_sharding_rules(path: str, shape: tuple) -> tuple:
    """JAX's tensor-parallel partition spec (:116-169) of a '.'-joined JAX
    path of the given JAX-layout shape, as the tuple of a `PartitionSpec`'s
    entries (None or "model" per dim; () is replicated). Linears are JAX's
    (in, out), stacked leaves carry a leading layer axis, conv kernels are
    (k, in, out); `token_emb` (V, d) shards V. The port's nn.Linear (out,
    in) puts a column-parallel "model" dim at 0 and a row-parallel one at 1
    (`parallel/tensor_parallel.port_dim`)."""
    nd = len(shape)
    if path.endswith("upsample_output.w"):
        return tuple([None] * (nd - 2) + ["model", None])
    if any(path.endswith(t) for t in _COL_W):
        return tuple([None] * (nd - 1) + ["model"])
    if any(path.endswith(t) for t in _COL_B):
        return tuple([None] * (nd - 1) + ["model"])
    if any(path.endswith(t) for t in _ROW_W):
        return tuple([None] * (nd - 2) + ["model", None])
    if path.endswith("token_emb"):
        return ("model", None)
    return ()


def pad_vocab_rows(leaf, n_model: int):
    """Zero-pad `token_emb` rows to a multiple of the model axis (JAX
    :172-182), numpy or torch; the model cuts its logits back to n_vocab."""
    v = leaf.shape[0]
    pad = (-v) % n_model
    if pad == 0:
        return leaf
    if isinstance(leaf, torch.Tensor):
        return torch.cat([leaf, leaf.new_zeros((pad, *leaf.shape[1:]))])
    widths = [(0, pad)] + [(0, 0)] * (leaf.ndim - 1)
    return np.pad(np.asarray(leaf), widths)


def shard_params(model, par: Parallel, tensor_parallel: bool = False):
    """Place `model` on the mesh: replicated (data parallel) or, with
    `tensor_parallel`, its whisper parameters sharded over "model" by the
    rule table (JAX :185-221; a rule whose dim does not divide the model
    axis is dropped with a logging.warning). Returns the model."""
    if not tensor_parallel or par.n_model == 1:
        return model
    from agacs_tpu_torch.parallel.tensor_parallel import shard_whisper

    return shard_whisper(model, par)


def shard_summary(model) -> dict[str, list[str]]:
    """{'partitioned': [JAX path ...], 'replicated': [...]} over the model's
    parameters and int8 buffers as placed (JAX :224-237), each '.'-joined
    JAX path once (the port's per-layer tensors of a stacked JAX leaf
    count as that leaf)."""
    from agacs_tpu_torch.parallel.tensor_parallel import placed_leaves

    out: dict[str, list[str]] = {"partitioned": [], "replicated": []}
    seen = set()
    for path, sharded in placed_leaves(model):
        if path not in seen:
            seen.add(path)
            out["partitioned" if sharded else "replicated"].append(path)
    return out


def shard_opt_state(n_data: int, leaves: dict, min_size: int = 1024) -> dict:
    """JAX's ZeRO-1 rule (:240-267) as a plan: {name: axis sharded over
    "data", or None (replicated)} for each optimizer-state leaf (a shape, a
    numpy array or a tensor): leaves of at least `min_size` elements shard
    on their first axis that `n_data` divides; scalars, small leaves and
    leaves with no such axis stay replicated."""
    plan = {}
    for name, x in leaves.items():
        shape = tuple(x) if isinstance(x, (tuple, list)) else tuple(x.shape)
        size = int(np.prod(shape)) if shape else 1
        axis = None
        if shape and size >= min_size:
            axis = next((a for a, n in enumerate(shape) if n % n_data == 0 and n >= n_data),
                        None)
        plan[name] = axis
    return plan


def opt_state_shard_stats(leaves: dict, plan: dict) -> dict:
    """{'sharded_bytes', 'replicated_bytes', 'sharded_leaves'} of an
    optimizer state (name -> numpy array or tensor, whole sizes) under a
    `shard_opt_state` plan (JAX :270-282)."""
    out = {"sharded_bytes": 0, "replicated_bytes": 0, "sharded_leaves": 0}
    for name, x in leaves.items():
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else np.asarray(x).nbytes)
        if plan.get(name) is not None:
            out["sharded_bytes"] += nbytes
            out["sharded_leaves"] += 1
        else:
            out["replicated_bytes"] += nbytes
    return out


class _SumOver(torch.autograd.Function):
    """All-reduce SUM forward and backward: a sum every rank reads, so
    each rank's input takes the gradients of every rank's use."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_over(t: torch.Tensor, par: Parallel, axis: str = "data") -> torch.Tensor:
    """`t` summed over `axis`, differentiably (`_SumOver`); `t` itself
    without a mesh."""
    group = par.group(axis)
    return t if group is None else _SumOver.apply(t, group)

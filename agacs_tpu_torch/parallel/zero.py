"""ZeRO-1: the Adam moments sharded over the mesh's "data" axis
(counterpart of `agacs_tpu/parallel/mesh.py shard_opt_state`, the
reference's fairscale OSS option).

JAX places each moment leaf of at least `min_size` elements sharded over
"data" on its first divisible axis, and XLA updates each shard and
all-gathers the parameters. Here the same rule picks, for each trainable
parameter (as this rank holds it under tensor parallelism), an axis and
this data rank's slice of it. The optimizer steps a float32 copy of each
slice (so it keeps exp_avg / exp_avg_sq for the slice only) from the
all-reduced, clipped gradient's slice; `publish` writes the slices back
and all-gathers each parameter over "data". Parameters the rule leaves
replicated are stepped whole, identically on every data rank. A tensor-
parallel parameter is not sliced on its "model" dim (the next divisible
axis is taken), so its slice is one block of one DTensor dim.

AdamW is elementwise, so a slice's update is the unsharded update's
slice: the numbers are those of one rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from agacs_tpu_torch.parallel.mesh import Parallel, shard_opt_state


class Zero1:
    def __init__(self, par: Parallel, named: dict[str, nn.Parameter],
                 tp_dims: dict[str, int] | None = None, min_size: int = 1024):
        self.par = par
        self.named = dict(named)
        tp_dims = tp_dims or {}
        self.axis: dict[str, int | None] = {}
        for name, p in self.named.items():
            shape = list(p.shape)
            if name in tp_dims:  # never the model dim: the rule's next axis
                shape[tp_dims[name]] = 1 if par.n_data > 1 else shape[tp_dims[name]]
            self.axis[name] = shard_opt_state(par.n_data, {name: tuple(shape)},
                                              min_size)[name]
            if self.axis[name] is not None and p.numel() < min_size:
                self.axis[name] = None
        self.shards: dict[str, nn.Parameter] = {
            name: (nn.Parameter(self._slice(name, p.detach()).clone())
                   if self.axis[name] is not None else p)
            for name, p in self.named.items()}

    def _slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        a = self.axis[name]
        if a is None:
            return t
        per = t.shape[a] // self.par.n_data
        return t.narrow(a, self.par.data_rank * per, per)

    def params(self) -> list[nn.Parameter]:
        """What the optimizer steps, in the trainable parameters' order."""
        return list(self.shards.values())

    def localize(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This data rank's slice of a moment of `name` (as this rank holds
        the parameter)."""
        return self._slice(name, full).contiguous()

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The moment of `name` whole over "data" from each rank's slice
        (a collective over "data")."""
        a = self.axis[name]
        if a is None:
            return shard
        parts = [torch.empty_like(shard) for _ in range(self.par.n_data)]
        dist.all_gather(parts, shard.contiguous(), group=self.par.group("data"))
        return torch.cat(parts, a)

    @torch.no_grad()
    def refresh(self) -> None:
        """Each slice := its parameter's slice (after the parameters were
        loaded from a checkpoint)."""
        for name, p in self.named.items():
            if self.axis[name] is not None:
                self.shards[name].copy_(self._slice(name, p.detach()))

    def load_grads(self) -> None:
        """Each slice's gradient := its slice of the (all-reduced, clipped)
        parameter gradient."""
        for name, p in self.named.items():
            if self.axis[name] is not None:
                self.shards[name].grad = self._slice(name, p.grad).contiguous()

    @torch.no_grad()
    def publish(self) -> None:
        """Write the stepped slices back and all-gather each parameter."""
        for name, p in self.named.items():
            if self.axis[name] is not None:
                p.copy_(self.gather(name, self.shards[name].detach()).to(p.dtype))

    def stats(self) -> dict:
        """The moments' bytes as this rank's parameters hold them:
        {'sharded_bytes', 'replicated_bytes', 'sharded_leaves'} (JAX
        `opt_state_shard_stats` over exp_avg and exp_avg_sq)."""
        out = {"sharded_bytes": 0, "replicated_bytes": 0, "sharded_leaves": 0}
        for name, p in self.named.items():
            nbytes = 2 * p.numel() * 4
            if self.axis[name] is not None:
                out["sharded_bytes"] += nbytes
                out["sharded_leaves"] += 2
            else:
                out["replicated_bytes"] += nbytes
        return out

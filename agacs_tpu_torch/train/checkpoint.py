"""Epoch checkpoints, resume, keep-n-best and the n-best average
(counterpart of `agacs_tpu/train/checkpoint.py` `CheckpointManager`, npz
backend).

  exp_dir/
    {n}epoch.params.npz       per-epoch params, pruned to the n best
    checkpoint.params.npz     the last epoch's params (the resume point)
    checkpoint.opt.npz        the last epoch's optimizer state
    checkpoint_meta.json      epoch, step, rng, history (+ the port's
                              train generator under "torch_generator")
    valid.acc.ave.params.npz  mean of the n best epochs' params

Every file holds the JAX package's layout, so each package resumes the
other's exp_dir. The params npz hold the flat "/"-joined names
(`models/checkpoint.numpy_from_params`). The optimizer npz holds JAX's
optax state under its pytree paths (`agacs_tpu/train/checkpoint.py
save_opt_state`) for the chain JAX's `build_tx` makes: a skip-non-finite
wrapper around [masked set_to_zero, clip (when grad_clip), masked adam(w)],
adam(w) being [scale_by_adam, add_decayed_weights (adamw only),
scale_by_schedule]. For the adapter preset with clip:

  .inner_state/2/.inner_state/0/.count        AdamW's step count (int32)
  .inner_state/2/.inner_state/0/.mu/<param>   exp_avg, trainable leaves only
  .inner_state/2/.inner_state/0/.nu/<param>   exp_avg_sq
  .inner_state/2/.inner_state/2/.count        the schedule's count (LambdaLR's)
  .total_notfinite                            the skipped-step counter

`opt_state_keys` derives these from the optimizer config. JAX's `rng` key
cannot seed a torch generator: the port writes the train generator's state
beside it, and a resume from a JAX exp_dir reseeds that generator from
seed + 1 (a log line says so). The `rng` the port writes is JAX's key for
seed + 1, which JAX's resume reads but which does not continue the port's
draws.

On a mesh (`parallel/mesh.Parallel`) every rank takes part in each save
(the tensor-parallel shards and the ZeRO-1 moment slices are gathered
whole), and the primary rank writes the npz files, the meta, and the
n-best average; a resume reads the whole files on every rank and keeps
each rank's slices.

`backend="orbax"` (the recipes' `--ckpt_backend orbax`) writes
`torch.distributed.checkpoint` (DCP) directories where JAX writes orbax
ones: `{n}epoch.params.dcp/`, `checkpoint.params.dcp/` and
`checkpoint.opt.dcp/`, each rank saving its own shards collectively. A
tensor-parallel shard or a ZeRO-1 moment slice is saved as a `DTensor` on
the mesh (DCP would save a plain tensor under one key once, as replicated,
and lose the other ranks' slices); replicated tensors are plain. The
optimizer directory holds `mu/<name>`, `nu/<name>`, `count`, `schedule`
and `notfinite`. `average_nbest` restores the epochs collectively and the
primary writes the portable `valid.acc.ave.params.npz`, as JAX does. JAX
cannot read these directories and the port cannot read orbax's (orbax
imports JAX): npz stays the format the two packages share.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import os
import shutil
from typing import Callable

import numpy as np
import torch
from torch import nn

from agacs_tpu_torch.models.checkpoint import numpy_from_params
from agacs_tpu_torch.parallel.mesh import SINGLE, Parallel
from agacs_tpu_torch.parallel.tensor_parallel import gather_full, gather_state_dict, localize
from agacs_tpu_torch.train.optim import OptimConfig


def opt_state_keys(optim_cfg: OptimConfig) -> dict[str, str]:
    """JAX's optimizer-state paths for `build_tx(params, optim_cfg, preset)`:
    the adam state's prefix ("adam", + "/.count", "/.mu/...", "/.nu/..."),
    the schedule's count ("schedule") and the skipped-step counter."""
    i = 2 if optim_cfg.grad_clip else 1  # after masked set_to_zero (and clip)
    j = 2 if optim_cfg.optim == "adamw" else 1  # after add_decayed_weights
    inner = f".inner_state/{i}/.inner_state"
    return {"adam": f"{inner}/0", "schedule": f"{inner}/{j}/.count",
            "notfinite": ".total_notfinite"}


def _link_or_copy(src: str, dst: str) -> None:
    """dst := src's bytes: a hard link (no second write of a ~1 GB npz), a
    copy where the file system has none."""
    if os.path.lexists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def jax_prng_key(seed: int) -> list[int]:
    """`jax.random.PRNGKey(seed)`'s uint32 key data (threefry)."""
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


@dataclasses.dataclass
class TrainState:
    """What a resumed run needs besides the model: the optimizer over
    `params` (trainable name -> parameter), its LambdaLR, the train-step
    generator and the counters the epoch loop keeps (`step`: train steps
    taken, skipped ones included; `nonfinite`: steps skipped). On a mesh
    `model` (tensor-parallel shards) and `zero` (a `parallel/zero.Zero1`
    whose slices the optimizer holds) say how this rank's moments map onto
    the whole ones."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    params: dict[str, nn.Parameter]
    optim_cfg: OptimConfig
    generator: torch.Generator
    seed: int
    step: int = 0
    nonfinite: int = 0
    model: nn.Module | None = None
    zero: object | None = None

    def opt_param(self, name: str) -> torch.Tensor:
        """What the optimizer steps for trainable `name`."""
        return self.zero.shards[name] if self.zero is not None else self.params[name]

    def local_moments(self) -> tuple[dict, dict, int]:
        """(exp_avg, exp_avg_sq) by name as this rank holds them, and the
        step count."""
        mu, nu, counts = {}, {}, set()
        for name in self.params:
            q = self.opt_param(name)
            st = self.optimizer.state.get(q, {})
            mu[name], nu[name] = (st[k] if k in st else torch.zeros_like(q, dtype=torch.float32)
                                  for k in ("exp_avg", "exp_avg_sq"))
            counts.add(int(st["step"]) if "step" in st else 0)
        if len(counts) > 1:
            raise ValueError(f"the trainable parameters took different step counts {counts}")
        return mu, nu, counts.pop() if counts else 0

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A moment of `name` whole (collectives over the mesh)."""
        if self.zero is not None:
            t = self.zero.gather(name, t)
        return t if self.model is None else gather_full(self.model, name, t)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole moment of `name`."""
        if self.model is not None:
            t = localize(self.model, name, t)
        return t if self.zero is None else self.zero.localize(name, t)

    def opt_to_numpy(self, to_numpy: Callable[[dict], dict]) -> dict[str, np.ndarray]:
        """The optimizer state in JAX's layout (`to_numpy` names the moments
        of the trainable leaves as the params npz names them); on a mesh a
        collective, every moment gathered whole."""
        keys = opt_state_keys(self.optim_cfg)
        mu, nu, count = self.local_moments()
        mu = {n: self.whole(n, t) for n, t in mu.items()}
        nu = {n: self.whole(n, t) for n, t in nu.items()}
        out = {f"{keys['adam']}/.count": np.asarray(count, np.int32)}
        out.update({f"{keys['adam']}/.mu/{k}": v for k, v in to_numpy(mu).items()})
        out.update({f"{keys['adam']}/.nu/{k}": v for k, v in to_numpy(nu).items()})
        out[keys["schedule"]] = np.asarray(self.scheduler.last_epoch, np.int32)
        out[keys["notfinite"]] = np.asarray(self.nonfinite, np.int32)
        return out

    def load_opt(self, data, from_numpy: Callable[[dict], dict]) -> None:
        """Restore the optimizer, the schedule and `nonfinite` from JAX's
        layout (`from_numpy` maps flat names back to state-dict names,
        leaving out the ones it lacks). A leaf the optimizer needs and the
        file lacks raises, as JAX's `load_opt_state_like` does."""
        keys = opt_state_keys(self.optim_cfg)
        need = [f"{keys['adam']}/.count", keys["schedule"], keys["notfinite"]]
        missing = [k for k in need if k not in data]
        if missing:
            raise KeyError(f"optimizer-state leaves {missing} missing — optimizer config "
                           "changed since the checkpoint was written?")
        moments = {}
        for m in ("mu", "nu"):
            prefix = f"{keys['adam']}/.{m}/"
            moments[m] = from_numpy({k[len(prefix):]: data[k] for k in data
                                     if k.startswith(prefix)})
        count = int(data[f"{keys['adam']}/.count"])
        for name in self.params:
            for m in ("mu", "nu"):
                if name not in moments[m]:
                    raise KeyError(f"optimizer-state leaf {m} of {name!r} missing")
            self.set_moments(name, moments["mu"][name], moments["nu"][name], count,
                             whole=True)
        self.set_counters(int(data[keys["schedule"]]), int(data[keys["notfinite"]]))

    def set_moments(self, name: str, mu: torch.Tensor, nu: torch.Tensor, count: int,
                    whole: bool) -> None:
        """Adam's state of `name` from its moments (whole ones cut to this
        rank's part when `whole`)."""
        q = self.opt_param(name)
        if whole:
            mu, nu = self.local(name, mu), self.local(name, nu)
        for m, t in (("mu", mu), ("nu", nu)):
            if t.shape != q.shape:
                raise ValueError(f"optimizer-state leaf {m} of {name!r}: checkpoint "
                                 f"{tuple(t.shape)} vs {tuple(q.shape)}")
        self.optimizer.state[q] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu.to(q.device, torch.float32).clone(),
            "exp_avg_sq": nu.to(q.device, torch.float32).clone()}

    def set_counters(self, schedule: int, nonfinite: int) -> None:
        """The schedule's count (and the learning rates it gives) and the
        skipped-step counter."""
        sched = self.scheduler
        sched.last_epoch = schedule
        lrs = [base * fn(sched.last_epoch) for fn, base in zip(sched.lr_lambdas, sched.base_lrs)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
        self.nonfinite = nonfinite


class CheckpointManager:
    """`to_numpy` turns a state dict (or a subset of one) into the flat JAX
    mapping and `from_numpy` back (leaving out what it lacks): the whisper
    converters by default, the conformer's (its BN buffers included) for
    that family."""

    def __init__(self, exp_dir: str, keep_nbest: int = 3,
                 criterion: tuple[str, str, str] = ("valid", "acc", "max"),
                 to_numpy: Callable[[dict], dict] = numpy_from_params,
                 from_numpy: Callable[..., dict] | None = None,
                 backend: str = "npz", par: Parallel = SINGLE):
        if backend not in ("npz", "orbax"):
            raise ValueError(f"checkpoint backend {backend!r}: 'npz' or 'orbax'")
        self.exp_dir = exp_dir
        self.to_numpy = to_numpy
        self.from_numpy = from_numpy
        self.keep_nbest = keep_nbest
        self.criterion = tuple(criterion)
        self.backend, self.par = backend, par
        self.ext = "dcp" if backend == "orbax" else "npz"
        os.makedirs(exp_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.exp_dir, name)

    def _epoch_path(self, epoch: int) -> str:
        return self._path(f"{epoch}epoch.params.{self.ext}")

    # -- DCP ---------------------------------------------------------------
    def _dtensor(self, t: torch.Tensor, model_dim: int | None, data_axis: int | None):
        """`t` (this rank's part) as a DTensor on the mesh when it is a
        slice of something larger, else `t` (DCP saves it once)."""
        if self.par.mesh is None or (model_dim is None and data_axis is None):
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        placements = [Replicate() if data_axis is None else Shard(data_axis),
                      Replicate() if model_dim is None else Shard(model_dim)]
        return DTensor.from_local(t, self.par.mesh, placements, run_check=False)

    def _dcp_params(self, model: nn.Module) -> dict:
        dims = getattr(model, "tp_dims", {})
        return {n: self._dtensor(t, dims.get(n), None) for n, t in model.state_dict().items()}

    def _dcp_opt(self, state: TrainState) -> dict:
        dims = getattr(state.model, "tp_dims", {}) if state.model is not None else {}
        mu, nu, count = state.local_moments()
        out = {}
        for name in state.params:
            axis = state.zero.axis[name] if state.zero is not None else None
            out[f"mu/{name}"] = self._dtensor(mu[name], dims.get(name), axis)
            out[f"nu/{name}"] = self._dtensor(nu[name], dims.get(name), axis)
        out["count"] = torch.tensor(count)
        out["schedule"] = torch.tensor(state.scheduler.last_epoch)
        out["notfinite"] = torch.tensor(state.nonfinite)
        return out

    @staticmethod
    def _dcp_load(path: str, sd: dict) -> dict:
        """`sd` filled from the DCP dir `path`; each value as this rank's
        local tensor."""
        import torch.distributed.checkpoint as dcp

        dcp.load(sd, checkpoint_id=path)
        return {k: v.to_local() if hasattr(v, "to_local") else v for k, v in sd.items()}

    def _dcp_save(self, path: str, sd: dict) -> None:
        import torch.distributed.checkpoint as dcp

        if self.par.is_primary and os.path.isdir(path):
            shutil.rmtree(path)
        self.par.barrier()
        dcp.save(sd, checkpoint_id=path)
        self.par.barrier()

    # -- save / resume -----------------------------------------------------
    def save_epoch(self, epoch: int, model: nn.Module, history: dict,
                   state: TrainState | None = None) -> None:
        """history: {epoch: {"train": {...}, "valid": {...}}}. With `state`
        also the resume point: checkpoint.params.npz, checkpoint.opt.npz
        (or their DCP dirs) and the meta's step, rng and generator. On a
        mesh every rank calls it."""
        primary = self.par.is_primary
        if self.backend == "orbax":
            self._dcp_save(self._epoch_path(epoch), self._dcp_params(model))
            if state is not None:
                self._dcp_save(self._path("checkpoint.opt.dcp"), self._dcp_opt(state))
                if primary:
                    dst = self._path("checkpoint.params.dcp")
                    if os.path.isdir(dst):
                        shutil.rmtree(dst)
                    shutil.copytree(self._epoch_path(epoch), dst, copy_function=_link_or_copy)
        else:
            params = self.to_numpy(gather_state_dict(model))
            opt = state.opt_to_numpy(self.to_numpy) if state is not None else None
            if primary:
                np.savez(self._epoch_path(epoch), **params)
                if state is not None:
                    _link_or_copy(self._epoch_path(epoch),
                                  self._path("checkpoint.params.npz"))
                    np.savez(self._path("checkpoint.opt.npz"), **opt)
        if primary:
            meta = {"epoch": epoch}
            if state is not None:
                meta["step"] = state.step
                meta["rng"] = jax_prng_key(state.seed + 1)
            meta["history"] = {str(k): v for k, v in history.items()}
            if state is not None:
                meta["torch_generator"] = base64.b64encode(
                    state.generator.get_state().numpy().tobytes()).decode()
            with open(self._path("checkpoint_meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
            self._prune(history)
        self.par.barrier()

    def load_meta(self) -> dict | None:
        if not os.path.exists(self._path("checkpoint_meta.json")):
            return None
        with open(self._path("checkpoint_meta.json")) as f:
            return json.load(f)

    def _load_params(self, model: nn.Module, path: str) -> None:
        if self.backend == "orbax":
            sd = self._dcp_load(path, self._dcp_params(model))
            model.load_state_dict(sd)
            return
        with np.load(path) as data:
            full = self.from_numpy({k: data[k] for k in data.files})
        model.load_state_dict({n: localize(model, n, t) for n, t in full.items()})

    def resume(self, model: nn.Module, state: TrainState) -> tuple[int, dict]:
        """Restore the last epoch's params into `model` and its optimizer
        state, schedule, counters and generator into `state`; return
        (start epoch, history), as JAX's `resume` (:229-259). Without a
        checkpoint: (1, {}). On a mesh every rank calls it."""
        meta = self.load_meta()
        if meta is None:
            return 1, {}
        self._load_params(model, self._path(f"checkpoint.params.{self.ext}"))
        if state.zero is not None:
            state.zero.refresh()
        if self.backend == "orbax":
            sd = self._dcp_load(self._path("checkpoint.opt.dcp"), self._dcp_opt(state))
            for name in state.params:
                state.set_moments(name, sd[f"mu/{name}"], sd[f"nu/{name}"],
                                  int(sd["count"]), whole=False)
            state.set_counters(int(sd["schedule"]), int(sd["notfinite"]))
        else:
            with np.load(self._path("checkpoint.opt.npz")) as data:
                state.load_opt({k: data[k] for k in data.files},
                               lambda flat: self.from_numpy(flat, strict=False))
        state.step = int(meta["step"])
        if "torch_generator" in meta:
            state.generator.set_state(torch.frombuffer(
                bytearray(base64.b64decode(meta["torch_generator"])), dtype=torch.uint8))
        else:
            state.generator.manual_seed(state.seed + 1)
            logging.info("resume: %s has no torch generator state (written by the JAX "
                         "package?); the train generator is reseeded from seed + 1 = %d",
                         self.exp_dir, state.seed + 1)
        return meta["epoch"] + 1, {int(k): v for k, v in meta["history"].items()}

    def _ranked_epochs(self, history: dict) -> list[int]:
        phase, metric, mode = self.criterion
        scored = [(ep, vals[phase][metric]) for ep, vals in history.items()
                  if metric in vals.get(phase, {})]
        scored.sort(key=lambda x: x[1], reverse=(mode == "max"))
        return [ep for ep, _ in scored]

    def best_epoch(self, history: dict) -> int | None:
        ranked = self._ranked_epochs(history)
        return ranked[0] if ranked else None

    def _prune(self, history: dict) -> None:
        keep = set(self._ranked_epochs(history)[: self.keep_nbest])
        for fname in os.listdir(self.exp_dir):
            if (fname.endswith(f"epoch.params.{self.ext}")
                    and int(fname.split("epoch")[0]) not in keep):
                full = os.path.join(self.exp_dir, fname)
                shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)

    def average_nbest(self, history: dict, model: nn.Module | None = None) -> str | None:
        """Write the mean of the n best epochs' params to
        <phase>.<metric>.ave.params.npz; return its path (None on the other
        ranks of a mesh). Integer leaves (the int8 trunk's w_q, frozen
        across epochs) keep their dtype: the rounded mean, as JAX's
        CheckpointManager and average_checkpoints write it. The DCP backend
        restores each epoch into `model` (its params are overwritten; every
        rank calls it) and gathers the whole tensors."""
        eps = self._ranked_epochs(history)[: self.keep_nbest]
        assert eps, "no scored epochs to average"
        phase, metric, _ = self.criterion
        out = os.path.join(self.exp_dir, f"{phase}.{metric}.ave.params.npz")
        acc: dict[str, np.ndarray] = {}
        dtypes: dict[str, np.dtype] = {}
        if self.backend == "orbax":
            for ep in eps:
                self._load_params(model, self._epoch_path(ep))
                for k, v in self.to_numpy(gather_state_dict(model)).items():
                    acc[k] = acc.get(k, 0.0) + np.asarray(v).astype(np.float32)
                    dtypes.setdefault(k, np.asarray(v).dtype)
        elif self.par.is_primary:
            for ep in eps:
                with np.load(self._epoch_path(ep)) as data:
                    for k in data.files:
                        acc[k] = acc.get(k, 0.0) + data[k].astype(np.float32)
                        dtypes.setdefault(k, data[k].dtype)
        if self.par.is_primary:
            np.savez(out, **{
                k: np.round(v / len(eps)).astype(dtypes[k])
                if np.issubdtype(dtypes[k], np.integer) else v / len(eps)
                for k, v in acc.items()})
        self.par.barrier()
        return out if self.par.is_primary else None

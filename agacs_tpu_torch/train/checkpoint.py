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
    taken, skipped ones included; `nonfinite`: steps skipped)."""

    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    params: dict[str, nn.Parameter]
    optim_cfg: OptimConfig
    generator: torch.Generator
    seed: int
    step: int = 0
    nonfinite: int = 0

    def opt_to_numpy(self, to_numpy: Callable[[dict], dict]) -> dict[str, np.ndarray]:
        """The optimizer state in JAX's layout (`to_numpy` names the moments
        of the trainable leaves as the params npz names them)."""
        keys = opt_state_keys(self.optim_cfg)
        mu, nu, counts = {}, {}, set()
        for name, p in self.params.items():
            st = self.optimizer.state.get(p, {})
            zero = torch.zeros_like(p, dtype=torch.float32)
            mu[name], nu[name] = st.get("exp_avg", zero), st.get("exp_avg_sq", zero)
            counts.add(int(st["step"]) if "step" in st else 0)
        if len(counts) > 1:
            raise ValueError(f"the trainable parameters took different step counts {counts}")
        out = {f"{keys['adam']}/.count": np.asarray(counts.pop() if counts else 0, np.int32)}
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
        for name, p in self.params.items():
            for m in ("mu", "nu"):
                if name not in moments[m]:
                    raise KeyError(f"optimizer-state leaf {m} of {name!r} missing")
                if moments[m][name].shape != p.shape:
                    raise ValueError(f"optimizer-state leaf {m} of {name!r}: checkpoint "
                                     f"{tuple(moments[m][name].shape)} vs {tuple(p.shape)}")
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": moments["mu"][name].to(p.device, torch.float32),
                "exp_avg_sq": moments["nu"][name].to(p.device, torch.float32)}
        sched = self.scheduler
        sched.last_epoch = int(data[keys["schedule"]])
        lrs = [base * fn(sched.last_epoch) for fn, base in zip(sched.lr_lambdas, sched.base_lrs)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        sched._last_lr = lrs
        self.nonfinite = int(data[keys["notfinite"]])


class CheckpointManager:
    """`to_numpy` turns a state dict (or a subset of one) into the flat JAX
    mapping and `from_numpy` back (leaving out what it lacks): the whisper
    converters by default, the conformer's (its BN buffers included) for
    that family."""

    def __init__(self, exp_dir: str, keep_nbest: int = 3,
                 criterion: tuple[str, str, str] = ("valid", "acc", "max"),
                 to_numpy: Callable[[dict], dict] = numpy_from_params,
                 from_numpy: Callable[..., dict] | None = None):
        self.exp_dir = exp_dir
        self.to_numpy = to_numpy
        self.from_numpy = from_numpy
        self.keep_nbest = keep_nbest
        self.criterion = tuple(criterion)
        os.makedirs(exp_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.exp_dir, name)

    def _epoch_path(self, epoch: int) -> str:
        return self._path(f"{epoch}epoch.params.npz")

    def save_epoch(self, epoch: int, model: nn.Module, history: dict,
                   state: TrainState | None = None) -> None:
        """history: {epoch: {"train": {...}, "valid": {...}}}. With `state`
        also the resume point: checkpoint.params.npz, checkpoint.opt.npz
        and the meta's step, rng and generator."""
        params = self.to_numpy(model.state_dict())
        np.savez(self._epoch_path(epoch), **params)
        meta = {"epoch": epoch}
        if state is not None:
            _link_or_copy(self._epoch_path(epoch), self._path("checkpoint.params.npz"))
            np.savez(self._path("checkpoint.opt.npz"), **state.opt_to_numpy(self.to_numpy))
            meta["step"] = state.step
            meta["rng"] = jax_prng_key(state.seed + 1)
        meta["history"] = {str(k): v for k, v in history.items()}
        if state is not None:
            meta["torch_generator"] = base64.b64encode(
                state.generator.get_state().numpy().tobytes()).decode()
        with open(self._path("checkpoint_meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        self._prune(history)

    def load_meta(self) -> dict | None:
        if not os.path.exists(self._path("checkpoint_meta.json")):
            return None
        with open(self._path("checkpoint_meta.json")) as f:
            return json.load(f)

    def resume(self, model: nn.Module, state: TrainState) -> tuple[int, dict]:
        """Restore the last epoch's params into `model` and its optimizer
        state, schedule, counters and generator into `state`; return
        (start epoch, history), as JAX's `resume` (:229-259). Without a
        checkpoint: (1, {})."""
        meta = self.load_meta()
        if meta is None:
            return 1, {}
        with np.load(self._path("checkpoint.params.npz")) as data:
            model.load_state_dict(self.from_numpy({k: data[k] for k in data.files}))
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
            if fname.endswith("epoch.params.npz") and int(fname.split("epoch")[0]) not in keep:
                os.remove(os.path.join(self.exp_dir, fname))

    def average_nbest(self, history: dict) -> str:
        """Write the mean of the n best epochs' params to
        <phase>.<metric>.ave.params.npz; return its path. Integer leaves
        (the int8 trunk's w_q, frozen across epochs) keep their dtype: the
        rounded mean, as JAX's CheckpointManager and average_checkpoints
        write it."""
        eps = self._ranked_epochs(history)[: self.keep_nbest]
        assert eps, "no scored epochs to average"
        acc: dict[str, np.ndarray] = {}
        dtypes: dict[str, np.dtype] = {}
        for ep in eps:
            with np.load(self._epoch_path(ep)) as data:
                for k in data.files:
                    acc[k] = acc.get(k, 0.0) + data[k].astype(np.float32)
                    dtypes.setdefault(k, data[k].dtype)
        phase, metric, _ = self.criterion
        out = os.path.join(self.exp_dir, f"{phase}.{metric}.ave.params.npz")
        np.savez(out, **{
            k: np.round(v / len(eps)).astype(dtypes[k])
            if np.issubdtype(dtypes[k], np.integer) else v / len(eps)
            for k, v in acc.items()})
        return out

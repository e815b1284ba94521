"""Epoch checkpoints, keep-n-best and the n-best average (counterpart of
`agacs_tpu/train/checkpoint.py` `CheckpointManager`, npz backend).

  exp_dir/
    {n}epoch.params.npz       per-epoch params, pruned to the n best
    checkpoint_meta.json      last epoch and the per-epoch history
    valid.acc.ave.params.npz  mean of the n best epochs' params

The npz files hold the JAX package's flat "/"-joined layout
(`models/checkpoint.numpy_from_params`), so
`agacs_tpu.train.checkpoint.load_pytree_like` and this package's decode
CLI both read them. Resuming (the optimizer-state files) is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
from torch import nn

from agacs_tpu_torch.models.checkpoint import numpy_from_params


class CheckpointManager:
    """`to_numpy` turns the model's state dict into the flat JAX mapping:
    the whisper converter by default, `numpy_from_conformer_params` /
    `numpy_from_lm_params` for the conformer family (its BN buffers
    included) and the LM."""

    def __init__(self, exp_dir: str, keep_nbest: int = 3,
                 criterion: tuple[str, str, str] = ("valid", "acc", "max"),
                 to_numpy: Callable[[dict], dict] = numpy_from_params):
        self.exp_dir = exp_dir
        self.to_numpy = to_numpy
        self.keep_nbest = keep_nbest
        self.criterion = tuple(criterion)
        os.makedirs(exp_dir, exist_ok=True)

    def _epoch_path(self, epoch: int) -> str:
        return os.path.join(self.exp_dir, f"{epoch}epoch.params.npz")

    def save_epoch(self, epoch: int, model: nn.Module, history: dict) -> None:
        """history: {epoch: {"train": {...}, "valid": {...}}}."""
        np.savez(self._epoch_path(epoch), **self.to_numpy(model.state_dict()))
        with open(os.path.join(self.exp_dir, "checkpoint_meta.json"), "w") as f:
            json.dump({"epoch": epoch,
                       "history": {str(k): v for k, v in history.items()}}, f, indent=1)
        self._prune(history)

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

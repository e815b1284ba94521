"""Background batch building (counterpart of `agacs_tpu/data/prefetch.py`,
the role of the reference's DataLoader workers): worker threads read,
augment and collate batches ahead of the step, in order, at most
`lookahead` + 1 ahead of the one consumed, and a worker's exception is
raised in the consumer.

On a CUDA device `HostToDevice` finishes a batch in the worker thread: it
collates into pinned host memory (`PinnedArrays`) and copies with
`non_blocking=True` on a side stream, then records an event; `ready`
makes the step's stream wait for that event and marks the tensors as used
there (`record_stream`), so the copy overlaps the previous step.

The augmentation draws from one shared RandomState (`data/augment.py`),
so a set with augmentation is built in one thread: its draws then follow
the batch order. JAX builds with two threads whatever the set, so its
draw order can change from run to run.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from agacs_tpu_torch.data.collate import collate_batch, to_device

STEP_KEYS = ("speech", "speech_lengths", "text", "cs_labels")


def prefetch_batches(make_batch: Callable[[list[str]], dict],
                     batch_ids: Iterable[list[str]], lookahead: int = 2,
                     num_threads: int = 2) -> Iterator[dict]:
    """Yield make_batch(utts) for each utt list, in order, built ahead by
    up to `lookahead` batches (JAX's claim rule). Closing the iterator
    early stops the workers."""
    batch_ids = list(batch_ids)
    if not batch_ids:
        return
    cv = threading.Condition()
    results: dict[int, object] = {}
    next_claim, consumed = [0], [0]
    error: list[BaseException] = []
    closed = [False]

    def worker():
        while True:
            with cv:
                while (next_claim[0] < len(batch_ids)
                       and next_claim[0] - consumed[0] > lookahead
                       and not error and not closed[0]):
                    cv.wait(timeout=0.1)
                if next_claim[0] >= len(batch_ids) or error or closed[0]:
                    return
                i = next_claim[0]
                next_claim[0] += 1
            try:
                b = make_batch(batch_ids[i])
            except BaseException as e:
                with cv:
                    error.append(e)
                    cv.notify_all()
                return
            with cv:
                results[i] = b
                cv.notify_all()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, num_threads))]
    for t in threads:
        t.start()
    try:
        for i in range(len(batch_ids)):
            with cv:
                while i not in results and not error:
                    cv.wait(timeout=0.1)
                if error:
                    raise error[0]
                b = results.pop(i)
                consumed[0] = i + 1
                cv.notify_all()
            yield b
    finally:
        with cv:
            closed[0] = True
            cv.notify_all()
        for t in threads:
            t.join()


_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
                np.dtype(np.int8): torch.int8}


class PinnedArrays:
    """`collate_batch`'s `alloc`: each array a view of a pinned host tensor,
    kept in `tensors` under its name."""

    def __init__(self):
        self.tensors: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, shape: tuple, dtype, fill) -> np.ndarray:
        t = torch.empty(shape, dtype=_TORCH_DTYPE[np.dtype(dtype)], pin_memory=True)
        self.tensors[name] = t
        a = t.numpy()
        a.fill(fill)
        return a


class HostToDevice:
    """Collated batches on `device`: `collate` runs in a batch thread,
    `ready` in the step's thread before the step reads the batch."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)

    def collate(self, items: list[dict], pad_to: tuple[int, int] | None = None) -> dict:
        if self.stream is None:
            return to_device(collate_batch(items, pad_to=pad_to), self.device)
        host = PinnedArrays()
        collate_batch(items, pad_to=pad_to, alloc=host)
        with torch.cuda.stream(self.stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in host.tensors.items() if k in STEP_KEYS}
            out["speech_lengths"] = out["speech_lengths"].long()
            out["text"] = out["text"].long()
            done = torch.cuda.Event()
            done.record(self.stream)
        return {"batch": out, "done": done}

    def ready(self, made: dict) -> dict:
        if self.stream is None:
            return made
        step_stream = torch.cuda.current_stream(self.device)
        step_stream.wait_event(made["done"])
        for t in made["batch"].values():
            t.record_stream(step_stream)
        return made["batch"]

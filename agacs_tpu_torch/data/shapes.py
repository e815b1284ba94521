"""Utterance lengths for batch packing, probed once across the ranks
(counterpart of `agacs_tpu/data/shapes.py`).

Dirs written by the format stage carry `utt2num_samples`, so most lengths
are a file read (`ASRDataset` seeds its cache from it). The rest are
header reads: in a multi-process run each rank probes only its stride
slice of them, and the counts are exchanged as one int64 vector per rank,
-1 where the utterance is not the rank's, combined with an all-reduce MAX
(JAX's `process_allgather` + max).
"""

from __future__ import annotations

import torch

from agacs_tpu_torch.parallel.mesh import SINGLE, Parallel


def collect_num_samples(ds, par: Parallel = SINGLE, device=None) -> dict[str, int]:
    """{utt_id: n_samples} for every utterance of `ds`, this rank probing
    only its slice of the uncached ones. `device`: where the exchange
    vector lives (the process group's device; NCCL takes CUDA tensors)."""
    utts = list(ds.utt_ids)
    if par.mesh is None:
        return {u: ds.num_samples(u) for u in utts}
    world, rank = par.n_data * par.n_model, par.rank
    cache = ds.data._n  # lengths known already (utt2num_samples, the length bounds)
    missing = [u for u in utts if u not in cache]
    vec = torch.full((len(missing),), -1, dtype=torch.int64)
    for i in range(rank, len(missing), world):
        vec[i] = ds.num_samples(missing[i])
    vec = par.all_reduce(vec.to(device or "cpu"), "world", op="max").cpu()
    for u, n in zip(missing, vec.tolist()):
        if n < 0:
            raise AssertionError(f"{u}: no rank probed this utterance")
        cache[u] = n
    return {u: ds.num_samples(u) for u in utts}

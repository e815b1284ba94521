"""The port's mesh rules (`agacs_tpu_torch/parallel/`) against JAX's
`agacs_tpu/parallel/mesh.py` on the conftest's 8 CPU devices: the
tensor-parallel rule table and what it partitions on a whisper with
adapters and the side ladder (float and int8 trunk), the vocabulary
padding, the data ranks' row blocks, and the ZeRO-1 plan's bytes.

The port's tensor-parallel cut needs no process group (its collectives
run in the forward only), so one rank of a model axis of 2 is placed here
with a stand-in for the mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agacs_tpu.parallel import mesh as jmesh
from agacs_tpu.train import trainer as jtrainer
from agacs_tpu.train.checkpoint import _flatten_with_names
from agacs_tpu.utils import config as jconfig
from agacs_tpu_torch.models.whisper import Whisper
from agacs_tpu_torch.parallel import mesh as tmesh
from agacs_tpu_torch.parallel.tensor_parallel import port_dim
from agacs_tpu_torch.train.checkpoint import TrainState
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import build_optimizer
from agacs_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

RECIPE = "recipes/seame/conf/train_asr_whisper_small_adapter_csloss_2stage.yaml"


@dataclasses.dataclass
class _Rank:
    """This process as rank (data_rank, model_rank) of an (n_data, n_model)
    mesh, without a process group."""

    n_data: int = 1
    n_model: int = 1
    data_rank: int = 0
    model_rank: int = 0

    def group(self, axis):
        return None


def _raw(side: bool) -> dict:
    over = ["encoder_conf.whisper_model=test", "decoder_conf.whisper_model=test"]
    if side:
        over += ["encoder_conf.side_network=true", "decoder_conf.side_network=true",
                 "encoder_conf.side_network_conf={n_dim: 32, n_head: 2, layers: [0, 1]}",
                 "decoder_conf.side_network_conf={n_dim: 32, n_head: 2, layers: [0, 1]}"]
    return tconfig.apply_overrides(tconfig.load_yaml(RECIPE), over)


def _jax_params(raw: dict, int8: bool):
    task = jconfig.task_from_dict(raw, compute_dtype=jnp.bfloat16)
    params = task.init_fn(jax.random.PRNGKey(0), task.cfg)
    mesh = jmesh.make_mesh(n_model=2)
    params = jmesh.shard_params(mesh, params, tensor_parallel=True)
    if int8:
        tx, mask = jtrainer.build_tx(params, jconfig.optim_config_from_dict(raw),
                                     freeze_preset="adapter")
        params = jtrainer.quantize_frozen_linears(
            jtrainer.cast_frozen_params(params, mask), mask)
    return params


def _port_model(raw: dict, int8: bool, preset: str = "adapter") -> Whisper:
    task = tconfig.task_from_dict(raw, compute_dtype=torch.bfloat16)
    sd = task.init_fn(torch.Generator().manual_seed(0), task.cfg)
    model = Whisper.from_state_dict(task.cfg.whisper, sd, param_dtype=torch.float32)
    apply_freeze(model, preset)
    if int8:
        model.cast_frozen_(torch.bfloat16)
        model.quantize_frozen_()
    return model


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_shard_summary_matches_jax(int8):
    """Model degree 2 on a "test" whisper with adapters and the side
    ladder: the partitioned and replicated JAX paths equal JAX's
    `shard_summary` (after `quantize_frozen_linears` for the int8 trunk:
    w_q as its w, w_s with a column-parallel bias, whole for a row-parallel
    linear), and each sharded tensor holds half of its dim."""
    raw = _raw(side=True)
    want = jmesh.shard_summary(_jax_params(raw, int8))
    model = _port_model(raw, int8)
    full = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    tmesh.shard_params(model, _Rank(n_model=2), tensor_parallel=True)
    got = tmesh.shard_summary(model)
    assert set(got["partitioned"]) == set(want["partitioned"])
    assert set(got["replicated"]) == set(want["replicated"])
    assert len(want["partitioned"]) > 20
    for name, dim in model.tp_dims.items():
        shape = list(full[name])
        if name == "decoder.token_embedding.weight":
            shape[0] += shape[0] % 2  # pad_vocab_rows
        shape[dim] //= 2
        assert tuple(model.state_dict()[name].shape) == tuple(shape), name


def test_rule_table_matches_jax():
    """`param_sharding_rules` equals JAX's on every leaf of the tree (JAX
    layout), and `port_dim` puts its "model" dim where nn.Linear's (out,
    in), Conv1d's (out, in, k) and int8 (in, out) layouts hold it."""
    raw = _raw(side=True)
    task = jconfig.task_from_dict(raw, compute_dtype=jnp.float32)
    flat, _ = jax.tree_util.tree_flatten_with_path(task.init_fn(jax.random.PRNGKey(0),
                                                                task.cfg))
    n = 0
    for kp, leaf in flat:
        path = ".".join(str(getattr(k, "key", k)) for k in kp)
        want = tuple(jmesh.param_sharding_rules(path, leaf.shape))
        assert tmesh.param_sharding_rules(path, leaf.shape) == want, path
        n += "model" in want
    assert n > 20
    assert port_dim("encoder.blocks.0.attn.query.weight", (64, 64)) == 0
    assert port_dim("encoder.blocks.0.attn.out.weight", (64, 64)) == 1
    assert port_dim("encoder.blocks.0.mlp.0.bias", (256,)) == 0
    assert port_dim("encoder.blocks.0.mlp.2.bias", (64,)) is None
    assert port_dim("encoder.conv1.weight", (64, 80, 3)) == 0
    assert port_dim("encoder.conv2.weight", (64, 64, 3)) == 1
    assert port_dim("encoder.blocks.0.attn.query.weight_q", (64, 64)) == 1
    assert port_dim("encoder.blocks.0.attn.query.weight_s", (64,)) == 0
    assert port_dim("encoder.blocks.0.attn.out.weight_q", (64, 64)) == 0
    assert port_dim("encoder.blocks.0.attn.out.weight_s", (64,)) is None
    assert port_dim("encoder_side.upsample_output.weight", (64, 32)) == 1
    assert port_dim("decoder.token_embedding.weight", (51866, 64)) == 0
    assert port_dim("decoder.ln.weight", (64,)) is None


@pytest.mark.parametrize("v,n", [(51865, 2), (51865, 4), (51865, 8), (51864, 8), (7, 1)])
def test_pad_vocab_rows_matches_jax(v, n):
    x = np.random.RandomState(0).randn(v, 3).astype(np.float32)
    want = np.asarray(jmesh.pad_vocab_rows(x, n))
    np.testing.assert_array_equal(tmesh.pad_vocab_rows(x, n), want)
    np.testing.assert_array_equal(tmesh.pad_vocab_rows(torch.from_numpy(x), n).numpy(), want)


@pytest.mark.parametrize("b,world", [(8, 1), (8, 2), (8, 4), (12, 4), (6, 3), (16, 8)])
def test_local_batch_rows_match_jax(b, world, monkeypatch):
    """Each rank's row block equals JAX's for that process index; a batch
    that does not divide raises in both (the port's `batch_rows` then
    loads it whole)."""
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        want = jmesh.local_batch_rows(None, b)
        par = _Rank(n_data=world, data_rank=rank)
        assert tmesh.local_batch_rows(par, b) == want
        assert tmesh.batch_rows(par, b) == (want, True)
        rows = tmesh.shard_batch(par, {"x": np.arange(b), "u": [str(i) for i in range(b)]},
                                 process_local=True)
        np.testing.assert_array_equal(rows["x"], np.arange(b)[want])
    if world > 1:
        par = _Rank(n_data=world)
        assert tmesh.batch_rows(par, b + 1) == (slice(None), False)
        with pytest.raises(AssertionError):
            jmesh.local_batch_rows(None, b + 1)
        with pytest.raises(ValueError):
            tmesh.local_batch_rows(par, b + 1)


@pytest.mark.parametrize("preset", ["adapter", "none"])
def test_zero1_plan_bytes_match_jax(preset):
    """JAX's `shard_opt_state` on a 2-device data mesh and the port's plan
    over its optimizer state in JAX's layout (`TrainState.opt_to_numpy`):
    the same sharded leaves and `opt_state_shard_stats` byte for byte."""
    raw = _raw(side=False)
    task = jconfig.task_from_dict(raw, compute_dtype=jnp.float32)
    params = task.init_fn(jax.random.PRNGKey(0), task.cfg)
    optim_cfg = jconfig.optim_config_from_dict(raw)
    tx, _ = jtrainer.build_tx(params, optim_cfg, freeze_preset=preset)
    state = jtrainer.create_train_state(params, tx, jax.random.PRNGKey(1))
    mesh = jmesh.make_mesh(n_data=2, devices=jax.devices()[:2])
    placed = jmesh.shard_opt_state(mesh, state.opt_state)
    want = jmesh.opt_state_shard_stats(placed)
    flat, _ = jax.tree_util.tree_flatten_with_path(placed)
    names = [n for n, _ in _flatten_with_names(placed)]
    jax_sharded = {n for n, (_, leaf) in zip(names, flat)
                   if not leaf.sharding.is_fully_replicated}

    model = _port_model(raw, int8=False, preset=preset)
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    opt, sched = build_optimizer(list(trainable.values()), tconfig.optim_config_from_dict(raw))
    ts = TrainState(opt, sched, trainable, tconfig.optim_config_from_dict(raw),
                    torch.Generator(), 0)
    from agacs_tpu_torch.models.checkpoint import numpy_from_params

    leaves = ts.opt_to_numpy(numpy_from_params)
    assert set(leaves) == set(names)
    plan = tmesh.shard_opt_state(2, leaves)
    assert {n for n, a in plan.items() if a is not None} == jax_sharded
    assert tmesh.opt_state_shard_stats(leaves, plan) == want
    assert want["sharded_leaves"] > 0

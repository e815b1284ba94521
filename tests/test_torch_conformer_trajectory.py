"""The port's conformer training against agacs_tpu on the CPU, continued
(helpers and inputs from test_torch_conformer_train.py): interCTC taps on a
6-block encoder, with every gradient, and a 3-step Adam trajectory
(WarmupLR, clip 5, accum 2) against JAX's make_train_step.

Tolerances: as in test_torch_conformer_train.py for the losses and the
gradients; the trajectory: every parameter within 1e-5 after 3 steps
(float32 Adam on float32 gradients; Adam's eps is 1e-4 there, not the
recipe's 1e-6: Adam divides each gradient by its own RMS, so an element
whose gradient is float32 noise, e.g. a barely active ReLU unit's bias,
would move by up to the learning rate in a direction the noise picks).

JAX's train step updates every leaf but the BN buffers, the global-MVN
statistics included (they are leaves of its parameter tree); espnet's
GlobalMVN keeps them fixed and so does the port, so the trajectory holds
JAX with them masked out of its optimizer.
"""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import conformer_asr as jasr
from agacs_tpu.train.freeze import trainable_mask
from agacs_tpu.train.optim import build_optimizer as jax_build_optimizer
from agacs_tpu.train.optim import skip_nonfinite_by_gnorm
from agacs_tpu.train.trainer import create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu.utils.config import optim_config_from_dict as jax_optim_config
from agacs_tpu_torch.models import conformer_asr as tasr
from agacs_tpu_torch.models.checkpoint import numpy_from_conformer_params
from agacs_tpu_torch.train.optim import build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step
from agacs_tpu_torch.utils.config import optim_config_from_dict
from test_torch_conformer_train import (  # pytest puts tests/ (no __init__.py) on sys.path
    _batch,
    _cfgs,
    _check_grads,
    _flat,
    _jax_value_and_grad,
    _jb,
    _model,
    _params,
    _tb,
)

torch.set_num_threads(1)


def test_interctc_matches_jax():
    """Taps after blocks 3 and 6 of a 6-block encoder, the shared CTC head."""
    jcfg, tcfg = _cfgs("layer", blocks=6, interctc_weight=0.5)
    jcfg = dataclasses.replace(jcfg, interctc_layers=(3, 6))
    tcfg = dataclasses.replace(tcfg, interctc_layers=(3, 6))
    tree, batch = _params(jcfg, seed=5), _batch(seed=5)
    (ref, ref_stats), ref_grads = _jax_value_and_grad(jcfg, tree, batch)
    model = _model(tree, tcfg)
    loss, stats = tasr.forward(model, tcfg, _tb(batch), train=True,
                               generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert set(stats) == set(ref_stats)
    assert {"loss_interctc_layer3", "loss_interctc_layer6"} <= set(stats)
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), float(ref_stats[k]), rtol=1e-5, err_msg=k)
    _check_grads(model, tcfg, ref_grads)


def test_trajectory_matches_jax():
    """3 optimizer steps of 2 micro-batches: Adam (the recipe's optim),
    WarmupLR with 4 warmup steps so the lr moves, clip 5, float32,
    dropout 0, BN in train mode, against JAX's make_train_step."""
    jcfg, tcfg = _cfgs("batch")
    raw = {"optim": "adam", "optim_conf": {"lr": 0.001, "eps": 1e-4}, "scheduler": "warmuplr",
           "scheduler_conf": {"warmup_steps": 4}, "grad_clip": 5}
    tree = _params(jcfg, seed=9)
    params = jax.tree.map(jnp.asarray, tree)
    mask = trainable_mask(params, None)
    mask["mvn"] = {"mean": False, "std": False}
    tx, _ = jax_build_optimizer(jax_optim_config(raw), trainable=mask)
    tx = skip_nonfinite_by_gnorm(tx)
    jstep = jax_make_train_step(jcfg, tx, accum_grad=2, loss_fn=jasr.forward, donate=False)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))

    model = _model(tree, tcfg)
    ocfg = optim_config_from_dict(raw)
    opt, sched = build_optimizer(model.parameters(), ocfg)
    step = make_train_step(model, tcfg, opt, sched, grad_clip=ocfg.grad_clip,
                           generator=torch.Generator().manual_seed(0), loss_fn=tasr.forward)
    for i in range(3):
        micro = [_batch(seed=20 + 2 * i + a) for a in range(2)]
        stacked = {k: jnp.stack([_jb(m)[k] for m in micro]) for k in micro[0]}
        state, ref = jstep(state, stacked)
        stats = step([_tb(m) for m in micro])
        # (JAX's grad_norm stat also counts the MVN leaves' gradients)
        for k in ("loss", "loss_att", "loss_ctc", "acc"):
            np.testing.assert_allclose(stats[k].item(), float(ref[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    got = numpy_from_conformer_params(model.state_dict(), tcfg)
    for key, leaf in _flat(jax.tree.map(np.asarray, state.params)).items():
        np.testing.assert_allclose(got[key], leaf, atol=1e-5, err_msg=key)

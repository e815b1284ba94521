"""The port's multi-process training on the CPU: 2 gloo ranks, each a
subprocess with torchrun's environment (`tests/torch_mp_worker.py`),
against one process of the same CLI and against JAX.

The data and config are tests/test_multiprocess.py's (MP_CONF: 18 train
utterances, SpecAug on, float32). The port's numel sampler (grid 1)
packs them as [5, 7, 6]: at 2 data ranks the 5- and 7-utterance batches
are ragged and every rank loads them whole (JAX's replicated tail), the
6-utterance one is sharded 3 + 3.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from test_multiprocess import MP_CONF, WORDS  # tests/ is on sys.path

from agacs_tpu.data.io import write_scp, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_data(root, n_train: int, n_valid: int = 8) -> None:
    rng = np.random.RandomState(3)
    for split, n in (("train", n_train), ("valid", n_valid)):
        d = root / "data" / split
        wavs, texts = {}, {}
        for i in range(n):
            u = f"{split}{i:02d}"
            p = str(d / f"{u}.wav")
            write_wav(p, rng.randn(10000 + 640 * i).astype(np.float32) * 0.1)
            wavs[u] = p
            texts[u] = WORDS[i % len(WORDS)]
        write_scp(str(d / "wav.scp"), wavs)
        write_scp(str(d / "text"), texts)


def _conf(root, **over) -> str:
    path = root / "train.yaml"
    path.write_text(yaml.safe_dump({**MP_CONF, **over}))
    return str(path)


def _spawn(root, nproc: int, *worker_args, timeout: float = 300) -> None:
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        log = open(os.path.join(root, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"),
             *map(str, worker_args)], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=REPO), log))
    fails = []
    for rank, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = -9
        log.close()
        if rc != 0:
            with open(os.path.join(root, f"rank{rank}.log")) as f:
                fails.append(f"--- rank {rank} rc={rc}\n" + f.read()[-4000:])
    assert not fails, "\n".join(fails)


def _cli_args(root, conf: str, exp: str, *extra) -> list[str]:
    return ["--config", conf, "--train_dir", str(root / "data" / "train"),
            "--valid_dir", str(root / "data" / "valid"), "--exp_dir", str(root / exp),
            "--device", "cpu", "--compute_dtype", "float32", "--num_att_plot", "0",
            *extra]


def _train_ranks(root, nproc: int, conf: str, exp: str, *extra) -> list[dict]:
    """The CLI at `nproc` gloo ranks; each rank's history."""
    out = root / f"{exp}_h{{rank}}.json"
    _spawn(root, nproc, "train", out, *_cli_args(root, conf, exp, *extra))
    hists = []
    for rank in range(nproc):
        with open(str(out).format(rank=rank)) as f:
            hists.append(json.load(f))
    return hists


def _train_one(root, conf: str, exp: str, *extra) -> dict:
    from agacs_tpu_torch.bin import train

    out = train.main(_cli_args(root, conf, exp, *extra))
    return {str(k): v for k, v in out["history"].items()}


def _no_times(h: dict) -> dict:
    """A history without its per-rank wall clocks (step_time, iter_time)."""
    return {ep: {ph: {k: v for k, v in d.items() if not k.endswith("_time")}
                 for ph, d in phases.items()} for ep, phases in h.items()}


def _close(a: dict, b: dict, keys, tol: float) -> None:
    for ep in b:
        for phase in ("train", "valid"):
            for k in keys:
                x, y = a[ep][phase][k], b[ep][phase][k]
                assert abs(x - y) <= tol, (ep, phase, k, x, y)


def _resumed(root, conf: str, exp: str, *extra, nproc: int = 2) -> list[dict]:
    """`nproc` ranks, 1 epoch, then --resume to 2 on the sharded (DCP)
    backend."""
    _train_ranks(root, nproc, conf, exp, "--ckpt_backend", "orbax", *extra)
    return _train_ranks(root, nproc, conf, exp, "--ckpt_backend", "orbax", "--resume",
                        "--max_epoch", "2", *extra)


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """2 data ranks with ZeRO-1 resumed on DCP, and one process's straight
    2 epochs."""
    root = tmp_path_factory.mktemp("tmp_dp")
    _write_data(root, 18)
    conf = _conf(root)
    hists = _resumed(root, conf, "exp_mp", "--optim_state_shard")
    single = _train_one(root, conf, "exp_sp", "--max_epoch", "2")
    return root, hists, single


def _matches_single(hists, single) -> None:
    h0 = hists[0]
    assert all(_no_times(h) == _no_times(h0) for h in hists[1:])
    assert set(h0) == {"1", "2"}
    _close(h0, single, ("loss", "acc"), 2e-4)
    for ep in single:
        for k in ("cer", "wer"):
            assert abs(h0[ep]["valid"][k] - single[ep]["valid"][k]) <= 2e-4


def test_two_rank_training_matches_one_process(dp_run):
    """Both ranks return the same history through a resume on the DCP
    backend (the Adam moments ZeRO-1 slices, DTensors on the data axis), and
    it matches one process's 2 epochs to 2e-4 on loss and acc (train and
    valid), CER/WER too."""
    root, hists, single = dp_run
    _matches_single(hists, single)
    exp = root / "exp_mp"
    for d in ("checkpoint.params.dcp", "checkpoint.opt.dcp", "1epoch.params.dcp"):
        assert (exp / d / ".metadata").exists(), d
    assert not list(exp.glob("*.params.npz"))[1:]  # the average alone
    with open(exp / "checkpoint_meta.json") as f:
        assert json.load(f)["epoch"] == 2


def test_two_rank_average_loads_in_both_decoders(dp_run):
    """The 2-rank run's `valid.acc.ave.params.npz` holds JAX's layout:
    JAX's `load_pytree_like` reads it into the model's tree, the port's
    decode CLI decodes with it, and its leaves are within 2e-4 of one
    process's average."""
    import jax

    from agacs_tpu.train.checkpoint import load_pytree_like
    from agacs_tpu.utils.config import task_from_dict as jax_task
    from agacs_tpu_torch.bin import decode

    root, _, _ = dp_run
    ave = root / "exp_mp" / "valid.acc.ave.params.npz"
    task = jax_task(MP_CONF)
    template = task.init_fn(jax.random.PRNGKey(0), task.cfg)
    loaded = load_pytree_like(str(ave), template)
    flat = dict(np.load(ave).items())
    assert len(jax.tree.leaves(loaded)) == len(flat)
    sp = dict(np.load(root / "exp_sp" / "valid.acc.ave.params.npz").items())
    assert set(sp) == set(flat)
    worst = max(float(np.max(np.abs(flat[k] - sp[k]))) for k in flat)
    assert worst < 2e-4, worst
    out = root / "decode"
    decode.main(["--config", str(root / "exp_mp" / "config.yaml"), "--params", str(ave),
                 "--data_dir", str(root / "data" / "valid"), "--output_dir", str(out),
                 "--device", "cpu", "--compute_dtype", "float32", "--max_steps", "4"])
    assert len((out / "hyp.trn").read_text().splitlines()) == 8


def test_tensor_parallel_resume_matches_one_process(dp_run, tmp_path):
    """`--tensor_parallel 2` (the shards DTensors on the model axis) through
    a resume on DCP: the history of one process's 2 epochs."""
    root, _, single = dp_run
    conf = str(root / "train.yaml")
    hists = _resumed(root, conf, "exp_tp", "--tensor_parallel", "2")
    _matches_single(hists, single)


def test_mesh_2x2_resume_matches_one_process(dp_run):
    """4 ranks as a 2 x 2 mesh: tensor parallelism over "model" and ZeRO-1
    over "data" together (a moment a DTensor sharded on both axes, on two
    dims), through a resume on DCP: one process's history."""
    root, _, single = dp_run
    hists = _resumed(root, str(root / "train.yaml"), "exp_2x2", "--tensor_parallel", "2",
                     "--optim_state_shard", nproc=4)
    _matches_single(hists, single)


def _step_data(root) -> str:
    """8 train utterances in one batch: one epoch is one step."""
    _write_data(root, 8)
    return _conf(root, batch_bins=8 * 16000)


STEP_RTOL = dict(loss=1e-5, grad_norm=1e-5, loss_att=1e-5, loss_cs=1e-5, acc=1e-5)
# the int8 trunk: a sharded product's partial sums add in another order, so
# now and then a row-quantised value lands across a rounding edge and
# moves one int8 step (1/127 of its row's maximum) in the next layer; the
# bounds of tests/test_torch_int8.py's int8 trajectory after its first step
INT8_STEP_RTOL = dict(loss=1e-4, grad_norm=1e-3, loss_att=1e-4, loss_cs=5e-3, acc=1e-5)
# an element whose gradient moves across zero: Adam's first update is at
# most the learning rate in size, so the two updates differ by at most 2 lr
# (MP_CONF's WarmupLR at step 1: 1e-3 * 4 ** 0.5 * 4 ** -1.5)
INT8_PARAM_ATOL = 2 * 1e-3 * 4 ** 0.5 * 4 ** -1.5


def _one_step_matches(root, conf, *extra, rtol=STEP_RTOL, param_atol=1e-5) -> None:
    """loss and grad_norm of the step within `rtol` of one process's step,
    and every updated parameter within 1e-5 relative and `param_atol`."""
    (h0, h1) = _train_ranks(root, 2, conf, "exp_mp", *extra)
    single = _train_one(root, conf, "exp_sp")
    assert _no_times(h0) == _no_times(h1)
    for k, tol in rtol.items():
        a, b = h0["1"]["train"][k], single["1"]["train"][k]
        assert abs(a - b) <= tol * max(1.0, abs(b)), (k, a, b)
    mp = dict(np.load(root / "exp_mp" / "1epoch.params.npz").items())
    sp = dict(np.load(root / "exp_sp" / "1epoch.params.npz").items())
    assert set(mp) == set(sp)
    for k in sp:
        assert mp[k].shape == sp[k].shape, k
        np.testing.assert_allclose(mp[k], sp[k], rtol=1e-5, atol=param_atol, err_msg=k)


def test_tensor_parallel_step_matches_one_process(tmp_path):
    """`--tensor_parallel 2` (both ranks one data rank, every parameter of
    the model training, token_emb vocabulary-sharded): one step."""
    _one_step_matches(tmp_path, _step_data(tmp_path), "--tensor_parallel", "2")


SIDE = {"n_dim": 32, "n_head": 2, "layers": [0, 1]}
TP_VARIANTS = {
    # the int8 trunk (row scales exchanged over "model"), a PE decoder (its
    # gate and q_cs / k_cs per head) and estimate_c (c_val through copy_in)
    "int8_pe_estimate_c": {"freeze_param": "adapter", "freeze_quant": "int8",
                           "decoder_conf": {**MP_CONF["decoder_conf"], "pe_whisper": True,
                                            "estimate_c": True}},
    # the side ladder trained (downsamples gathered, the upsample on its slice)
    "side_ladder": {"freeze_param": "sidenetwork",
                    "encoder_conf": {**MP_CONF["encoder_conf"], "side_network": True,
                                     "side_network_conf": SIDE},
                    "decoder_conf": {**MP_CONF["decoder_conf"], "side_network": True,
                                     "side_network_conf": SIDE}},
}


@pytest.mark.parametrize("variant", sorted(TP_VARIANTS))
def test_tensor_parallel_variant_step_matches_one_process(variant, tmp_path):
    """`--tensor_parallel 2` on the int8 trunk with a PE decoder and a
    learnable c_val, and on the side ladder: one step."""
    _write_data(tmp_path, 8)
    conf = _conf(tmp_path, batch_bins=8 * 16000, **TP_VARIANTS[variant])
    int8 = "int8" in variant
    _one_step_matches(tmp_path, conf, "--tensor_parallel", "2",
                      rtol=INT8_STEP_RTOL if int8 else STEP_RTOL,
                      param_atol=INT8_PARAM_ATOL if int8 else 1e-5)


def test_zero1_step_matches_one_process(tmp_path):
    """`--optim_state_shard` at 2 data ranks: one step."""
    _one_step_matches(tmp_path, _step_data(tmp_path), "--optim_state_shard")


def test_shape_probe_at_two_ranks_equals_one_process(tmp_path):
    """`collect_num_samples` at 2 ranks (each probing its stride slice of a
    dir without length bounds) equals one process's dict."""
    from agacs_tpu_torch.data.dataset import ASRDataset
    from agacs_tpu_torch.data.shapes import collect_num_samples

    _write_data(tmp_path, 9, 1)
    d = str(tmp_path / "data" / "train")
    _spawn(tmp_path, 2, "shapes", tmp_path / "shapes{rank}.json", d)
    want = collect_num_samples(ASRDataset(d, max_samples=0))
    for rank in range(2):
        with open(tmp_path / f"shapes{rank}.json") as f:
            assert json.load(f) == want


def _numpy_init(path, raw: dict) -> None:
    """An --init_param npz in JAX's layout, every leaf drawn with numpy
    from a seed (layer-norm scales around 1)."""
    import jax

    from agacs_tpu.train.checkpoint import _flatten_with_names
    from agacs_tpu.utils.config import task_from_dict as jax_task

    task = jax_task(raw)
    rng = np.random.RandomState(11)
    leaves = {}
    for name, leaf in _flatten_with_names(task.init_fn(jax.random.PRNGKey(0), task.cfg)):
        x = rng.randn(*leaf.shape).astype(np.float32) * 0.05
        scale = "ln" in name.split("/")[-2] and name.endswith("/w")
        leaves[name] = x + 1.0 if scale else x
    np.savez(path, **leaves)


def test_two_ranks_match_jax_train_cli(tmp_path):
    """The whole slice against JAX: JAX's single-process `train.main` (8 CPU
    devices, its data axis 8) and the port at 2 gloo ranks, one epoch from
    the same numpy-drawn --init_param, fixed_shapes batches (both on a grid
    of 8), accum_grad 1, SpecAug off, float32: loss and acc within 2e-4."""
    from agacs_tpu.bin import train as jtrain

    _write_data(tmp_path, 18)
    over = {"batch_type": "fixed_shapes", "batch_bins": 8 * 32000, "accum_grad": 1,
            "encoder_conf": {**MP_CONF["encoder_conf"], "use_specaug": False}}
    conf = _conf(tmp_path, **over)
    _numpy_init(tmp_path / "init.npz", {**MP_CONF, **over})
    extra = ["--init_param", str(tmp_path / "init.npz"), "--max_epoch", "1"]
    h0, h1 = _train_ranks(tmp_path, 2, conf, "exp_mp", *extra)
    assert _no_times(h0) == _no_times(h1)
    jax_args = [a for a in _cli_args(tmp_path, conf, "exp_jax", *extra)
                if a not in ("--device", "cpu")]
    want = {str(k): v for k, v in jtrain.main(jax_args)["history"].items()}
    with open(tmp_path / "rank0.log") as f:  # batches [8, 10], each 2 row blocks here
        assert "mesh 2 x 1" in f.read()
    assert h0["1"]["train"]["acc"] > 0 and want["1"]["valid"]["acc"] > 0
    _close(h0, want, ("loss", "acc"), 2e-4)


def test_conformer_data_parallel_step_matches_one_process(tmp_path):
    """The conformer family at 2 data ranks (train_asr_conformer.yaml at d
    128, conv_norm batch, dropout 0: the port draws dropout per rank): one
    step's stats and every updated parameter within 1e-5, and the
    BatchNorm running statistics recalibrated from the same batch, each
    rank's rows over the global batch (an all-reduce of sums)."""
    from torch_mp_worker import conformer_step  # tests/ is on sys.path

    from agacs_tpu_torch.parallel.mesh import SINGLE

    _spawn(tmp_path, 2, "conformer", tmp_path / "conformer.npz")
    got = dict(np.load(tmp_path / "conformer.npz").items())
    want = conformer_step(SINGLE)
    assert set(got) == set(want)
    assert want["stat/acc"] >= 0 and np.isfinite(want["stat/loss"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert not np.allclose(want["encoder.blocks.0.conv.running_var"], 1.0)

"""A rank of tests/test_torch_multiprocess.py, run as a subprocess with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) set by the test; not collected by pytest.

    python tests/torch_mp_worker.py train OUT.json <agacs_tpu_torch.bin.train args>
    python tests/torch_mp_worker.py shapes OUT.json DATA_DIR
    python tests/torch_mp_worker.py conformer OUT.npz

`train` runs the port's train CLI and writes this rank's history to OUT
(`{rank}` in it is replaced by the rank); `shapes` joins a gloo group and
`conformer` writes `conformer_step`'s result (rank 0); `shapes`
writes `data/shapes.collect_num_samples` of DATA_DIR (read without
length bounds, so no length is known before the probe).
"""

import json
import os
import sys


CONFORMER_B = 4
CONFORMER_OVERRIDES = [
    "encoder_conf.output_size=128", "encoder_conf.attention_heads=2",
    "encoder_conf.linear_units=256", "encoder_conf.num_blocks=2",
    "encoder_conf.conv_norm=batch", "decoder_conf.attention_heads=2",
    "decoder_conf.linear_units=256", "decoder_conf.num_blocks=1",
    "normalize=utterance_mvn"]


def conformer_step(par) -> dict:
    """One train step of train_asr_conformer.yaml at d 128 / 2 blocks with
    conv_norm batch and dropout 0 on this rank's rows of a seeded batch of
    CONFORMER_B (SpecAug on, at the global batch), then the BatchNorm
    recalibration on the same rows: the stats and every parameter and
    buffer, float32 numpy."""
    import dataclasses

    import numpy as np
    import torch

    from agacs_tpu_torch.bin.train import recalibrate
    from agacs_tpu_torch.models.conformer import sync_batch_norm_
    from agacs_tpu_torch.models.conformer_asr import ConformerASR
    from agacs_tpu_torch.parallel.mesh import batch_rows
    from agacs_tpu_torch.train.freeze import apply_freeze
    from agacs_tpu_torch.train.optim import build_optimizer
    from agacs_tpu_torch.train.trainer import make_train_step
    from agacs_tpu_torch.utils import config as tconfig

    conf = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "recipes", "seame", "conf", "train_asr_conformer.yaml")
    raw = tconfig.apply_overrides(tconfig.load_yaml(conf), CONFORMER_OVERRIDES)
    task = tconfig.task_from_dict(raw, compute_dtype=torch.float32)
    cfg = dataclasses.replace(task.cfg, encoder=dataclasses.replace(task.cfg.encoder,
                                                                     dropout_rate=0.0))
    model = ConformerASR.from_state_dict(cfg, task.init_fn(torch.Generator().manual_seed(0),
                                                           cfg), param_dtype=torch.float32)
    params = apply_freeze(model, None)
    sync_batch_norm_(model, par)
    opt, sched = build_optimizer(params, tconfig.optim_config_from_dict(raw))
    step = make_train_step(model, cfg, opt, sched, grad_clip=5.0, loss_fn=task.loss_fn,
                           generator=torch.Generator().manual_seed(1), par=par)
    rng = np.random.RandomState(2)
    lens = np.array([32000, 28000, 30000, 25000])
    text = np.full((CONFORMER_B, 8), -1, np.int64)
    for i, n in enumerate((8, 5, 7, 3)):
        text[i, :n] = rng.randint(100, 2000, n)
    batch = {"speech": torch.from_numpy(rng.randn(CONFORMER_B, 32000).astype(np.float32)
                                        * 0.1),
             "speech_lengths": torch.from_numpy(lens), "text": torch.from_numpy(text)}
    sl, sharded = batch_rows(par, CONFORMER_B)
    batch = {k: v[sl] for k, v in batch.items()}
    if sharded and par.n_data > 1:
        batch["rows"] = (sl.start, sl.stop, CONFORMER_B)
    stats = {k: float(v) for k, v in step([batch]).items()}
    recalibrate(model, [batch])
    out = {f"stat/{k}": np.float32(v) for k, v in stats.items()}
    out.update({k: v.detach().float().numpy() for k, v in model.state_dict().items()})
    return out


def main() -> None:
    import torch

    torch.set_num_threads(1)
    mode, out = sys.argv[1], sys.argv[2].format(rank=os.environ["RANK"])
    if mode == "train":
        from agacs_tpu_torch.bin import train

        result = {str(k): v for k, v in train.main(sys.argv[3:])["history"].items()}
    elif mode == "conformer":
        import numpy as np

        from agacs_tpu_torch.parallel.mesh import Parallel, init_distributed, make_mesh

        init_distributed("cpu")
        par = Parallel(make_mesh())
        result = conformer_step(par)
        if par.rank == 0:
            np.savez(out, **result)
        return
    else:
        from agacs_tpu_torch.data.dataset import ASRDataset
        from agacs_tpu_torch.data.shapes import collect_num_samples
        from agacs_tpu_torch.parallel.mesh import Parallel, init_distributed, make_mesh

        init_distributed("cpu")
        ds = ASRDataset(sys.argv[3], max_samples=0)  # no bounds: no length read yet
        result = collect_num_samples(ds, Parallel(make_mesh()))
    with open(out, "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()

"""The train CLI's options (agacs_tpu_torch) against agacs_tpu on the CPU:
every batch type's sampler, RIR/noise augmentation, the batch prefetch,
the reporter, the TensorBoard event file, `--print_config`, `estimate_c`
and `cs_loss_type: lid_ce`. The resume paths are in `test_torch_resume.py`.

Tolerances: the samplers, the augmentation, the labels, the event files
and the reporter are exact (the same numpy arithmetic in the same order);
the lid-CE loss agrees to float32 summation order, 1e-5 relative; the
estimate_c gradient 1e-5 relative; the 3-step trajectories compare each
step's loss and global gradient norm within `test_trajectory_matches_jax`'s
1e-5 relative, and the trained leaves within 2e-6 absolute."""

import io
import json
import os
import threading
import time
import wave
from contextlib import redirect_stdout

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.adapt import cs_loss as jcs
from agacs_tpu.data import augment as jaug
from agacs_tpu.data import prefetch as jprefetch
from agacs_tpu.data import sampler as jsampler
from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.text import WhisperTokenIdConverter, WhisperTokenizer
from agacs_tpu.train import observability as jobs
from agacs_tpu.train import reporter as jreporter
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.trainer import build_tx, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu_torch.adapt import cs_loss
from agacs_tpu_torch.data import augment as taug
from agacs_tpu_torch.data import prefetch as tprefetch
from agacs_tpu_torch.data import sampler as tsampler
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.train import observability as tobs
from agacs_tpu_torch.train import reporter as treporter
from agacs_tpu_torch.train.freeze import apply_freeze
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 40  # mel frames -> 20 encoder positions
DIMS = dict(n_mels=80, n_audio_ctx=N_FRAMES // 2, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=3, adapter=True)
T_TEXT = 11
TEXTS = ["我们 go", "hello 你", "好 ok", "去 shop", "that 是 right", "嗯 ok lah",
         "我 think so", "走 了 bye", "ok , 好 !", "hi  there"]


@pytest.fixture(scope="module")
def tok():
    return WhisperTokenizer()


def _lengths(seed: int, n: int) -> dict[str, int]:
    """utt -> sample count, 0.3-31 s with ties (equal lengths keep their
    dict order in both sorts)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(5000, 31 * 16000, n)
    lens[rng.rand(n) < 0.2] = 64000
    return {f"u{seed}-{i:03d}": int(x) for i, x in enumerate(lens)}


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 120), (2, 5)])
@pytest.mark.parametrize("b_grid", [1, 4, 8])
@pytest.mark.parametrize("bins", [900_000, 4_000_000])
def test_numel_and_fixed_shapes_match_jax(seed, n, b_grid, bins):
    lens = _lengths(seed, n)
    for shuffle in (False, True):
        assert tsampler.num_elements_batches(
            lens, bins, b_grid=b_grid, shuffle_batches=shuffle, seed=seed
        ) == jsampler.num_elements_batches(lens, bins, b_grid=b_grid,
                                           shuffle_batches=shuffle, seed=seed)
        for ratio in (1.3, 1.1):
            assert tsampler.fixed_shape_batches(
                lens, bins, b_grid=b_grid, shuffle_batches=shuffle, seed=seed, ratio=ratio
            ) == jsampler.fixed_shape_batches(lens, bins, b_grid=b_grid,
                                              shuffle_batches=shuffle, seed=seed,
                                              ratio=ratio)


@pytest.mark.parametrize("seed,n", [(3, 41), (4, 97), (5, 3)])
@pytest.mark.parametrize("batch_size", [1, 4, 20])
def test_sorted_unsorted_folded_match_jax(seed, n, batch_size):
    lens = _lengths(seed, n)
    toks = {u: 3 + (x // 997) % 160 for u, x in lens.items()}
    cats = {u: "ab"[i % 2] for i, u in enumerate(lens)}
    for drop_last in (False, True):
        for sort_in, sort_b in (("descending", "ascending"), ("ascending", "ascending"),
                                ("descending", "descending")):
            assert tsampler.sorted_batches(lens, batch_size, sort_in, sort_b, drop_last) \
                == jsampler.sorted_batches(lens, batch_size, sort_in, sort_b, drop_last)
            for fold in ((80000, 150), (160000, 40)):
                for min_bs in (1, 3):
                    kw = dict(min_batch_size=min_bs, sort_in_batch=sort_in,
                              sort_batch=sort_b, drop_last=drop_last)
                    assert tsampler.folded_batches([lens, toks], batch_size, list(fold), **kw) \
                        == jsampler.folded_batches([lens, toks], batch_size, list(fold), **kw)
            kw = dict(sort_in_batch=sort_in, sort_batch=sort_b, drop_last=drop_last,
                      utt2category=cats)
            assert tsampler.folded_batches([lens, toks], batch_size, [80000, 150], **kw) \
                == jsampler.folded_batches([lens, toks], batch_size, [80000, 150], **kw)
        for cat in (None, cats):
            assert tsampler.unsorted_batches(list(lens), batch_size, drop_last, cat) \
                == jsampler.unsorted_batches(list(lens), batch_size, drop_last, cat)


@pytest.mark.parametrize("seed,n", [(6, 29), (7, 150)])
@pytest.mark.parametrize("bins", [300_000, 2_500_000])
def test_length_batches_match_jax(seed, n, bins):
    lens = _lengths(seed, n)
    toks = {u: 3 + (x // 997) % 160 for u, x in lens.items()}
    for padding in (True, False):
        for min_bs in (1, 4):
            for sort_b in ("ascending", "descending"):
                for drop_last in (False, True):
                    kw = dict(min_batch_size=min_bs, sort_batch=sort_b,
                              drop_last=drop_last, padding=padding)
                    assert tsampler.length_batches([lens, toks], bins, **kw) \
                        == jsampler.length_batches([lens, toks], bins, **kw)


@pytest.mark.parametrize("ratio", [1.05, 1.3, 2.0])
def test_buckets_match_jax(ratio):
    assert tsampler.geometric_s_buckets(ratio=ratio) == jsampler.geometric_s_buckets(ratio=ratio)
    for n in (1, 15999, 16000, 16001, 480000, 600000):
        assert tsampler.bucket_length(n, 16000, 480000) == jsampler.bucket_length(n, 16000, 480000)
        assert tsampler.bucket_length(n, 8) == jsampler.bucket_length(n, 8)


def test_trainer_batch_fields_match_jax():
    from agacs_tpu.utils import config as jconfig
    from agacs_tpu_torch.utils import config as tconfig

    d = {"batch_type": "folded", "batch_size": 7, "fold_length": [40000, 60],
         "shape_ratio": 1.2}
    for raw in ({}, d):
        t, j = tconfig.trainer_config_from_dict(raw), jconfig.trainer_config_from_dict(raw)
        assert (t.batch_type, t.batch_size, t.fold_length, t.shape_ratio) == (
            j.batch_type, j.batch_size, j.fold_length, j.shape_ratio)


def _wav(path, samples):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(samples, -32768, 32767).astype(np.int16).tobytes())


def _write_dir(path, utts, seed):
    path.mkdir()
    rng = np.random.RandomState(seed)
    for u, (n, _) in utts.items():
        _wav(path / f"{u}.wav", rng.randn(n) * 3000)
    (path / "wav.scp").write_text("".join(f"{u} {path / u}.wav\n" for u in utts))
    (path / "text").write_text("".join(f"{u} {t}\n" for u, (_, t) in utts.items()))


@pytest.mark.parametrize("batch_type", ["numel", "sorted", "unsorted", "folded", "length",
                                        "fixed_shapes"])
def test_cli_batches_and_padding_match_jax(batch_type, tmp_path, tok):
    """The port CLI's sampler over a data dir gives JAX's batches (JAX's
    CLI's arguments: b_grid 8 for fixed_shapes, 1 for numel as the port's
    CLI packs it), padded as JAX's `make_batch` pads them."""
    from agacs_tpu.data.dataset import ASRDataset as JDataset
    from agacs_tpu_torch.bin import train
    from agacs_tpu_torch.data.dataset import ASRDataset
    from agacs_tpu_torch.data.prefetch import HostToDevice
    from agacs_tpu_torch.utils.config import trainer_config_from_dict

    _write_dir(tmp_path / "d", {f"t{i}": (8000 + 1900 * i, TEXTS[i % len(TEXTS)])
                                for i in range(13)}, seed=0)
    ds, jds = ASRDataset(str(tmp_path / "d")), JDataset(str(tmp_path / "d"))
    tcfg = trainer_config_from_dict({"batch_size": 4, "fold_length": [12000, 150]})
    lens = {u: ds.num_samples(u) for u in ds.utt_ids}
    toks = {u: jds.num_tokens(u) for u in lens}
    sample_epoch, s_pad_of = train.batch_sampler(batch_type, tcfg, 60000)
    ref = {"numel": lambda: jsampler.num_elements_batches(lens, 60000, shuffle_batches=True,
                                                          seed=5),
           "fixed_shapes": lambda: jsampler.fixed_shape_batches(
               lens, 60000, b_grid=8, shuffle_batches=True, seed=5, ratio=1.3),
           "sorted": lambda: jsampler.sorted_batches(lens, 4),
           "unsorted": lambda: jsampler.unsorted_batches(list(lens), 4),
           "folded": lambda: jsampler.folded_batches([lens, toks], 4, [12000, 150]),
           "length": lambda: jsampler.length_batches([lens, toks], 60000)}[batch_type]()
    if batch_type not in ("numel", "fixed_shapes"):
        np.random.RandomState(5).shuffle(ref)
    batches = sample_epoch(ds, lens, shuffle=True, seed=5)
    assert batches == ref and len(batches) > 1
    buckets = jsampler.geometric_s_buckets()
    for utts in batches:
        b = train.make_batch(ds, utts, s_pad_of, HostToDevice("cpu"))
        mx = max(lens[u] for u in utts)
        s_pad = (next(s for s in buckets if mx <= s) if batch_type == "fixed_shapes"
                 else jsampler.bucket_length(mx, 16000, 480000))
        assert b["speech"].shape == (len(utts), s_pad)
        assert b["text"].shape == (len(utts), jsampler.bucket_length(
            max(toks[u] for u in utts), 8)) and b["text"].dtype == torch.int64


# ---------------------------------------------------------------------------
# RIR / noise augmentation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aug_files(tmp_path_factory):
    """RIRs (one 2-channel) and noises (shorter and longer than speech, and
    a `key path` line) as WAVs from a seed, with their scp files."""
    d = tmp_path_factory.mktemp("aug")
    rng = np.random.RandomState(11)
    rirs, noises = [], []
    for i, n in enumerate((400, 1200)):
        rir = np.exp(-np.arange(n) / (60.0 * (i + 1))) * rng.randn(n) * 20000
        _wav(d / f"rir{i}.wav", rir)
        rirs.append(str(d / f"rir{i}.wav"))
    for i, n in enumerate((3000, 30000, 16000)):
        _wav(d / f"noise{i}.wav", rng.randn(n) * 1500)
        noises.append(str(d / f"noise{i}.wav"))
    (d / "rir.scp").write_text("".join(f"{p}\n" for p in rirs))
    (d / "noise.scp").write_text("".join(f"n{i} {p}\n" for i, p in enumerate(noises)))
    return str(d / "rir.scp"), str(d / "noise.scp")


@pytest.mark.parametrize("conf", [
    dict(rir=True, noise=True), dict(rir=True), dict(noise=True, noise_db_range="5"),
    dict(noise=True, rir=True, rir_apply_prob=0.5, noise_apply_prob=0.5,
         noise_db_range="-3_4"),
    dict(volume=0.7), dict(rir=True, noise=True, volume=0.9)], ids=str)
def test_speech_augment_matches_jax(conf, aug_files):
    """8 calls in order from one seed: the same outputs, bit for bit."""
    d = {"rir_scp": aug_files[0] if conf.get("rir") else None,
         "noise_scp": aug_files[1] if conf.get("noise") else None,
         "speech_volume_normalize": conf.get("volume")}
    for k in ("rir_apply_prob", "noise_apply_prob", "noise_db_range"):
        if k in conf:
            d[k] = conf[k]
    port, ref = taug.augment_from_dict(d, seed=3), jaug.augment_from_dict(d, seed=3)
    rng = np.random.RandomState(4)
    for i in range(8):
        speech = (rng.randn(9000 + 2000 * i) * 0.05).astype(np.float32)
        speech[: 2000] *= 0.001  # a quiet lead-in for the VAD
        out, want = port(speech), ref(speech)
        assert out.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(out, want)
    assert taug.augment_from_dict({}) is None and jaug.augment_from_dict({}) is None


@pytest.mark.parametrize("shape,frame", [((5000,), 1024), ((2, 7000), 1024), ((300,), 1024),
                                         ((3, 4096), 512)])
def test_detect_non_silence_matches_jax(shape, frame):
    rng = np.random.RandomState(len(shape))
    x = rng.randn(*shape)
    x[..., : shape[-1] // 3] *= 1e-3
    np.testing.assert_array_equal(
        taug.detect_non_silence(x, frame_length=frame, frame_shift=frame // 2),
        jaug.detect_non_silence(x, frame_length=frame, frame_shift=frame // 2))
    xi = (x * 1000).astype(np.int16)
    np.testing.assert_array_equal(taug.detect_non_silence(xi), jaug.detect_non_silence(xi))
    np.testing.assert_array_equal(taug.detect_non_silence(np.zeros(shape)),
                                  jaug.detect_non_silence(np.zeros(shape)))


def test_dataset_applies_augment_like_jax(tmp_path, aug_files):
    from agacs_tpu.data.dataset import ASRDataset as JDataset
    from agacs_tpu_torch.data.dataset import ASRDataset

    _write_dir(tmp_path / "d", {f"t{i}": (9000 + 700 * i, TEXTS[i]) for i in range(4)},
               seed=2)
    conf = {"rir_scp": aug_files[0], "noise_scp": aug_files[1]}
    ds = ASRDataset(str(tmp_path / "d"), augment=taug.augment_from_dict(conf, seed=9))
    jds = JDataset(str(tmp_path / "d"), augment=jaug.augment_from_dict(conf, seed=9))
    for u in ds.utt_ids * 2:
        a, b = ds[u], jds[u]
        np.testing.assert_array_equal(a["speech"], b["speech"])
        np.testing.assert_array_equal(a["cs_labels"], b["cs_labels"])


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def _gated(n_items):
    """make_batch that records each call and takes ~10 ms."""
    calls, lock = [], threading.Lock()

    def make(utts):
        time.sleep(0.01)
        with lock:
            calls.append(utts[0])
        return {"id": utts[0]}

    return make, calls, [[i] for i in range(n_items)]


@pytest.mark.parametrize("threads", [1, 2, 3])
@pytest.mark.parametrize("lookahead", [0, 2])
def test_prefetch_order_and_lookahead_match_jax(threads, lookahead):
    """In order; before the first batch is taken the workers stop after
    lookahead + 1 builds, as JAX's do."""
    want = min(9, lookahead + 2)
    for fn in (tprefetch.prefetch_batches, jprefetch.prefetch_batches):
        make, calls, ids = _gated(9)
        it = fn(make, ids, lookahead=lookahead, num_threads=threads)
        first = next(it)
        deadline = time.monotonic() + 10.0
        while len(calls) < want and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # a build past the lookahead would show by now
        built_ahead = len(calls)
        rest = list(it)
        assert [first["id"]] + [b["id"] for b in rest] == list(range(9))
        assert sorted(calls) == list(range(9))
        assert built_ahead == want, fn.__module__


@pytest.mark.parametrize("fail_at", [0, 3, 8])
def test_prefetch_reraises_a_workers_exception(fail_at):
    def make(utts):
        if utts[0] == fail_at:
            raise KeyError(f"bad batch {fail_at}")
        return utts[0]

    for fn in (tprefetch.prefetch_batches, jprefetch.prefetch_batches):
        got = []
        with pytest.raises(KeyError, match=f"bad batch {fail_at}"):
            for b in fn(make, [[i] for i in range(9)], lookahead=2, num_threads=2):
                got.append(b)
        # batches come in order up to the failure; one built after a later
        # batch failed is not handed out (JAX's rule)
        assert got == list(range(len(got))) and len(got) <= fail_at


def test_prefetch_stops_its_workers_when_closed():
    make, calls, ids = _gated(50)
    before = threading.active_count()
    it = tprefetch.prefetch_batches(make, ids, lookahead=2, num_threads=2)
    next(it)
    it.close()
    assert threading.active_count() == before and len(calls) < 10
    assert list(tprefetch.prefetch_batches(make, [], lookahead=2)) == []


def test_host_to_device_on_the_cpu_collates_like_to_device():
    from agacs_tpu_torch.data.collate import collate_batch, to_device

    rng = np.random.RandomState(0)
    items = [{"utt_id": f"u{i}", "speech": rng.randn(900 * (i + 1)).astype(np.float32),
              "text": np.arange(3 + i, dtype=np.int32),
              "cs_labels": np.ones(4 + i, np.int8)} for i in range(3)]
    feeder = tprefetch.HostToDevice("cpu")
    out = feeder.ready(feeder.collate(items, pad_to=(16000, 8)))
    want = to_device(collate_batch(items, pad_to=(16000, 8)), "cpu")
    assert out.keys() == want.keys()
    for k in out:
        assert torch.equal(out[k], want[k]) and out[k].dtype == want[k].dtype
    arrays = {}

    def alloc(name, shape, dtype, fill):
        arrays[name] = np.full(shape, fill, dtype)
        return arrays[name]

    got = collate_batch(items, alloc=alloc)
    assert set(arrays) == {"speech", "speech_lengths", "text", "text_lengths", "cs_labels"}
    assert all(got[k] is arrays[k] for k in arrays)


# ---------------------------------------------------------------------------
# reporter, event files, wandb sink
# ---------------------------------------------------------------------------


def _fill(rep_mod, history):
    rep = rep_mod.Reporter()
    rep.history = history
    rng = np.random.RandomState(8)
    for epoch in (1, 2):
        for phase in ("train", "valid"):
            sub = rep.start_epoch(phase, epoch)
            for i in range(5):
                stats = {"loss": float(rng.rand()), "acc": float(rng.rand()),
                         "grad_norm": float("nan") if i == 2 else float(rng.rand()),
                         "cer": None if i == 1 else float(rng.rand())}
                sub.register(stats, weight=1 + i)
            sub.add_time("iter_time", 0.25 * epoch)
            rep.finish_epoch(sub)
    return rep


def test_reporter_history_and_json_match_jax(tmp_path):
    port, ref = _fill(treporter, {}), _fill(jreporter, {})
    assert port.history == ref.history
    assert set(port.history[2]["valid"]) == {"loss", "acc", "grad_norm", "cer", "iter_time"}
    port.dump(str(tmp_path / "a.json"))
    ref.dump(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    sub = treporter.SubReporter("train", 1)
    with sub.measure_time("step_time"):
        time.sleep(0.01)
    assert sub.mean()["step_time"] >= 0.01


@pytest.mark.parametrize("n", [0, 1, 7, 300, 4096])
def test_crc32c_matches_jax(n):
    data = np.random.RandomState(n).bytes(n)
    assert tobs.crc32c(data) == jobs.crc32c(data)
    assert tobs.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_event_files_read_both_ways(tmp_path):
    history = {1: {"train": {"loss": 2.5, "acc": 0.1}, "valid": {"acc": 0.2, "cer": 0.9}},
               2: {"train": {"loss": 1.25, "acc": 0.3}, "valid": {"acc": 0.4, "cer": 0.7}}}
    for name, writer in (("port", tobs.TensorboardWriter), ("jax", jobs.TensorboardWriter)):
        w = writer(str(tmp_path / name))
        for ep, d in history.items():
            w.add_scalars(ep, {f"{ph}/{k}": v for ph, m in d.items() for k, v in m.items()})
        w.close()
    for name in ("port", "jax"):
        (path,) = (tmp_path / name).iterdir()
        for reader in (tobs.read_event_file, jobs.read_event_file):
            events = reader(str(path))
            assert events[0]["values"] == {} and [e["step"] for e in events[1:]] == [1, 2]
            for e in events[1:]:
                assert e["values"] == {f"{ph}/{k}": float(np.float32(v))  # simple_value
                                       for ph, m in history[e["step"]].items()
                                       for k, v in m.items()}
    raw = next((tmp_path / "port").iterdir()).read_bytes()
    bad = tmp_path / "bad"
    bad.write_bytes(raw[:-1] + bytes([raw[-1] ^ 1]))
    with pytest.raises(AssertionError, match="CRC"):
        tobs.read_event_file(str(bad))


def test_wandb_sink_writes_jaxs_offline_files(tmp_path):
    for name, sink in (("port", tobs.WandbSink), ("jax", jobs.WandbSink)):
        s = sink(str(tmp_path / name))
        s.log_epoch(1, {"train": {"loss": 1.5}, "valid": {"acc": 0.5}})
        s.log_epoch(2, {"train": {"loss": 1.0}, "valid": {"acc": 0.75}})
        s.log_artifact(str(tmp_path / name / "metrics.jsonl"))
    assert (tmp_path / "port" / "metrics.jsonl").read_text() == (
        tmp_path / "jax" / "metrics.jsonl").read_text()
    a, b = (json.loads((tmp_path / n / "artifacts.json").read_text()) for n in ("port", "jax"))
    assert [e["kind"] for e in a] == [e["kind"] for e in b] == ["model"]


def test_plot_history_writes_a_curve_per_metric(tmp_path):
    pytest.importorskip("matplotlib")
    history = {1: {"train": {"loss": 2.0, "iter_time": 3.0}, "valid": {"acc": 0.2}},
               2: {"train": {"loss": 1.0, "iter_time": 3.0}, "valid": {"acc": 0.4}}}
    out = tobs.plot_history(history, str(tmp_path / "images"))
    assert sorted(os.path.basename(p) for p in out) == ["acc.png", "loss.png"]
    ref = jobs.plot_history(history, str(tmp_path / "jimages"))
    assert sorted(map(os.path.basename, out)) == sorted(map(os.path.basename, ref))


# ---------------------------------------------------------------------------
# --print_config
# ---------------------------------------------------------------------------

# JAX's TPU execution knobs, which the port does not have
TPU_ONLY = {"attention_backend", "remat", "unroll_layers"}


def _is_dtype(v) -> bool:
    return isinstance(v, str) and ("bfloat16" in v or "float32" in v)


def _same_config(port, ref, path=""):
    if isinstance(ref, dict):
        keys = set(ref) - (TPU_ONLY if path.startswith("._resolved_model_config") else set())
        assert set(port) == keys, (path, set(port) ^ keys)
        for k in keys:
            _same_config(port[k], ref[k], f"{path}.{k}")
    elif _is_dtype(ref):  # jnp and torch spell dtypes differently
        assert _is_dtype(port) and ("bfloat16" in port) == ("bfloat16" in ref), path
    else:
        assert port == ref, (path, port, ref)


@pytest.mark.parametrize("config,overrides", [
    ("train_asr_whisper_small_adapter_csloss_2stage.yaml", []),
    ("train_asr_whisper_small_adapter_csloss_2stage.yaml",
     ["decoder_conf.estimate_c=true", "model_conf.cs_loss_type=lid_ce",
      "model_conf.head_percentage=50"]),
    ("train_asr_conformer.yaml", []),
], ids=["recipe", "estimate_c_lid_ce", "conformer"])
def test_print_config_matches_jax(config, overrides, tmp_path, monkeypatch):
    import yaml

    from agacs_tpu.bin import train as jtrain
    from agacs_tpu_torch.bin import train

    monkeypatch.setenv("AGACS_JAX_CACHE", str(tmp_path / "jax_cache"))
    argv = ["--config", os.path.join(REPO, "recipes", "seame", "conf", config),
            "--train_dir", str(tmp_path), "--valid_dir", str(tmp_path), "--exp_dir",
            str(tmp_path / "exp"), "--print_config", "--override", *overrides]
    outs = []
    for main in (train.main, jtrain.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv) == {"printed": True}
        outs.append(yaml.safe_load(buf.getvalue()))
    port, ref = outs
    assert list(port) == list(ref) and "_resolved_model_config" in port
    _same_config(port, ref)
    assert not (tmp_path / "exp").exists()


# ---------------------------------------------------------------------------
# estimate_c and lid_ce
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    jcfg = jasr.ASRModelConfig(whisper=jw.WhisperConfig(**DIMS), use_specaug=False, **kw)
    tcfg = asr_model.ASRModelConfig(whisper=tw.WhisperConfig(**DIMS), use_specaug=False,
                                    **kw)
    return jcfg, tcfg


def _model(params, tcfg, preset=None):
    model = tw.Whisper.from_state_dict(
        tcfg.whisper, params_from_numpy(jax.tree.map(np.asarray, params), tcfg.whisper))
    if preset is not None:
        apply_freeze(model, preset)
    return model


def _batch(tok, seed, b=2, mode="attention"):
    conv = WhisperTokenIdConverter(tok)
    rng = np.random.RandomState(seed)
    text = np.full((b, T_TEXT), -1, np.int32)
    for i in range(b):
        ids = conv.tokens2ids(tok.text2tokens(TEXTS[(seed * b + i) % len(TEXTS)]))
        text[i, : len(ids[:T_TEXT])] = ids[:T_TEXT]
    ys_in = np.where(text == -1, 50257, text)
    ys_in = np.concatenate([np.full((b, 1), 50258, np.int32), ys_in], axis=1)
    return {"speech": (rng.randn(b, N_FRAMES * 160) * 0.05).astype(np.float32),
            "speech_lengths": np.full((b,), N_FRAMES * 160, np.int32), "text": text,
            "cs_labels": jcs.attention_target_labels(ys_in, tok, mode=mode)}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["text"] = out["text"].long()
    return out


def test_lid_labels_match_jax(tok):
    conv = WhisperTokenIdConverter(tok)
    rows = [[50258] + conv.tokens2ids(tok.text2tokens(t)) for t in TEXTS]
    width = max(map(len, rows)) + 2
    ys_in = np.full((len(rows), width), 50257, np.int32)
    for i, r in enumerate(rows):
        ys_in[i, : len(r)] = r
    for mode in ("attention", "lid_ce"):
        out = cs_loss.attention_target_labels(ys_in, tok, mode=mode)
        np.testing.assert_array_equal(out, jcs.attention_target_labels(ys_in, tok, mode=mode))
    lid = cs_loss.attention_target_labels(ys_in, tok, mode="lid_ce")
    assert cs_loss.LANG_BOTH not in set(lid.ravel().tolist())
    assert (lid[:, [0, 3, 4]] == cs_loss.LANG_PAD).all()


@pytest.mark.parametrize("lsm", [0.0, 0.1])
def test_cs_lid_ce_loss_matches_jax(lsm):
    rng = np.random.RandomState(int(lsm * 10))
    n_l, b, h, t = 3, 2, 4, 10
    maps = rng.randn(n_l, b, h, t, t).astype(np.float32) * 3
    maps[..., np.triu_indices(t, 1)[0], np.triu_indices(t, 1)[1]] = -np.inf
    labels = rng.randint(0, 5, (b, t)).astype(np.int8)
    lens = np.array([t + 1, 6], np.int32)
    head_mask = (rng.rand(n_l, h) > 0.4).astype(np.float32)
    ref = jcs.cs_lid_ce_loss(jnp.asarray(maps), jnp.asarray(labels), jnp.asarray(lens),
                             jnp.asarray(head_mask), lsm_weight=lsm)
    m = torch.from_numpy(maps).requires_grad_()
    out = cs_loss.cs_lid_ce_loss(m, torch.from_numpy(labels), torch.from_numpy(lens).long(),
                                 torch.from_numpy(head_mask), lsm_weight=lsm)
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    g_ref = jax.grad(lambda x: jcs.cs_lid_ce_loss(x, jnp.asarray(labels), jnp.asarray(lens),
                                                  jnp.asarray(head_mask), lsm))(
        jnp.asarray(np.where(np.isinf(maps), 0.0, maps)))
    out.backward()
    fin = np.isfinite(maps)
    np.testing.assert_allclose(m.grad.numpy()[fin], np.asarray(g_ref)[fin], rtol=1e-5,
                               atol=1e-7)


def test_estimate_c_loss_and_gradient_match_jax(tok):
    jcfg, tcfg = _cfgs(cs_weight=0.5, estimate_c=True)
    params = jasr.init_asr_params(jax.random.PRNGKey(3), jcfg)
    params["estimated_c_val"] = jnp.asarray([0.45], jnp.float32)
    model = _model(params, tcfg, preset="adapter")
    assert model.estimated_c_val.requires_grad
    assert torch.equal(model.estimated_c_val.detach(), torch.tensor([0.45]))
    batch = _batch(tok, seed=2)
    (ref, stats), grads = jax.value_and_grad(
        lambda p: jasr.forward(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                               train=False), has_aux=True)(params)
    loss, tstats = asr_model.forward(model, tcfg, _torch_batch(batch), train=False)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(tstats["loss_cs"]), float(stats["loss_cs"]), rtol=1e-5)
    g = float(model.estimated_c_val.grad[0])
    assert g != 0.0
    np.testing.assert_allclose(g, float(grads["estimated_c_val"][0]), rtol=1e-5)
    sd = asr_model.init_asr_params(torch.Generator().manual_seed(0), tcfg)
    assert torch.equal(sd["estimated_c_val"], torch.tensor([0.6]))
    flat = numpy_from_params(model.state_dict())
    assert flat["estimated_c_val"].dtype == np.float32
    assert flat["estimated_c_val"][0] == np.float32(0.45)
    back = params_from_numpy(flat, tcfg.whisper)
    assert torch.equal(back["estimated_c_val"], torch.tensor([0.45]))


@pytest.mark.parametrize("option", ["estimate_c", "lid_ce"])
def test_trajectory_matches_jax(option, tok):
    """3 optimizer steps (adapter preset, clip 1.0, WarmupLR with 3 warmup
    steps) against JAX's make_train_step + build_tx."""
    kw = dict(estimate_c=True) if option == "estimate_c" else dict(cs_loss_type="lid_ce")
    mode = "lid_ce" if option == "lid_ce" else "attention"
    jcfg, tcfg = _cfgs(cs_weight=0.5, **kw)
    params = jasr.init_asr_params(jax.random.PRNGKey(7), jcfg)
    tx, mask = build_tx(params, JOptimConfig(warmup_steps=3), freeze_preset="adapter")
    jstep = jax_make_train_step(jcfg, tx, trainable_mask=mask, donate=False)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))
    model = _model(params, tcfg, preset="adapter")
    opt, sched = build_optimizer([p for p in model.parameters() if p.requires_grad],
                                 OptimConfig(warmup_steps=3))
    step = make_train_step(model, tcfg, opt, sched, grad_clip=1.0)
    for i in range(3):
        batch = _batch(tok, seed=i, mode=mode)
        state, ref = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        stats = step([_torch_batch(batch)])
        for k in ("loss", "loss_att", "loss_cs", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert float(stats["loss_cs"]) > 0
    out = numpy_from_params(model.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(k.key) for k in path)
        np.testing.assert_allclose(out[key], np.asarray(leaf), atol=2e-6, err_msg=key)
    if option == "estimate_c":
        assert abs(model.estimated_c_val.item() - 0.6) > 1e-6


def test_lid_ce_with_a_pe_decoder_still_raises():
    with pytest.raises(ValueError, match="lid_ce"):
        asr_model.ASRModelConfig(whisper=tw.make_config("test", pe_attention=True),
                                 cs_weight=0.1, cs_loss_type="lid_ce")


def test_train_cli_sinks_plots_and_detect_anomaly(tmp_path, monkeypatch):
    """bin.train with --detect_anomaly (autograd's anomaly mode asked for),
    --num_att_plot 2 and --batch_type length for 2 epochs: the history has
    the reporter's times, the event file and metrics.jsonl read back its
    scalars, and (with matplotlib) each epoch plots every metric and 2
    attention maps."""
    from agacs_tpu_torch.bin import train

    asked = []
    monkeypatch.setattr(torch.autograd, "set_detect_anomaly", asked.append)
    _write_dir(tmp_path / "d", {f"t{i}": (8000 + 900 * i, TEXTS[i]) for i in range(4)},
               seed=3)
    exp = tmp_path / "exp"
    out = train.main(["--config", os.path.join(REPO, "recipes", "seame", "conf",
                                               "train_asr_whisper_small_adapter_csloss_2stage.yaml"),
                      "--train_dir", str(tmp_path / "d"), "--valid_dir", str(tmp_path / "d"),
                      "--exp_dir", str(exp), "--max_epoch", "2", "--batch_type", "length",
                      "--batch_bins", "40000", "--device", "cpu", "--compute_dtype", "float32",
                      "--detect_anomaly", "--num_att_plot", "2", "--override",
                      "encoder_conf.whisper_model=test", "decoder_conf.whisper_model=test",
                      "accum_grad=1"])
    assert asked == [True]
    history = out["history"]
    assert {"iter_time", "step_time", "loss", "grad_norm"} <= set(history[2]["train"])
    assert json.loads((exp / "train_history.json").read_text()) == {
        str(k): v for k, v in history.items()}
    (events,) = (exp / "tensorboard").iterdir()
    read = jobs.read_event_file(str(events))
    assert [e["step"] for e in read[1:]] == [1, 2]
    for e in read[1:]:
        assert e["values"] == {f"{ph}/{k}": float(np.float32(v))
                               for ph, d in history[e["step"]].items() for k, v in d.items()}
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [1, 2] and lines[1]["train/loss"] == history[2]["train"]["loss"]
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return
    att = sorted(p.name for p in (exp / "att_ws").iterdir())
    assert len(att) == 2 and all(
        sorted(q.name for q in (exp / "att_ws" / u).iterdir()) == ["ep1.png", "ep2.png"]
        for u in att)
    assert (exp / "images" / "loss.png").exists() and not (exp / "images" / "iter_time.png").exists()

"""The port's audio readers and data dirs against agacs_tpu's on the same
files (numpy-seeded): FLAC through the native codec and the Python
decoder, extended-ark entries with FLAC and WAV blobs, NIST SPHERE, .npy
and a WAV under another suffix are bit-identical to JAX's `read_wav` /
`wav_num_samples`; corrupt FLAC raises in both; `ASRDataset` over a
`segments` dir with `utt2num_samples`, a mixed ark + wav dir (the
recipe's `train_sp`) and `.sph` entries gives JAX's utterances, lengths,
audio and tokens; `bin.decode` reads those dirs."""


import numpy as np
import pytest

import torch

from agacs_tpu.data import ASRDataset as JaxASRDataset
from agacs_tpu.data import flac as JF
from agacs_tpu.data import io as jio
from agacs_tpu.data import kaldi_ark as JK
from agacs_tpu_torch.data import flac as F
from agacs_tpu_torch.data import io as tio
from agacs_tpu_torch.data import kaldi_ark as K
from agacs_tpu_torch.data.dataset import ASRDataset

torch.set_num_threads(1)

SR = 16000


def _signal(n, seed, channels=1):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * (200 + 37 * seed) * t) + 0.05 * rng.randn(n)
    if channels == 2:
        x = np.stack([x, -0.5 * x + 0.01 * rng.randn(n)], axis=1)
    return x.astype(np.float32)


def _same_audio(path):
    """read_wav and wav_num_samples of both packages on one wav.scp value."""
    got, sr = tio.read_wav(path)
    ref, ref_sr = jio.read_wav(path)
    assert sr == ref_sr and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert tio.wav_num_samples(path) == jio.wav_num_samples(path) == len(ref)
    return got


def _write_sph(path, samples, byte_format="01", coding="pcm", n_bytes=2, channels=1):
    """A NIST SPHERE file: the 1024-byte ASCII header, then the payload."""
    lines = [f"sample_count -i {samples.nbytes // (n_bytes * channels)}", f"sample_rate -i {SR}",
             f"channel_count -i {channels}", f"sample_n_bytes -i {n_bytes}",
             f"sample_byte_format -s{len(byte_format)} {byte_format}",
             f"sample_coding -s{len(coding)} {coding}", "end_head"]
    header = b"NIST_1A\n   1024\n" + "\n".join(lines).encode("ascii")
    with open(path, "wb") as f:
        f.write(header + b" " * (1024 - len(header)) + samples.tobytes())


# ---------------------------------------------------------------- FLAC


@pytest.mark.parametrize("n,channels", [(0, 1), (1, 1), (4095, 1), (4096, 1), (4097, 1),
                                        (20000, 1), (9000, 2)])
def test_flac_codec_matches_jax(n, channels, tmp_path):
    """The port's encoder writes JAX's bytes; its native decoder and its
    Python decoder read them as JAX does."""
    pcm = F.float_to_pcm16(_signal(n, n % 7, channels))
    blob = F.encode_flac(pcm, SR)
    assert blob == JF.encode_flac(pcm, SR)
    native, sr = F.decode_flac(blob)
    plain, _ = F.decode_flac(blob, native=False)
    np.testing.assert_array_equal(native, pcm.reshape(n, channels))
    np.testing.assert_array_equal(plain, native)
    assert sr == SR
    path = str(tmp_path / "a.flac")
    F.write_flac(path, _signal(n, 3, channels) if channels == 1 else pcm / 32768.0, SR)
    got = _same_audio(path)
    np.testing.assert_array_equal(F.read_flac(path, native=False)[0], got)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("damage", ["not_flac", "flipped", "truncated"])
def test_corrupt_flac_raises_in_both(damage, native):
    blob = bytearray(F.encode_flac(F.float_to_pcm16(_signal(9000, 1)), SR))
    if damage == "not_flac":
        blob = bytearray(b"RIFFnotflac")
    elif damage == "flipped":  # PCM-affecting bits: the MD5 check catches it
        blob[len(blob) // 2] ^= 0xFF
    else:
        blob = blob[: len(blob) // 2]
    with pytest.raises(JF.FlacError):
        JF.decode_flac(bytes(blob))
    with pytest.raises(F.FlacError):
        F.decode_flac(bytes(blob), native=native)


# ---------------------------------------------------------------- arks


@pytest.mark.parametrize("fmt", ["flac", "wav"])
def test_ark_entries_match_jax(fmt, tmp_path):
    """ArkWriter writes JAX's ark bytes, scp values and utt2num_samples;
    every entry reads as JAX reads it, and iter_ark finds JAX's keys."""
    lens = {"u1": 5000, "u2": 16000 * 3 + 17, "u3": 1}
    outs = {}
    for name, writer in (("port", K.ArkWriter), ("jax", JK.ArkWriter)):
        with writer(str(tmp_path / name), fmt=fmt) as w:
            for i, (u, n) in enumerate(lens.items()):
                w.write(u, F.float_to_pcm16(_signal(n, i)), SR)
        outs[name] = tmp_path / name
    port, jax_dir = outs["port"], outs["jax"]
    assert (port / "data_wav.ark").read_bytes() == (jax_dir / "data_wav.ark").read_bytes()
    assert (port / "utt2num_samples").read_text() == (jax_dir / "utt2num_samples").read_text()
    scp = tio.read_scp(str(port / "wav.scp"))
    assert [v.replace(str(port), "") for v in scp.values()] == \
        [v.replace(str(jax_dir), "") for v in jio.read_scp(str(jax_dir / "wav.scp")).values()]
    for u, value in scp.items():
        got = _same_audio(value)
        assert len(got) == lens[u]
        np.testing.assert_array_equal(K.read_ark_audio(value, native=False)[0], got)
    ark = str(port / "data_wav.ark")
    assert list(K.iter_ark(ark)) == list(JK.iter_ark(ark))


# ---------------------------------------------------------------- SPHERE and the rest


@pytest.mark.parametrize("kind", ["pcm16_le", "pcm16_be", "ulaw", "alaw", "pcm24_be",
                                  "pcm32_le", "pcm8", "stereo"])
def test_sph_matches_jax(kind, tmp_path):
    rng = np.random.RandomState(len(kind))
    pcm = (rng.randn(3000) * 6000).astype(np.int16)
    path = str(tmp_path / f"{kind}.sph")
    if kind.startswith("pcm16"):
        bf = "01" if kind.endswith("le") else "10"
        _write_sph(path, pcm.astype(np.dtype(np.int16).newbyteorder("<" if bf == "01"
                                                                       else ">")), bf)
    elif kind in ("ulaw", "alaw"):
        _write_sph(path, rng.randint(0, 256, 3000).astype(np.uint8), "1", kind, 1)
    elif kind == "pcm24_be":
        _write_sph(path, rng.randint(0, 256, 3 * 3000).astype(np.uint8), "10", "pcm", 3)
    elif kind == "pcm32_le":
        _write_sph(path, (rng.randn(3000) * 1e8).astype("<i4"), "0123", "pcm", 4)
    elif kind == "pcm8":
        _write_sph(path, rng.randint(-128, 128, 3000).astype(np.int8), "1", "pcm", 1)
    else:
        _write_sph(path, pcm, channels=2)
    got = _same_audio(path)
    assert len(got) == (1500 if kind == "stereo" else 3000)


def test_sph_shorten_raises_with_jax_message(tmp_path):
    path = str(tmp_path / "s.sph")
    _write_sph(path, np.zeros(16, np.int16), coding="pcm,embedded-shorten-v2.00")
    with pytest.raises(ValueError) as ref:
        jio.read_wav(path)
    with pytest.raises(ValueError) as got:
        tio.read_wav(path)
    assert str(got.value) == str(ref.value) and "sph2pipe" in str(got.value)


@pytest.mark.parametrize("kind", ["npy", "wav", "wav_other_suffix", "wav_stereo"])
def test_npy_and_wav_match_jax(kind, tmp_path):
    x = _signal(7001, 2)
    if kind == "npy":
        path = str(tmp_path / "a.npy")
        np.save(path, x.astype(np.float64))
    elif kind == "wav_stereo":
        import wave

        path = str(tmp_path / "s.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(F.float_to_pcm16(_signal(7001, 2, channels=2)).tobytes())
    else:
        path = str(tmp_path / ("a.wav" if kind == "wav" else "a.audio"))
        tio.write_wav(path, x)
        ref = str(tmp_path / "ref.wav")
        jio.write_wav(ref, x)
        assert open(path, "rb").read() == open(ref, "rb").read()
    _same_audio(path)


# ---------------------------------------------------------------- data dirs


def _write(path, entries):
    tio.write_scp(str(path), entries)


@pytest.fixture(scope="module")
def recipe_dirs(tmp_path_factory):
    """Three data dirs in the recipe's formats:
    `segments`: two FLAC recordings sliced by segments, with a partial
    utt2num_samples, one segment of a missing recording and one utterance
    without text; `train_sp`: a flac.ark dir perturbed the recipe's way
    (ark entries at 1.0, WAV files at 0.9 / 1.1); `sph`: SPHERE entries."""
    from agacs_tpu_torch.data.perturb import perturb_data_dir

    root = tmp_path_factory.mktemp("recipe_dirs")
    seg = root / "segments"
    seg.mkdir()
    for i in range(2):
        F.write_flac(str(seg / f"rec{i}.flac"), _signal(5 * SR, 10 + i))
    _write(seg / "wav.scp", {f"rec{i}": str(seg / f"rec{i}.flac") for i in range(2)})
    segs = {"a-rec0-1": "rec0 0.1 1.35", "a-rec0-2": "rec0 1.5 3.9",
            "b-rec1-1": "rec1 0.0 2.0", "b-rec1-2": "rec1 2.25 4.95",
            "c-gone-1": "gone 0.0 1.0", "d-rec1-9": "rec1 0.5 0.7"}
    _write(seg / "segments", segs)
    texts = {"a-rec0-1": "我们 go to school", "a-rec0-2": "okay 那个 project",
             "b-rec1-1": "today 我 很 busy", "b-rec1-2": "没有 problem lah",
             "c-gone-1": "lost"}
    _write(seg / "text", texts)
    _write(seg / "utt2num_samples", {"a-rec0-2": "38399"})

    ark = root / "ark"
    with K.ArkWriter(str(ark), fmt="flac") as w:
        for i in range(3):
            w.write(f"u{i}", F.float_to_pcm16(_signal(12000 + 3000 * i, 20 + i)), SR)
    _write(ark / "text", {"u0": "hello 你好", "u1": "好 ok", "u2": "that 是 right"})
    perturb_data_dir(str(ark), str(root / "train_sp"))

    sph = root / "sph"
    sph.mkdir()
    for i in range(2):
        pcm = F.float_to_pcm16(_signal(9000 + 500 * i, 30 + i))
        _write_sph(str(sph / f"s{i}.sph"), pcm.astype(">i2"), "10")
    _write(sph / "wav.scp", {f"s{i}": str(sph / f"s{i}.sph") for i in range(2)})
    _write(sph / "text", {"s0": "去 shop", "s1": "走 了 bye"})
    return root


@pytest.mark.parametrize("bounds", [(0, 30 * SR), (0, 0), (9200, 40000), (0, 15000),
                                    (15000, 0)], ids=str)
@pytest.mark.parametrize("which", ["segments", "train_sp", "sph"])
def test_asr_dataset_matches_jax(recipe_dirs, which, bounds):
    d = str(recipe_dirs / which)
    ds = ASRDataset(d, min_samples=bounds[0], max_samples=bounds[1])
    ref = JaxASRDataset(d, min_samples=bounds[0], max_samples=bounds[1])
    assert ds.utt_ids == ref.utt_ids
    assert len(ds) > 0 or bounds[0] >= 9200 or bounds[1] == 15000
    for u in ds.utt_ids:
        assert ds.num_samples(u) == ref.num_samples(u)
        got, want = ds[u], ref[u]
        np.testing.assert_array_equal(got["speech"], want["speech"])
        np.testing.assert_array_equal(got["text"], want["text"])
        np.testing.assert_array_equal(got["cs_labels"], want["cs_labels"])
    if which == "train_sp":  # factor 1.0 kept the ark entries, the others are WAVs
        values = ds.data.wav.values()
        assert sum(":" in v for v in values) == 3 and sum(v.endswith(".wav") for v in values) == 6
    if which == "segments" and bounds == (0, 30 * SR):
        # c-gone-1's recording is missing, d-rec1-9 has no text;
        # utt2num_samples wins over the segment's length
        assert "c-gone-1" not in ds.utt_ids and "d-rec1-9" not in ds.utt_ids
        assert ds.num_samples("a-rec0-2") == 38399 and len(ds["a-rec0-2"]["speech"]) == 38400


@pytest.mark.parametrize("which", ["segments", "train_sp", "sph"])
def test_decode_cli_reads_recipe_dirs(recipe_dirs, which, tmp_path):
    """bin.decode on each dir (whisper `test` dims, CPU, float32): a
    hypothesis for every utterance JAX's dataset yields, and JAX's
    references."""
    from agacs_tpu_torch.bin import decode
    from agacs_tpu_torch.models import whisper as tw
    from agacs_tpu_torch.models.checkpoint import numpy_from_params

    conf = tmp_path / "config.yaml"
    conf.write_text("encoder: whisper\nencoder_conf: {whisper_model: test}\n"
                    "decoder_conf: {whisper_model: test}\n")
    params = str(tmp_path / "p.npz")
    np.savez(params, **numpy_from_params(tw.init_whisper_params(
        torch.Generator().manual_seed(0), tw.make_config("test"))))
    res = decode.main(["--config", str(conf), "--params", params,
                       "--data_dir", str(recipe_dirs / which),
                       "--output_dir", str(tmp_path / "dec"), "--device", "cpu",
                       "--compute_dtype", "float32", "--max_steps", "2"])
    ref = JaxASRDataset(str(recipe_dirs / which))
    assert set(res["hyps"]) == set(ref.utt_ids)
    assert res["refs"] == {u: ref.text[u] for u in ref.utt_ids}

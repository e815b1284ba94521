"""The port's recipe CLIs (run.sh stages 0, 1 and 6, and the data-dir and
vocabulary tools) and its start checkpoint against agacs_tpu's, on the
same numpy-seeded files: `prepare_seame`, `format_data`,
`perturb_data_dir`, `data_dir` and `export_vocabulary` write JAX's files
(for arks: the keys and the decoded audio, not the paths),
`average_checkpoints` JAX's arrays, `pack` JAX's manifest and members; an
OpenAI-layout `.pt` loads into the state dict JAX's `load_torch_whisper`
gives through `params_from_numpy`, tensor for tensor, both trainers'
`load_init_params` load the same leaves from it (with and without a
`src:dst:exclude` spec), and a teacher-forced forward on it agrees with
JAX's within 1e-5 relative."""

import filecmp
import os
import tarfile

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from chip_smoke import SEAME_SPLITS, seame_corpus
from agacs_tpu.bin import average_checkpoints as j_average
from agacs_tpu.bin import data_dir as j_data_dir
from agacs_tpu.bin import export_vocabulary as j_export
from agacs_tpu.bin import format_data as j_format
from agacs_tpu.bin import pack as j_pack
from agacs_tpu.bin import prepare_seame as j_prepare
from agacs_tpu.bin.train import load_init_params as j_load_init_params
from agacs_tpu.data import ASRDataset as JaxASRDataset
from agacs_tpu.data.io import read_scp as j_read_scp
from agacs_tpu.data.io import read_wav as j_read_wav
from agacs_tpu.data.perturb import perturb_data_dir as j_perturb
from agacs_tpu.models import whisper as jw
from agacs_tpu.models.asr_model import ASRModelConfig as JaxASRConfig
from agacs_tpu.models.checkpoint import load_torch_whisper as j_load_torch_whisper
from agacs_tpu.train.checkpoint import save_pytree
from agacs_tpu_torch.bin import average_checkpoints, data_dir, export_vocabulary
from agacs_tpu_torch.bin import format_data, pack, prepare_seame
from agacs_tpu_torch.bin.train import load_init_params
from agacs_tpu_torch.data.dataset import ASRDataset
from agacs_tpu_torch.data.io import read_scp, read_wav
from agacs_tpu_torch.data.perturb import perturb_data_dir
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.asr_model import ASRModelConfig
from agacs_tpu_torch.models.checkpoint import load_torch_whisper, params_from_numpy

torch.set_num_threads(1)

SR = 16000


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Stage 0's prep by both packages' CLIs on one corpus (chip_smoke.py's
    phase 39 corpus: the shape of tests/test_seame_prep.py's fixture)."""
    root = str(tmp_path_factory.mktemp("seame"))
    corpus, repo = seame_corpus(root)
    out = {}
    for name, cli in (("port", prepare_seame), ("jax", j_prepare)):
        out[name] = os.path.join(root, f"data_{name}")
        stats = cli.main(["--data", corpus, "--repo", repo, "--out", out[name],
                          "--num_val", "1"])
        out[name + "_stats"] = stats
    return out


def _same_tree(a, b, skip=()):
    """Every file under a and b has the same bytes (names relative)."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        if f not in skip:
            assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    return files


def test_prepare_seame_writes_jax_files(prepared):
    assert prepared["port_stats"] == prepared["jax_stats"]
    assert prepared["port_stats"]["train"]["n_utts"] == 5
    files = _same_tree(prepared["port"], prepared["jax"])
    assert {"train/segments", "devman/wav.scp", "train/token.man.2"} <= set(files)


def _same_audio_dirs(a, b):
    """Two formatted dirs: same keys, same decoded audio, same other files."""
    wa, wb = read_scp(os.path.join(a, "wav.scp")), j_read_scp(os.path.join(b, "wav.scp"))
    assert list(wa) == list(wb)
    for u in wa:
        x, sr = read_wav(wa[u])
        y, sr_j = j_read_wav(wb[u])
        assert sr == sr_j == SR
        np.testing.assert_array_equal(x, y)
    for name in ("text", "utt2spk", "spk2utt", "utt2num_samples"):
        assert os.path.exists(os.path.join(a, name)) == os.path.exists(os.path.join(b, name))
        if os.path.exists(os.path.join(a, name)):
            assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False)
    return wa


@pytest.mark.parametrize("fmt", ["flac.ark", "wav.ark", "flac", "wav"])
def test_format_data_matches_jax(prepared, fmt, tmp_path):
    for split in SEAME_SPLITS:
        src = os.path.join(prepared["jax"], split)
        a, b = str(tmp_path / "port" / split), str(tmp_path / "jax" / split)
        assert format_data.main(["--data_dir", src, "--outdir", a, "--audio_format", fmt]) \
            == {"n_utts": len(read_scp(os.path.join(src, "segments"))), "outdir": a}
        j_format.main(["--data_dir", src, "--outdir", b, "--audio_format", fmt])
        wav = _same_audio_dirs(a, b)
        assert all((":" in v) == fmt.endswith("ark") for v in wav.values())
        ds, ref = ASRDataset(a), JaxASRDataset(b)
        assert ds.utt_ids == ref.utt_ids
        assert [ds.num_samples(u) for u in ds.utt_ids] == \
            [ref.num_samples(u) for u in ref.utt_ids]


def test_perturb_over_flac_ark_matches_jax(prepared, tmp_path):
    """Stage 1 on stage 0's flac.ark train dir: the factor-1.0 entries keep
    their ark values, the others are JAX's audio."""
    ark = str(tmp_path / "train")
    format_data.main(["--data_dir", os.path.join(prepared["jax"], "train"), "--outdir", ark])
    a, b = str(tmp_path / "sp_port"), str(tmp_path / "sp_jax")
    perturb_data_dir(ark, a)
    j_perturb(ark, b)
    wav = _same_audio_dirs(a, b)
    src = read_scp(os.path.join(ark, "wav.scp"))
    assert {u: v for u, v in wav.items() if u in src} == src
    assert len(wav) == 3 * len(src)


@pytest.mark.parametrize("cmd", [
    ["validate", "{d}"], ["fix", "{d}"], ["split", "{d}", "2"],
    ["subset", "{d}", "{d}_sub", "3", "--mode", "random", "--seed", "4"],
    ["subset", "{d}", "{d}_sub", "2", "--mode", "last"],
    ["utt2spk-to-spk2utt", "{d}/utt2spk", "-o", "{d}/s2u"],
    ["spk2utt-to-utt2spk", "{d}/spk2utt", "-o", "{d}/u2s"],
    ["filter", "{d}/keys", "{d}/text", "-o", "{d}/text.f"],
], ids=lambda c: c[0] + ("-" + c[-1] if c[0] == "subset" else ""))
def test_data_dir_cli_matches_jax(prepared, cmd, tmp_path):
    import shutil

    dirs = {}
    for name in ("port", "jax"):
        d = str(tmp_path / name / "train")
        shutil.copytree(os.path.join(prepared["jax"], "train"), d)
        if cmd[0] in ("validate", "fix"):  # a stray line for fix to drop
            with open(os.path.join(d, "text"), "a", encoding="utf-8") as f:
                f.write("zz-stray-000000-000100 stray line\n")
        with open(os.path.join(d, "keys"), "w") as f:
            f.write("".join(u + "\n" for u in list(read_scp(os.path.join(d, "text")))[::2]))
        dirs[name] = d
    rc = data_dir.main([c.format(d=dirs["port"]) for c in cmd])
    assert rc == j_data_dir.main([c.format(d=dirs["jax"]) for c in cmd])
    if cmd[0] == "validate":
        assert rc == 1  # the stray text line
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_export_vocabulary_matches_jax(tmp_path):
    n = export_vocabulary.main(["--output", str(tmp_path / "port.txt")])
    assert n == j_export.main(["--output", str(tmp_path / "jax.txt")]) == 51865
    assert filecmp.cmp(tmp_path / "port.txt", tmp_path / "jax.txt", shallow=False)


def test_average_checkpoints_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}epoch.params.npz"))
        np.savez(paths[-1], **{"encoder/blocks/attn/query/w": rng.randn(2, 8, 8)
                               .astype(np.float32),
                               "decoder/blocks/mlp/fc1/w_q": rng.randint(-127, 128, (2, 8, 32))
                               .astype(np.int8), "step": np.int64(7 + i)})
    average_checkpoints.main(["--inputs", *paths, "--output", str(tmp_path / "port.npz")])
    j_average.main(["--inputs", *paths, "--output", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, other=np.zeros(2))
    with pytest.raises(ValueError, match="key set differs"):
        average_checkpoints.main(["--inputs", paths[0], bad, "--output", bad])


def test_pack_and_unpack_match_jax(tmp_path):
    exp = tmp_path / "exp"
    (exp / "images").mkdir(parents=True)
    (exp / "config.yaml").write_text("encoder: whisper\n")
    np.savez(exp / "valid.acc.ave.params.npz", x=np.arange(3.0))
    (exp / "train_history.json").write_text("{}")
    (exp / "images" / "acc.png").write_bytes(b"\x89PNG")
    argv = ["pack", "--train_config", str(exp / "config.yaml"), "--model_file",
            str(exp / "valid.acc.ave.params.npz"), "--option",
            str(exp / "train_history.json"), "--option", str(exp / "images")]
    pack.main([*argv, "--outpath", str(tmp_path / "port.tgz")])
    j_pack.main([*argv, "--outpath", str(tmp_path / "jax.tgz")])
    members = {}
    for name in ("port", "jax"):
        with tarfile.open(tmp_path / f"{name}.tgz") as tar:
            members[name] = {m.name: (m.type, tar.extractfile(m).read() if m.isfile() else None)
                             for m in tar.getmembers()}
    metas = {k: yaml.safe_load(v.pop("meta.yaml")[1]) for k, v in members.items()}
    assert members["port"] == members["jax"]
    for meta in metas.values():
        meta.pop("timestamp")
    assert metas["port"] == metas["jax"]
    out = pack.main(["unpack", "--archive", str(tmp_path / "port.tgz"), "--outdir",
                     str(tmp_path / "un")])
    assert out == {k: v.replace("un_jax", "un") for k, v in j_pack.main(
        ["unpack", "--archive", str(tmp_path / "port.tgz"), "--outdir",
         str(tmp_path / "un_jax")]).items()}
    assert open(out["asr_train_config"]).read() == "encoder: whisper\n"


# ---------------------------------------------------------------- the OpenAI .pt


DIMS = dict(n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
            n_vocab=51865, n_text_ctx=64, n_text_state=64, n_text_head=4, n_text_layer=2)
SIDE = dict(n_dim=32, n_head=4, layers=(0, 1))


def _cfgs(**flags):
    side = flags.pop("side", False)
    jcfg = jw.WhisperConfig(**DIMS, **flags,
                            side_network=jw.SideNetworkConfig(**SIDE) if side else None)
    tcfg = tw.WhisperConfig(**DIMS, **flags,
                            side_network=tw.SideNetworkConfig(**SIDE) if side else None)
    return jcfg, tcfg


def reference_layout(sd: dict) -> dict:
    """The port's state dict under the reference's names (its side networks:
    `*_sidenetwork`, per-block `downsample_intermediate_layers.{i}` and
    `sigmoid_gate_intermediate_layers.{i}`, `sigmoid_gate_output`)."""
    out = {}
    for name, t in sd.items():
        part, _, rest = name.partition(".")
        if part.endswith("_side"):
            part = part[: -len("_side")] + "_sidenetwork"
            if rest == "gates":
                out.update({f"{part}.sigmoid_gate_intermediate_layers.{i}": g.reshape(1)
                            for i, g in enumerate(t)})
                continue
            rest = {"gate_output": "sigmoid_gate_output"}.get(rest, rest)
            rest = rest.replace("downsample_layers.", "downsample_intermediate_layers.")
        out[f"{part}.{rest}"] = t
    return out


def write_pt(path, tcfg, seed=3, drop=(), dtype=torch.float32, bare=False, espnet=False):
    """An OpenAI-layout .pt of the port's init at `seed`, in `dtype`,
    without the names holding any of `drop`."""
    sd = tw.init_whisper_params(torch.Generator().manual_seed(seed), tcfg)
    sd = {k: v.to(dtype) for k, v in reference_layout(sd).items()
          if not any(d in k for d in drop)}
    if espnet:
        sd = {k.replace("encoder.", "encoder.encoders.", 1).replace(
            "decoder.", "decoder.decoders.", 1): v for k, v in sd.items()}
    dims = {k: getattr(tcfg, k) for k in DIMS}
    torch.save(sd if bare else {"dims": dims, "model_state_dict": sd}, path)
    return sd


def _jax_sd(tree, tcfg):
    return params_from_numpy(jax.tree.map(np.asarray, tree), tcfg)


@pytest.mark.parametrize("case", ["adapters", "fp16", "dims", "pe_decoder", "side",
                                  "bare_espnet"])
def test_pt_loads_like_jax(case, tmp_path):
    """Every tensor of the port's load_torch_whisper equals JAX's
    load_torch_whisper -> params_from_numpy. The file holds every leaf of
    the config but PE's (a PE stack's query_cs / key_cs then come from its
    query / key in both; its gates keep each package's init). With "dims"
    the config is the file's `dims` (no adapters: the file's are left)."""
    flags = {"adapters": dict(adapter=True), "fp16": dict(adapter=True),
             "dims": dict(adapter=True), "pe_decoder": dict(pe_decoder=True),
             "side": dict(side=True),
             "bare_espnet": dict(adapter=True, adapter_decoder=False)}[case]
    jcfg, tcfg = _cfgs(**flags)
    path = str(tmp_path / "w.pt")
    write_pt(path, tcfg, drop=("_cs.", ".gate") if case == "pe_decoder" else (),
             dtype=torch.float16 if case == "fp16" else torch.float32,
             bare=case == "bare_espnet", espnet=case == "bare_espnet")
    got, cfg = load_torch_whisper(path, None if case == "dims" else tcfg)
    ref, _ = j_load_torch_whisper(path, None if case == "dims" else jcfg)
    if case == "dims":
        assert cfg == tw.WhisperConfig(**DIMS)
    ref = _jax_sd(ref, cfg)
    assert set(got) == set(ref) == set(tw.Whisper(cfg, device="meta").state_dict())
    gates = {k for k in got if k.endswith("attn.gate")}
    assert bool(gates) == (case == "pe_decoder")
    for k in got:
        if k not in gates:
            assert torch.equal(got[k], ref[k]), k
    if case == "pe_decoder":
        for i in range(2):
            b = f"decoder.blocks.{i}.attn."
            assert torch.equal(got[b + "query_cs.weight"], got[b + "query.weight"])
            assert torch.equal(got[b + "key_cs.weight"], got[b + "key.weight"])


def test_pt_missing_leaves_keep_the_seed0_init(tmp_path):
    """An OpenAI .pt has no adapters: they keep the init from torch seed 0,
    everything else is the file's; a trunk weight missing raises."""
    _, tcfg = _cfgs(adapter=True)
    path = str(tmp_path / "w.pt")
    held = write_pt(path, tcfg, drop=("adapter",))
    got, _ = load_torch_whisper(path, tcfg)
    init = tw.init_whisper_params(torch.Generator().manual_seed(0), tcfg)
    for k, t in got.items():
        assert torch.equal(t, held[k] if k in held else init[k]), k
    assert any("adapter" in k for k in got)
    write_pt(path, tcfg, drop=("decoder.blocks.1.mlp.2.weight",))
    with pytest.raises(KeyError, match="trunk weights"):
        load_torch_whisper(path, tcfg)


def _asr(jcfg, tcfg):
    return JaxASRConfig(whisper=jcfg, use_specaug=False), \
        ASRModelConfig(whisper=tcfg, use_specaug=False)


def _loaded_alike(got, names, sd, jax_out, jax_tmpl, tcfg):
    """The port loaded `names` (the rest kept `sd`), JAX loaded the same
    leaves: its result equals the port's on `names` and its template
    elsewhere."""
    ref, tmpl = _jax_sd(jax_out, tcfg), _jax_sd(jax_tmpl, tcfg)
    assert names
    for k in got:
        if k in names:
            assert torch.equal(got[k], ref[k]), k
        else:
            assert torch.equal(got[k], sd[k]) and torch.equal(ref[k], tmpl[k]), k


def test_init_param_pt_loads_the_leaves_jax_loads(tmp_path):
    """An OpenAI .pt without adapters through both trainers'
    load_init_params: the file's leaves load, the adapters keep the init
    (JAX's .pt route fills them from its PRNGKey(0) template)."""
    jcfg, tcfg = _cfgs(adapter=True)
    path = str(tmp_path / "w.pt")
    held = write_pt(path, tcfg, drop=("adapter",))
    sd = tw.init_whisper_params(torch.Generator().manual_seed(7), tcfg)
    jparams = jw.init_whisper_params(jax.random.PRNGKey(7), jcfg)
    jasr, tasr = _asr(jcfg, tcfg)
    got, names = load_init_params(path, sd, tasr)
    assert sorted(names) == sorted(held)
    _loaded_alike(got, names, sd, j_load_init_params(path, jparams, jasr),
                  jw.init_whisper_params(jax.random.PRNGKey(0), jcfg), tcfg)


@pytest.mark.parametrize("spec", [":encoder:encoder:encoder/conv1",
                                  ":::decoder/blocks/adapter_mlp,encoder/ln_post",
                                  ":decoder/blocks:decoder/blocks",
                                  ":encoder/blocks/attn:decoder/blocks/attn"])
@pytest.mark.parametrize("source", ["pt", "npz"])
def test_init_param_spec_loads_the_leaves_jax_loads(source, spec, tmp_path):
    """`path:src:dst:exclude` over a checkpoint holding every leaf (a .pt
    or its npz): the port loads the leaves JAX's load_init_params loads
    from that npz under the same spec. (JAX reads a .pt whole, spec or
    not; the port applies the spec to it as to an npz.)"""
    jcfg, tcfg = _cfgs(adapter=True)
    pt = str(tmp_path / "w.pt")
    write_pt(pt, tcfg)
    npz = str(tmp_path / "w.params.npz")
    save_pytree(npz, j_load_torch_whisper(pt, jcfg)[0])
    sd = tw.init_whisper_params(torch.Generator().manual_seed(7), tcfg)
    jparams = jw.init_whisper_params(jax.random.PRNGKey(7), jcfg)
    jasr, tasr = _asr(jcfg, tcfg)
    got, names = load_init_params((pt if source == "pt" else npz) + spec, sd, tasr)
    _loaded_alike(got, names, sd, j_load_init_params(npz + spec, jparams, jasr), jparams,
                  tcfg)
    if spec.startswith(":encoder:encoder"):
        assert all(n.startswith("encoder.") and not n.startswith("encoder.conv1.")
                   for n in names)


@pytest.mark.parametrize("rows", [51864, 51866, 51872])
def test_init_param_bf16_leaves_and_token_emb_rows_like_jax(rows, tmp_path):
    """Raw-bf16 (V2) leaves are read as bf16; a token_emb of another row
    count is cut or zero-padded, as JAX's load_init_params does."""
    import ml_dtypes

    jcfg, tcfg = _cfgs()
    src = jax.tree.map(np.asarray, jw.init_whisper_params(jax.random.PRNGKey(1), jcfg))
    emb = src["decoder"]["token_emb"]
    emb = emb[:rows] if rows < len(emb) else np.concatenate(
        [emb, np.random.RandomState(0).randn(rows - len(emb), emb.shape[1])
         .astype(np.float32)])
    flat = {"decoder/token_emb": emb,
            "encoder/blocks/attn/query/w": src["encoder"]["blocks"]["attn"]["query"]["w"]
            .astype(ml_dtypes.bfloat16).view("V2"),
            "decoder/ln/w": src["decoder"]["ln"]["w"] + 0.5}
    path = str(tmp_path / "p.npz")
    np.savez(path, **flat)
    sd = tw.init_whisper_params(torch.Generator().manual_seed(7), tcfg)
    jparams = jw.init_whisper_params(jax.random.PRNGKey(7), jcfg)
    jasr, tasr = _asr(jcfg, tcfg)
    got, names = load_init_params(path, sd, tasr)
    assert len(names) == 4  # token_emb, ln weight, both layers' query weight
    _loaded_alike(got, names, sd, j_load_init_params(path, jparams, jasr), jparams, tcfg)
    if rows < 51865:
        assert torch.equal(got["decoder.token_embedding.weight"][rows:], torch.zeros(1, 64))


def test_pt_teacher_forced_forward_matches_jax(tmp_path):
    """The loaded .pt's encoder output and teacher-forced decoder logits,
    port against JAX, within 1e-5 relative (L2)."""
    jcfg, tcfg = _cfgs(adapter=True)
    path = str(tmp_path / "w.pt")
    write_pt(path, tcfg)
    model = tw.Whisper.from_state_dict(tcfg, load_torch_whisper(path, tcfg)[0])
    params, _ = j_load_torch_whisper(path, jcfg)
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 64, 80).astype(np.float32)
    tokens = np.concatenate([np.full((2, 1), 50258), rng.randint(0, 51865, (2, 7))], 1)
    enc_j = jw.whisper_encode(params, jcfg, jnp.asarray(mel))
    ref, _ = jw.whisper_decode(params, jcfg, jnp.asarray(tokens, jnp.int32), enc_j)
    with torch.no_grad():
        enc = tw.whisper_encode(model, torch.from_numpy(mel))
        out, _ = tw.whisper_decode(model, torch.from_numpy(tokens), enc)
    for a, b in ((enc.numpy(), np.asarray(enc_j)), (out.numpy(), np.asarray(ref))):
        assert a.shape == b.shape
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-5


def test_train_cli_init_param_pt(tmp_path, caplog):
    """bin.train --init_param w.pt (whisper `test` dims, CPU, float32) on a
    stage-0 flac.ark dir: every leaf of the file loads, and an epoch runs."""
    from agacs_tpu_torch.bin import train

    root = str(tmp_path)
    corpus, repo = seame_corpus(root)
    prepare_seame.main(["--data", corpus, "--repo", repo, "--out", f"{root}/prep",
                        "--num_val", "1"])
    for split in ("train", "valid"):
        format_data.main(["--data_dir", f"{root}/prep/{split}", "--outdir", f"{root}/{split}"])
    tcfg = tw.make_config("test", adapter=True)
    held = write_pt(f"{root}/w.pt", tcfg, drop=("adapter",))
    with caplog.at_level("INFO"):
        out = train.main([
            "--config", os.path.join(os.path.dirname(__file__), "..", "recipes", "seame",
                                     "conf", "train_asr_whisper_small_adapter_encoder.yaml"),
            "--train_dir", f"{root}/train", "--valid_dir", f"{root}/valid",
            "--exp_dir", f"{root}/exp", "--init_param", f"{root}/w.pt", "--max_epoch", "1",
            "--batch_bins", "200000", "--compute_dtype", "float32", "--device", "cpu",
            "--override", "encoder_conf.whisper_model=test", "decoder_conf.whisper_model=test",
            "accum_grad=1", "keep_nbest_models=1"])
    n_all = len(tw.Whisper(tcfg, device="meta").state_dict())
    assert f"init_param: loaded {len(held)}/{n_all} parameters from {root}/w.pt" \
        in caplog.messages
    assert np.isfinite(out["history"][1]["train"]["loss"])
    with np.load(out["ave"]) as ave:  # the frozen trunk is the file's
        np.testing.assert_array_equal(ave["decoder/blocks/mlp/fc1/w"][1],
                                      held["decoder.blocks.1.mlp.0.weight"].numpy().T)

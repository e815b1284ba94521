"""The port's ladder side network (reference `model.py:349-484`, JAX
`SideNetworkConfig`) and K3 at its head width, d_head 48, against
agacs_tpu on the CPU: the encoder output, the teacher-forced logits, the
cached decode step, greedy and beam decoding, a `sidenetwork` training
trajectory, the npz both ways and the train -> decode CLIs. Two ladders:
JAX's test shape `SideNetworkConfig(32, 4, (0, 1))` (d_head 8) and n_dim
96 with 2 heads, the default ladder's d_head 48. Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: float32 throughout, so the two packages differ only by
summation order: 1e-5 x max |ref| for the encoder output and the logits
(read ~1e-7 relative), 1e-5 relative for the trajectory's losses and
gradient norm and 1e-5 for K3's plain version against the interpreted
kernel (its keys past pos poisoned); tokens exact, beam scores 1e-5
relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.decode.beam import beam_decode as jax_beam
from agacs_tpu.decode.greedy import greedy_decode as jax_greedy
from agacs_tpu.models import asr_model as jasr
from agacs_tpu.models import whisper as jw
from agacs_tpu.ops.decode_attn import decode_cache_attention as jax_dca
from agacs_tpu.train.checkpoint import load_pytree_like, save_pytree
from agacs_tpu.train.optim import OptimConfig as JOptimConfig
from agacs_tpu.train.trainer import build_tx, create_train_state
from agacs_tpu.train.trainer import make_train_step as jax_make_train_step
from agacs_tpu_torch.decode.beam import beam_decode
from agacs_tpu_torch.decode.greedy import greedy_decode
from agacs_tpu_torch.models import asr_model
from agacs_tpu_torch.models import whisper as tw
from agacs_tpu_torch.models.checkpoint import numpy_from_params, params_from_numpy
from agacs_tpu_torch.ops import decode_attn
from agacs_tpu_torch.train.freeze import apply_freeze, trainable_names
from agacs_tpu_torch.train.optim import OptimConfig, build_optimizer
from agacs_tpu_torch.train.trainer import make_train_step

from test_torch_train import RECIPE, _batch, _torch_batch, _write_data_dir

torch.set_num_threads(1)

DIMS = dict(n_mels=80, n_audio_ctx=20, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=16, n_text_state=64,
            n_text_head=4, n_text_layer=3)
LADDERS = {"jax_test": (32, 4, (0, 1)), "d_head48": (96, 2, (1,))}


def _close(out, ref, rtol, what):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    err = np.abs(out - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"{what}: {err} vs {rtol} x {np.abs(ref).max()}"


def _cfgs(ladder: str, **kw):
    n_dim, n_head, layers = LADDERS[ladder]
    jcfg = jw.WhisperConfig(**DIMS, side_network=jw.SideNetworkConfig(n_dim, n_head, layers),
                            **kw)
    tcfg = tw.WhisperConfig(**DIMS, side_network=tw.SideNetworkConfig(n_dim, n_head, layers),
                            **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(LADDERS))
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jw.init_whisper_params(jax.random.PRNGKey(0), jcfg)
    model = tw.Whisper.from_state_dict(
        tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    return params, jcfg, model


def test_encoder_and_teacher_forced_logits_match_jax(pair):
    params, jcfg, model = pair
    rng = np.random.RandomState(1)
    mel = rng.randn(2, 40, 80).astype(np.float32)
    ref = jw.whisper_encode(params, jcfg, jnp.asarray(mel))
    with torch.no_grad():
        out = tw.whisper_encode(model, torch.from_numpy(mel))
    _close(out, ref, 1e-5, "side encoder output")
    trunk_only = tw.Whisper.from_state_dict(
        tw.WhisperConfig(**DIMS), {k: v for k, v in model.state_dict().items()
                                   if "_side" not in k})
    with torch.no_grad():
        assert np.abs(tw.whisper_encode(trunk_only, torch.from_numpy(mel)).numpy()
                      - np.asarray(ref)).max() > 1e-3  # the ladder changes the output
    tokens = np.concatenate([np.full((2, 1), 50258), rng.randint(0, 51865, (2, 7))], 1)
    lref, aux_ref = jw.whisper_decode(params, jcfg, jnp.asarray(tokens), ref,
                                      collect_lang_cols=True)
    with torch.no_grad():
        logits, aux = tw.whisper_decode(model, torch.from_numpy(tokens), out,
                                        collect_lang_cols=True)
    _close(logits, lref, 1e-5, "side teacher-forced logits")
    np.testing.assert_allclose(aux["qk_cols"].numpy(), np.asarray(aux_ref["qk_cols"]),
                               atol=1e-5)


def test_decode_step_logits_match_jax(pair):
    """Every step's logits (pos 0-5), the ladder's caches written in place."""
    params, jcfg, model = pair
    rng = np.random.RandomState(2)
    enc = rng.randn(2, 20, 64).astype(np.float32)
    tokens = rng.randint(0, 51865, (2, 6))
    ckv_j = jw.precompute_cross_kv(params, jcfg, jnp.asarray(enc))
    kv_j = jw.init_self_kv_cache(jcfg, 2, 16)
    with torch.no_grad():
        ckv = tw.precompute_cross_kv(model, torch.from_numpy(enc))
        kv = tw.init_self_kv_cache(model.cfg, 2, 16)
        sc = model.cfg.side_network
        assert len(kv["side_k"]) == len(sc.layers) and kv["side_k"][0].shape[-1] == sc.n_dim
        for pos in range(6):
            lj, kv_j = jw.whisper_decode_step(params, jcfg, jnp.asarray(tokens[:, pos]),
                                              jnp.int32(pos), kv_j, ckv_j)
            lt, kv = tw.whisper_decode_step(model, torch.from_numpy(tokens[:, pos]), pos, kv,
                                            ckv)
            _close(lt, lj, 1e-5, f"side step {pos}")
    _close(kv["side_v"][-1][:, :6], kv_j["side_v"][-1][:, :6], 1e-5, "side cache")


def test_greedy_and_beam_match_jax(pair):
    params, jcfg, model = pair
    enc = np.random.RandomState(3).randn(2, 20, 64).astype(np.float32)
    ref_tok, ref_len = jax_greedy(params, jcfg, jnp.asarray(enc), max_steps=8)
    tok, lens = greedy_decode(model, torch.from_numpy(enc), max_steps=8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref_len))
    ref = jax_beam(params, jcfg, jnp.asarray(enc), beam_size=3, max_steps=6,
                   length_bonus=0.1)
    tok, lens, scores = beam_decode(model, torch.from_numpy(enc), beam_size=3, max_steps=6,
                                    length_bonus=0.1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[2]), rtol=1e-5)


def test_side_beam_reads_plain_rows(monkeypatch):
    """With a side network the beam keeps the physical gather: no ancestry
    map, beam groups 1 (the trunk's cross-attention over per-row cross-KV),
    and the side caches reordered with the trunk's."""
    _, tcfg = _cfgs("d_head48")
    model = tw.Whisper.from_state_dict(
        tcfg, tw.init_whisper_params(torch.Generator().manual_seed(0), tcfg))
    seen = []
    real = tw.whisper_decode_step

    def spy(m, cur, pos, kv, cross_kv, beam_groups=1):
        seen.append((beam_groups, "anc" in kv, cross_kv["k_packed"][0].shape[0],
                     kv["side_k"][0].shape[0]))
        return real(m, cur, pos, kv, cross_kv, beam_groups)

    from agacs_tpu_torch.decode import beam as tbeam

    monkeypatch.setattr(tbeam, "whisper_decode_step", spy)
    beam_decode(model, torch.randn(2, 20, 64), beam_size=3, max_steps=3)
    assert seen and set(seen) == {(1, False, 6, 6)}


@pytest.mark.parametrize("pos", [0, 9, 37, 63])
def test_decode_attention_d48_plain_matches_jax(pos):
    """K3's plain version at d_head 48 (4 heads, d 192) against the Pallas
    kernel interpreted; keys and values past pos poisoned on both kernel
    sides."""
    n, tp, d, h = 6, 64, 192, 4
    rng = np.random.RandomState(pos)
    q = (rng.randn(n, d) * 0.3 * 48 ** -0.5).astype(np.float32)
    k = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    v = (rng.randn(n, tp, d) * 0.3).astype(np.float32)
    k[:, pos + 1:] = 1e9
    v[:, pos + 1:] = 1e9
    out = decode_attn.decode_cache_attention(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), pos, h)
    ref = jax_dca(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, h, interpret=True)
    assert out.shape == (n, d) and bool(torch.isfinite(out).all())
    _close(out, ref, 1e-5, f"K3 d_head 48 pos {pos}")


def test_d48_kernel_refuses_other_forms():
    """The d_head-48 instance takes K3's plain bf16 rows only: an ancestry
    map or PE at d_head 48 go to the other forms' runtime-width entry, and
    float32 caches to the plain rows' (`envelope`), never to it."""
    kv = torch.empty(6, 32, 192, device="meta", dtype=torch.bfloat16)
    assert decode_attn.plan("rows", 6, 4, kv)[0] == "d48"
    for form in ("anc", "pe", "anc_pe"):
        assert decode_attn.plan(form, 6, 4, kv, 3 if "anc" in form else 1)[0] == "forms"
    assert decode_attn.plan("rows", 6, 4, kv.float())[0] == "rows"


@pytest.mark.parametrize("preset", ["sidenetwork", "decoder_sidenetwork"])
def test_presets_select_the_jax_side_leaves(pair, preset):
    from agacs_tpu.train.freeze import trainable_mask

    params, _, model = pair
    mask = trainable_mask(params, preset)
    want = {"/".join(str(k.key) for k in path)
            for path, m in jax.tree_util.tree_flatten_with_path(mask)[0] if m}
    got = {tw_name for tw_name in trainable_names(model, preset)}
    from agacs_tpu_torch.models.checkpoint import jax_leaf

    assert {jax_leaf(n)[0] for n in got} == want and want
    assert all("side" in k for k in want)


def test_sidenetwork_trajectory_matches_jax():
    """3 optimizer steps of accum 2 with the `sidenetwork` preset (CS loss
    over the frozen trunk's columns, clip 1.0, WarmupLR 4) against JAX's
    make_train_step: loss, loss_att, loss_cs, acc and grad norm within
    1e-5 relative, the trunk unchanged, the ladders' parameters as JAX's."""
    from agacs_tpu.text import WhisperTokenizer

    tok = WhisperTokenizer()
    sjcfg, stcfg = _cfgs("d_head48")
    jcfg = jasr.ASRModelConfig(whisper=sjcfg, use_specaug=False, cs_weight=0.5)
    tcfg = asr_model.ASRModelConfig(whisper=stcfg, use_specaug=False, cs_weight=0.5)
    params = jasr.init_asr_params(jax.random.PRNGKey(7), jcfg)
    tx, mask = build_tx(params, JOptimConfig(warmup_steps=4), freeze_preset="sidenetwork")
    jstep = jax_make_train_step(jcfg, tx, accum_grad=2, trainable_mask=mask, donate=False)
    state = create_train_state(params, tx, jax.random.PRNGKey(1))
    model = tw.Whisper.from_state_dict(
        stcfg, params_from_numpy(jax.tree.map(np.asarray, params), stcfg),
        param_dtype=torch.float32)
    trainable = apply_freeze(model, "sidenetwork")
    opt, sched = build_optimizer(trainable, OptimConfig(warmup_steps=4))
    step = make_train_step(model, tcfg, opt, sched, grad_clip=1.0)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if not p.requires_grad}
    assert frozen and all("_side" in n for n, p in model.named_parameters()
                          if p.requires_grad)
    for i in range(3):
        micro = [_batch(tok, seed=2 * i + a) for a in range(2)]
        stacked = {k: jnp.stack([jnp.asarray(m[k]) for m in micro]) for k in micro[0]}
        state, ref = jstep(state, stacked)
        stats = step([_torch_batch(m) for m in micro])
        for k in ("loss", "loss_att", "loss_cs", "acc", "grad_norm"):
            np.testing.assert_allclose(float(stats[k]), float(ref[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    out = numpy_from_params(model.state_dict())
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(k.key) for k in path)
        if "side" in key:
            np.testing.assert_allclose(out[key], np.asarray(leaf), atol=2e-6, err_msg=key)


def test_side_npz_both_ways(pair, tmp_path):
    """JAX's save_pytree npz -> the port's state dict, and the port's npz
    -> the tree JAX's `load_pytree_like` reads, leaf for leaf."""
    params, jcfg, model = pair
    save_pytree(str(tmp_path / "jax.params.npz"), params)
    back = params_from_numpy(np.load(str(tmp_path / "jax.params.npz")), model.cfg)
    sd = model.state_dict()
    assert set(back) == set(sd) and any(k.startswith("decoder_side.") for k in sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    path = str(tmp_path / "port.params.npz")
    np.savez(path, **numpy_from_params(sd))
    loaded = load_pytree_like(path, params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_side_train_cli_then_decode_cli_matches_jax_cli(tmp_path):
    """bin.train on the stage-2 recipe turned into the side-network one
    (`adapter: false`, `side_network: true` with a conf in both parts,
    `freeze_param: sidenetwork`; whisper `test` dims, CPU, float32), then
    the port's and JAX's decode CLIs on its n-best average: token-exact
    hypotheses."""
    from agacs_tpu.bin import decode as jax_cli
    from agacs_tpu.eval.scoring import read_trn
    from agacs_tpu_torch.bin import decode, train

    _write_data_dir(tmp_path / "train", {f"t{i}": (8000 + 1000 * i, "我们 go")
                                         for i in range(4)}, seed=0)
    _write_data_dir(tmp_path / "valid", {"v0": (9000, "hello 你好"), "v1": (7000, "ok")},
                    seed=1)
    exp = tmp_path / "exp"
    side = "{n_dim: 96, n_head: 2, layers: [0, 1]}"
    out = train.main([
        "--config", RECIPE, "--train_dir", str(tmp_path / "train"),
        "--valid_dir", str(tmp_path / "valid"), "--exp_dir", str(exp),
        "--max_epoch", "1", "--batch_bins", "40000", "--compute_dtype", "float32",
        "--device", "cpu", "--override", "encoder_conf.whisper_model=test",
        "decoder_conf.whisper_model=test", "encoder_conf.adapter=false",
        "decoder_conf.adapter=false", "encoder_conf.side_network=true",
        "decoder_conf.side_network=true", f"encoder_conf.side_network_conf={side}",
        f"decoder_conf.side_network_conf={side}", "freeze_param=sidenetwork",
        "keep_nbest_models=1"])
    assert all(np.isfinite(ep["train"]["loss"]) for ep in out["history"].values())
    with np.load(out["ave"]) as ave:
        assert ave["decoder_side/blocks/attn/query/w"].shape == (2, 96, 96)
        assert not any("adapter" in k for k in ave.files)
    common = ["--config", str(exp / "config.yaml"), "--params", out["ave"],
              "--data_dir", str(tmp_path / "valid"), "--compute_dtype", "float32",
              "--max_steps", "6"]
    res = decode.main(common + ["--output_dir", str(tmp_path / "torch"), "--device", "cpu"])
    jax_cli.main(common + ["--output_dir", str(tmp_path / "jax")])
    assert set(res["hyps"]) == {"v0", "v1"}
    assert (read_trn(str(tmp_path / "torch" / "hyp.trn"))
            == read_trn(str(tmp_path / "jax" / "hyp.trn")))


@pytest.mark.cuda
def test_d48_kernel_matches_plain_on_card():
    """K3 at d_head 48 against its plain version on the card, with
    chip_smoke.py's shapes and bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.check_k3_d48(torch.device("cuda"), torch.Generator().manual_seed(0),
                            timed=False)

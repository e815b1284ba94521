"""The port's transducer family (agacs_tpu_torch) against agacs_tpu on the
CPU: the RNN-T loss and its gradients, the prediction network (teacher
forced and step by step, LSTM and GRU) and the joint, the three routes of
the joint's blank / emit planes (streaming through K4's plain version
against JAX's Pallas kernel interpreted, chunked and dense), K4's K
padding, `forward` on the recipe's parsed config scaled down, the
parameters both ways, the greedy eval pass, and the freeze presets of the
conformer and transducer families against JAX's trainable masks. Inputs
are made with numpy from a seed; JAX-initialised weights go to both.

Tolerances, each with its reason:
  * float32 losses 1e-5 relative and the loss's, the networks' and the
    planes' gradients 1e-5 x max |grad| of the leaf (float32 rounding, sums
    in another order; the RNN-T recursion's cumulative sums are the same
    formula on both sides);
  * the whole model's gradients in `forward` 1e-4 x max |grad| of the leaf,
    as the conformer's (a loss of ~500 in float32 spread through twelve
    layers of the backward: the conv stem's reach 3e-5 of their largest);
  * the streaming route 2e-3 x max |plane| (its joint activations are
    bf16 on both sides, as on the card: a bf16 rounding that falls the
    other way in one product moves a log-prob by ~1e-3 of its size) and
    its gradients 2e-2 x max |grad| (the bf16 dz of the kernel's backward);
  * K4's K padding 1e-6 relative (the same float32 products, the zero
    columns summed in another blocking);
  * encoder-parameter gradients whose exact value is zero (the key biases:
    a softmax ignores a per-row shift) 5e-6 x the model's largest gradient.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agacs_tpu.models import transducer as jtr
from agacs_tpu.models import transducer_asr as jta
from agacs_tpu.train import freeze as jfreeze
from agacs_tpu.train import rnnt_loss as jrl
from agacs_tpu.utils.config import task_from_dict as jax_task_from_dict
from agacs_tpu_torch.models import transducer as ttr
from agacs_tpu_torch.models import transducer_asr as tta
from agacs_tpu_torch.models.checkpoint import (
    conformer_params_from_numpy,
    numpy_from_transducer_params,
    transducer_params_from_numpy,
)
from agacs_tpu_torch.ops import vocab_lse
from agacs_tpu_torch.train import rnnt_loss as trl
from agacs_tpu_torch.train.freeze import apply_freeze, trainable_names
from agacs_tpu_torch.utils.config import apply_overrides, load_yaml, task_from_dict

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "seame", "conf", "train_asr_transducer.yaml")
# conformer 2 x 64 (2 heads of 32: off K5's envelope, its plain version
# runs), LSTM / GRU 2 x 32, joint 48
SMALL = ["encoder_conf.output_size=64", "encoder_conf.attention_heads=2",
         "encoder_conf.linear_units=128", "encoder_conf.num_blocks=2",
         "decoder_conf.hidden_size=32", "decoder_conf.num_layers=2",
         "decoder_conf.dropout=0.0", "decoder_conf.dropout_embed=0.0",
         "joint_net_conf.joint_space_size=48"]
LENS = np.array([48000, 40000])  # 93 and 77 encoder frames
ZERO_GRAD = ("attn/k/b",)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _raw(*overrides):
    return apply_overrides(load_yaml(RECIPE), SMALL + list(overrides))


def _cfgs(*overrides, dtype="float32"):
    """(JAX cfg, port cfg) of the recipe scaled down, SpecAug and the
    encoder's dropout off."""
    raw = _raw(*overrides)
    out = []
    for task, dt in ((jax_task_from_dict, jnp), (task_from_dict, torch)):
        c = task(raw, compute_dtype=getattr(dt, dtype)).cfg
        out.append(dataclasses.replace(c, use_specaug=False, encoder=dataclasses.replace(
            c.encoder, dropout_rate=0.0)))
    return tuple(out)


def _tree(jcfg, seed=0):
    tree = jax.tree.map(lambda a: np.array(a), jta.init_transducer_asr_params(
        jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed + 1)
    tree["mvn"] = {"mean": rng.randn(80).astype(np.float32),
                   "std": (0.5 + rng.rand(80)).astype(np.float32)}
    # a blank bias that makes blanks and symbols both likely
    tree["transducer"]["joint"]["lin_out"]["b"][0] = 0.5
    return tree


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    speech = (rng.randn(2, int(LENS.max())) * 0.1).astype(np.float32)
    speech[1, LENS[1]:] = 0.0
    text = np.full((2, 8), -1, np.int64)
    text[0, :6] = rng.randint(1, vocab, 6)
    text[0, 3] = text[0, 2]
    text[1, :3] = rng.randint(1, vocab, 3)
    return {"speech": speech, "speech_lengths": LENS.copy(), "text": text}


def _jb(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _model(tree, tcfg):
    model = tta.TransducerASR.from_state_dict(tcfg, transducer_params_from_numpy(tree, tcfg),
                                              param_dtype=torch.float32)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


# ---------------------------------------------------------------- the loss


def _planes(seed, b=3, t=9, u=4, v=7):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, u + 1, v).astype(np.float32) * 2
    targets = rng.randint(1, v, (b, u)).astype(np.int32)
    return logits, targets


@pytest.mark.parametrize("case", ["logits", "planes", "t_len0", "fastemit"])
def test_rnnt_loss_and_grads_match_jax(case):
    """`rnnt_loss` from logits and `rnnt_loss_from_blank_emit` from
    planes, with ragged lengths, a zero-length encoder and FastEmit 0.5:
    value and gradients within 1e-5."""
    logits, targets = _planes(3)
    t_lens = np.array([9, 0 if case == "t_len0" else 6, 4])
    u_lens = np.array([4, 2, 0])
    lam = 0.5 if case == "fastemit" else 0.0
    if case == "planes":
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
        blank, emit = lp[..., 0], np.take_along_axis(lp[:, :, :4], targets[:, None, :, None],
                                                     3)[..., 0]

        def jfn(bl, em):
            return jrl.rnnt_loss_from_blank_emit(bl, em, jnp.asarray(t_lens),
                                                 jnp.asarray(u_lens), fastemit_lambda=lam)
        want, jgrads = jax.value_and_grad(jfn, (0, 1))(jnp.asarray(blank), jnp.asarray(emit))
        ins = [torch.tensor(blank, requires_grad=True), torch.tensor(emit, requires_grad=True)]
        got = trl.rnnt_loss_from_blank_emit(*ins, torch.tensor(t_lens), torch.tensor(u_lens),
                                            lam)
    else:
        def jfn(lg):
            return jrl.rnnt_loss(lg, jnp.asarray(targets), jnp.asarray(t_lens),
                                 jnp.asarray(u_lens), fastemit_lambda=lam)
        want, jg = jax.value_and_grad(jfn)(jnp.asarray(logits))
        jgrads = (jg,)
        ins = [torch.tensor(logits, requires_grad=True)]
        got = trl.rnnt_loss(ins[0], torch.tensor(targets).long(), torch.tensor(t_lens),
                            torch.tensor(u_lens), fastemit_lambda=lam)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for x, g in zip(ins, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-5 * np.abs(g).max())
    if case == "t_len0":  # no path, no gradient into the empty utterance
        assert float(ins[0].grad[1].abs().max()) == 0.0
    if case == "fastemit":  # the value is FastEmit's identity
        ref0 = trl.rnnt_loss(torch.tensor(logits), torch.tensor(targets).long(),
                             torch.tensor(t_lens), torch.tensor(u_lens))
        assert float(ref0) == pytest.approx(float(got), rel=1e-6)


def test_rnnt_reductions_match_jax():
    logits, targets = _planes(4)
    args = (np.array([9, 7, 3]), np.array([4, 1, 2]))
    for red in ("sum", "none"):
        want = jrl.rnnt_loss(jnp.asarray(logits), jnp.asarray(targets),
                             *map(jnp.asarray, args), reduction=red)
        got = trl.rnnt_loss(torch.tensor(logits), torch.tensor(targets).long(),
                            *map(torch.tensor, args), reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# ---------------------------------------------- prediction and joint networks


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_decoder_and_joint_match_jax(rnn):
    """Teacher-forced decoder, 5 decoder steps from the zero state and the
    joint (its lattice too) within 1e-5; the blank row gets no gradient."""
    jcfg = jtr.TransducerConfig(vocab_size=40, rnn_type=rnn, num_layers=2, hidden_size=32,
                                joint_space_size=48)
    tcfg = ttr.TransducerConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jtr.init_transducer_params(jax.random.PRNGKey(1), jcfg,
                                                                 encoder_size=24))
    model = _port_transducer(jcfg, params, 24)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, 40, (3, 6))
    tokens[:, 0] = 0
    tokens[1, 3] = 0
    want = jtr.transducer_decoder(params, jcfg, jnp.asarray(tokens, jnp.int32))
    got = ttr.transducer_decoder(model, torch.tensor(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    jstate = jtr.init_decoder_state(jcfg, 3)
    tstate = ttr.init_decoder_state(tcfg, 3)
    for u in range(5):
        jo, jstate = jtr.transducer_decoder_step(params, jcfg, jnp.asarray(tokens[:, u]),
                                                 jstate)
        to, tstate = ttr.transducer_decoder_step(model, torch.tensor(tokens[:, u]), tstate)
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(to.detach().numpy(), got[:, u].detach().numpy(), atol=1e-5)
    enc = rng.randn(3, 7, 24).astype(np.float32)
    jl = jtr.joint_lattice(params, jcfg, jnp.asarray(enc), want)
    tl = ttr.joint_lattice(model, torch.tensor(enc), got)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)
    tl.sum().backward()
    assert float(model.embed.grad[0].abs().max()) == 0.0
    assert float(model.embed.grad[tokens[0, 1]].abs().max()) > 0.0


# ------------------------------------------------------ the joint's planes


def _planes_inputs(v, j, seed=0, b=2, t=9, u=5, d=64):
    rng = np.random.RandomState(seed)
    jcfg = jtr.TransducerConfig(vocab_size=v, hidden_size=32, joint_space_size=j)
    params = jax.tree.map(np.asarray, jtr.init_transducer_params(
        jax.random.PRNGKey(seed), jcfg, encoder_size=d))
    enc = rng.randn(b, t, d).astype(np.float32)
    dec = rng.randn(b, u + 1, 32).astype(np.float32)
    targets = rng.randint(1, v, (b, u)).astype(np.int32)
    return jcfg, params, enc, dec, targets


def _port_transducer(jcfg, params, d):
    tcfg = ttr.TransducerConfig(**dataclasses.asdict(jcfg))
    acfg = tta.TransducerASRConfig(decoder=tcfg, encoder=dataclasses.replace(
        tta.TransducerASRConfig().encoder, output_size=d))
    sd = transducer_params_from_numpy({"transducer": params}, acfg, strict=False)
    model = ttr.Transducer(tcfg, d)
    model.load_state_dict({k[len("transducer."):]: v for k, v in sd.items()})
    return model


@pytest.mark.parametrize("route", ["streaming", "chunked"])
def test_blank_emit_planes_match_jax(route, monkeypatch):
    """The streaming route at V 1100 (not a multiple of 8) and joint K 48
    (not a multiple of 128) against JAX's `_blank_emit_streaming` with its
    Pallas kernel interpreted, values and gradients in enc, dec and the
    joint; the chunked route (chunks of 4 over 9 frames) at V 300 against
    JAX's `_blank_emit_chunked`, float32."""
    v = 1100 if route == "streaming" else 300
    jcfg, params, enc, dec, targets = _planes_inputs(v, 48)
    model = _port_transducer(jcfg, params, enc.shape[-1])
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.RandomState(5)
    cot_b, cot_e = rng.randn(2, 9, 6).astype(np.float32), rng.randn(2, 9, 5).astype(np.float32)
    if route == "streaming":
        monkeypatch.setenv("AGACS_VOCAB_LSE", "interpret")

        def jfn(p, e, d):
            return jta._blank_emit_streaming(p, jcfg, e, d, jnp.asarray(targets), 0)
    else:
        def jfn(p, e, d):
            return jta._blank_emit_chunked(p, jcfg, e, d, jnp.asarray(targets), 0, 4)

    def jloss(p, e, d):
        bl, em = jfn(p, e, d)
        return jnp.sum(bl * cot_b) + jnp.sum(em * cot_e), (bl, em)

    (_, (jbl, jem)), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(enc), jnp.asarray(dec))
    te = torch.tensor(enc, requires_grad=True)
    td = torch.tensor(dec, requires_grad=True)
    tt = torch.tensor(targets).long()
    if route == "streaming":
        bl, em = tta._blank_emit_streaming(model, te, td, tt, 0)
        rtol, gtol = 2e-3, 2e-2
    else:
        bl, em = tta._blank_emit_chunked(model, te, td, tt, 0, 4)
        rtol, gtol = 1e-5, 1e-5
    assert vocab_lse.FWD_LAUNCHES == vocab_lse.DX_LAUNCHES == vocab_lse.DW_LAUNCHES == 0
    for got, want in ((bl, jbl), (em, jem)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=rtol * np.abs(want).max())
    ((bl * torch.tensor(cot_b)).sum() + (em * torch.tensor(cot_e)).sum()).backward()
    jgp, jge, jgd = jg
    pairs = [(te.grad, jge), (td.grad, jgd),
             (model.joint.lin_out.weight.grad.t(), jgp["joint"]["lin_out"]["w"]),
             (model.joint.lin_out.bias.grad, jgp["joint"]["lin_out"]["b"]),
             (model.joint.lin_enc.weight.grad.t(), jgp["joint"]["lin_enc"]["w"]),
             (model.joint.lin_dec.weight.grad.t(), jgp["joint"]["lin_dec"]["w"])]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=gtol * np.abs(want).max())


@pytest.mark.parametrize("k", [48, 320, 384, 1000])
def test_k4_k_padding_is_exact_on_plain_versions(k):
    """The wrapper's padded copies (zero columns of x, zero rows of w up to
    a multiple of 128, w's rows also to a multiple of 8 columns): lse, dx
    and dW of the padded operands, the padding dropped, equal the
    unpadded ones."""
    g = torch.Generator().manual_seed(k)
    n, v = 50, 1001
    x = torch.randn(n, k, generator=g).bfloat16()
    w = (torch.randn(k, v, generator=g) / k ** 0.5).bfloat16()
    b = torch.randn(v, generator=g)
    gr = torch.randn(n, generator=g)
    xp, wp = vocab_lse._pad_x(x), vocab_lse._rows8(w)
    kp = vocab_lse.padded_k(k)
    assert kp % vocab_lse.KP == 0 and kp - k < vocab_lse.KP
    assert xp.shape == (n, kp) and wp.shape == (kp, -(-v // 8) * 8)
    assert (xp is x) == (wp.shape[0] == k) == (k % 128 == 0)
    assert float(xp[:, k:].abs().sum()) == 0.0 and float(wp[k:].abs().sum()) == 0.0
    wpv = wp[:, :v]
    lse, lse_p = vocab_lse.lse_plain(x, w, b), vocab_lse.lse_plain(xp, wpv, b)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), rtol=1e-6)
    want = vocab_lse.lse_bwd_plain(x, w, b, lse, gr)
    got = vocab_lse.lse_bwd_plain(xp, wpv, b, lse, gr)
    for a, ref in ((got[0][:, :k], want[0]), (got[1][:k], want[1]), (got[2], want[2])):
        np.testing.assert_allclose(a.float().numpy(), ref.float().numpy(),
                                   atol=1e-6 * float(ref.float().abs().max()))
    assert kp == k or float(got[0][:, k:].float().abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        vocab_lse._check(x, w, b)


@pytest.mark.cuda
def test_k4_joint_shape_on_card():
    """K4 at the joint's K 320 through `streaming_lse` (the padded copy):
    lse and the gradients within the kernel bounds of the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 is a CUDA kernel")
    g = torch.Generator().manual_seed(0)
    n, k, v = 700, 320, 5001
    x = torch.randn(n, k, generator=g).cuda().bfloat16().requires_grad_()
    w = (torch.randn(k, v, generator=g) / k ** 0.5).cuda().bfloat16().requires_grad_()
    b = torch.randn(v, generator=g).cuda().requires_grad_()
    before = vocab_lse.FWD_LAUNCHES
    lse = vocab_lse.streaming_lse(x, w, b)
    lse.sum().backward()
    assert vocab_lse.FWD_LAUNCHES == before + 1
    ref = vocab_lse.lse_plain(x.detach(), w.detach(), b.detach())
    dx, dw, db = vocab_lse.lse_bwd_plain(x.detach(), w.detach(), b.detach(), ref,
                                         torch.ones(n, device="cuda"))
    assert torch.allclose(lse, ref, atol=1e-3, rtol=1e-4)
    for got, want in ((x.grad, dx), (w.grad, dw), (b.grad, db)):
        assert float((got.float() - want.float()).abs().max()) <= 1e-2 * float(
            want.float().abs().max())


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("route", ["dense", "chunked"])
def test_forward_matches_jax_on_recipe(route):
    """`forward` on train_asr_transducer.yaml scaled down (vocabulary 300,
    ctc_weight 0.3 from the recipe; chunked: joint_chunk_t 16): the losses
    and every gradient within 1e-5."""
    extra = ["vocab_size=300"] + (["model_conf.joint_chunk_t=16"] if route == "chunked" else [])
    jcfg, tcfg = _cfgs(*extra)
    assert tcfg.ctc_weight == jcfg.ctc_weight == 0.3
    assert (tcfg.joint_chunk_t is None) == (route == "dense")
    tree = _tree(jcfg)
    batch = _batch(300)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jta.forward(p, jcfg, b, train=False),
                                    has_aux=True))
    (_, jstats), jgrads = fn(jax.tree.map(jnp.asarray, tree), _jb(batch))
    model = _model(tree, tcfg)
    loss, stats = tta.forward(model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                              train=False)
    loss.backward()
    for key in ("loss", "loss_transducer", "loss_ctc"):
        np.testing.assert_allclose(float(stats[key]), float(jstats[key]), rtol=1e-5,
                                   err_msg=key)
    got = numpy_from_transducer_params({n: p.grad for n, p in model.named_parameters()}, tcfg)
    want = _flat(jgrads)
    scale = max(np.abs(v).max() for v in want.values())
    assert set(got) == set(want) - {"mvn/mean", "mvn/std"}
    for key, g in got.items():
        tol = 5e-6 * scale if key.endswith(ZERO_GRAD) else 1e-4 * np.abs(want[key]).max()
        np.testing.assert_allclose(g, want[key], atol=tol, err_msg=key)


def test_task_from_dict_matches_jax_fields():
    """`task_from_dict` on the recipe: JAX's field values, kind transducer."""
    raw = load_yaml(RECIPE)
    jt, tt = jax_task_from_dict(raw), task_from_dict(raw)
    assert tt.kind == jt.kind == "transducer"
    assert dataclasses.asdict(tt.cfg.decoder) == dataclasses.asdict(jt.cfg.decoder)
    for f in ("ctc_weight", "fastemit_lambda", "use_specaug", "joint_chunk_t",
              "mvn_stats_path", "ignore_id"):
        assert getattr(tt.cfg, f) == getattr(jt.cfg, f), f
    assert dataclasses.asdict(tt.cfg.specaug) == dataclasses.asdict(jt.cfg.specaug)
    for f in ("output_size", "attention_heads", "linear_units", "num_blocks",
              "cnn_module_kernel", "macaron_style", "use_cnn_module", "conv_norm"):
        assert getattr(tt.cfg.encoder, f) == getattr(jt.cfg.encoder, f), f
    assert tt.cfg.decoder.joint_space_size == 320 and tt.cfg.decoder.vocab_size == 51865


def test_params_both_ways_and_init_layout():
    """JAX's tree -> state dict -> JAX's flat npz, bit for bit; the port's
    init has JAX's leaves, shapes and the blank row at zero."""
    jcfg, tcfg = _cfgs("vocab_size=300")
    tree = _tree(jcfg)
    back = numpy_from_transducer_params(transducer_params_from_numpy(tree, tcfg), tcfg)
    flat = _flat(tree)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    sd = tta.init_transducer_asr_params(torch.Generator().manual_seed(0), tcfg)
    mine = numpy_from_transducer_params(sd, tcfg)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in flat.items()}
    assert float(np.abs(mine["transducer/embed"][0]).max()) == 0.0
    assert mine["transducer/layers/w_ih"].shape == (2, 32, 128)


def test_eval_step_with_greedy_matches_jax():
    """The eval pass: the losses within 1e-5 and the greedy tokens of the
    same encoder pass identical to JAX's."""
    jcfg, tcfg = _cfgs("vocab_size=300")
    tree = _tree(jcfg)
    batch = _batch(300, seed=2)
    jstats, (jtok, jn) = jax.jit(lambda p, b: jta.eval_step_with_greedy(
        p, jcfg, b, max_symbols=16))(jax.tree.map(jnp.asarray, tree), _jb(batch))
    model = _model(tree, tcfg)
    stats, (tok, n) = tta.eval_step_with_greedy(
        model, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()}, max_symbols=16)
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert int(n.sum()) > 0


# ---------------------------------------------------- freeze presets


def _jax_mask_paths(tree, preset):
    mask = jfreeze.trainable_mask(tree, preset)
    return {".".join(str(getattr(k, "key", k)) for k in path): bool(m)
            for path, m in jax.tree_util.tree_flatten_with_path(mask)[0]}


@pytest.mark.parametrize("family,preset", [
    ("conformer", "none"), ("conformer", "adapter"), ("conformer", "freeze_decoder_adapter"),
    ("conformer", ["encoder.blocks", "ctc"]), ("transducer", "all_param"),
    ("transducer", "freeze_decoder_pe"), ("transducer", ["transducer.layers", "encoder"]),
    ("transducer", ["transducer.joint.lin_out"]),
], ids=str)
def test_freeze_presets_match_jax_mask(family, preset):
    """A preset or a prefix list selects the parameters JAX's
    `trainable_mask` selects, on the conformer and the transducer families."""
    if family == "conformer":
        from agacs_tpu.models import conformer_asr as jasr
        from agacs_tpu_torch.models import conformer_asr as tasr

        raw = {"encoder": "conformer", "encoder_conf": {
            "output_size": 64, "attention_heads": 2, "linear_units": 128, "num_blocks": 2},
            "decoder_conf": {"attention_heads": 2, "linear_units": 128, "num_blocks": 1},
            "normalize": "global_mvn"}
        jcfg = jax_task_from_dict(raw).cfg
        tcfg = task_from_dict(raw).cfg
        tree = jax.tree.map(np.asarray, jasr.init_conformer_asr_params(jax.random.PRNGKey(0),
                                                                       jcfg))
        model = tasr.ConformerASR.from_state_dict(tcfg, conformer_params_from_numpy(tree, tcfg))
    else:
        jcfg, tcfg = _cfgs("vocab_size=300")
        tree = _tree(jcfg)
        model = _model(tree, tcfg)
    want = _jax_mask_paths(tree, preset)
    from agacs_tpu_torch.models.checkpoint import jax_paths

    paths = jax_paths(model)
    keep = set(trainable_names(model, preset))
    params = apply_freeze(model, preset)
    assert {id(p) for p in params} == {id(p) for n, p in model.named_parameters() if n in keep}
    for name, p in model.named_parameters():
        flags = {want[k.replace("/", ".")] for k in paths[name]}
        assert flags == {p.requires_grad}, name


def test_freeze_preset_splitting_qkv_raises():
    from agacs_tpu_torch.models import conformer_asr as tasr

    raw = {"encoder": "conformer", "encoder_conf": {
        "output_size": 64, "attention_heads": 2, "linear_units": 128, "num_blocks": 1},
        "decoder_conf": {"attention_heads": 2, "linear_units": 128, "num_blocks": 1}}
    model = tasr.ConformerASR(task_from_dict(raw).cfg, device="meta")
    with pytest.raises(ValueError, match="splits"):
        trainable_names(model, ["encoder.blocks.attn.q"])

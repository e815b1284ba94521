"""The port's n-gram scorer (`agacs_tpu_torch/models/ngram.py`) and its
training CLI against agacs_tpu on the CPU: the same corpus gives the same
tables; the same token buffers give the same scores, element for element
(the hash is exact uint32 arithmetic and the scores are float32 sums in
JAX's order, so the tolerance is zero); the npz loads both ways.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agacs_tpu.models import ngram as jng
from agacs_tpu_torch.models import ngram as tng

torch.set_num_threads(1)

V = 500
SOS = 1
EOT = 2


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(0)
    seqs = []
    for _ in range(300):
        n = rng.randint(3, 14)
        # a skewed head so higher orders repeat, and a long tail of rare ids
        head = rng.choice([3, 4, 5, 6, 7, 8, 9], size=n,
                          p=[0.3, 0.25, 0.2, 0.1, 0.07, 0.05, 0.03])
        tail = rng.randint(10, V, size=n)
        seqs.append([int(t) for t in np.where(rng.rand(n) < 0.8, head, tail)])
    return seqs


def _np(lm) -> dict:
    out = {"unigram": np.asarray(lm.unigram)}
    for i in range(lm.order - 1):
        out[f"keys1_{i}"] = np.asarray(lm.keys1[i]).astype(np.int64)
        out[f"keys2_{i}"] = np.asarray(lm.keys2[i]).astype(np.int64)
        out[f"logps_{i}"] = np.asarray(lm.logps[i])
    return out


def _buffers(seed: int, n: int, total: int) -> np.ndarray:
    """Token buffers as the beam holds them: an sos start, common and rare
    ids, an eot now and then."""
    rng = np.random.RandomState(seed)
    toks = np.where(rng.rand(n, total) < 0.7, rng.randint(3, 10, (n, total)),
                    rng.randint(0, V, (n, total)))
    toks[:, 0] = SOS
    toks[rng.rand(n, total) < 0.05] = EOT
    return toks.astype(np.int32)


@pytest.mark.parametrize("order,alpha", [(2, 0.4), (3, 0.4), (4, 0.25)])
def test_tables_equal_jax(corpus, order, alpha):
    """train_ngram: unigram, both key lanes and the log-probs bit-identical."""
    ref = _np(jng.train_ngram(corpus, V, order=order, alpha=alpha, sos=SOS))
    out = _np(tng.train_ngram(corpus, V, order=order, alpha=alpha, sos=SOS))
    assert ref.keys() == out.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("order", [2, 3, 4])
@pytest.mark.parametrize("pos", [0, 1, 2, 7, 14])
def test_scores_equal_jax(corpus, order, pos):
    """ngram_score_step over (24, 16) buffers: equal to JAX's element for
    element, at the sequence start (pos 0, 1: shorter contexts, no backoff
    penalty for them) and mid-sequence; both found and missed lookups."""
    jlm = jng.train_ngram(corpus, V, order=order, sos=SOS)
    tlm = tng.train_ngram(corpus, V, order=order, sos=SOS)
    toks = _buffers(pos, 24, 16)
    ref = np.asarray(jng.ngram_score_step(jlm, jnp.asarray(toks), jnp.int32(pos)))
    out = tng.ngram_score_step(tlm, torch.from_numpy(toks).long(), pos)
    assert out.dtype == torch.float32 and out.shape == (24, V)
    np.testing.assert_array_equal(out.numpy(), ref)
    # the scores take more than the unigram: some context was found
    assert (out.numpy() != np.asarray(tlm.unigram)[None] + np.float32(
        np.log(0.4)) * min(order - 1, pos + 1)).any()


def test_hash_near_2_32():
    """The 16-bit-half product equals (h * m) mod 2^32 at h next to 2^32 and
    at random h; _hash_rows equals the host hasher and JAX's uint32 lanes
    for contexts with ids up to 2^31 - 1."""
    rng = np.random.RandomState(3)
    hs = np.concatenate([np.arange(2 ** 32 - 64, 2 ** 32), [0, 1, 2 ** 31, 2 ** 31 - 1],
                         rng.randint(0, 2 ** 32, 200, dtype=np.uint64).astype(np.int64)])
    for m in (tng._M1, tng._M2, 0xFFFFFFFF, 0x10001):
        out = tng._mul_u32(torch.from_numpy(hs.astype(np.int64)), m).numpy()
        want = np.array([(int(h) * m) & 0xFFFFFFFF for h in hs], np.int64)
        np.testing.assert_array_equal(out, want)
    ctx = rng.randint(0, 2 ** 31 - 1, (6, 3)).astype(np.int64)
    ctx[0] = [2 ** 31 - 1, 2 ** 31 - 2, 0]
    cand = np.concatenate([np.arange(5), [2 ** 31 - 2, 51864]]).astype(np.int64)
    h1, h2 = tng._hash_rows(torch.from_numpy(ctx), torch.from_numpy(cand))
    j1, j2 = jng._hash_rows(jnp.asarray(ctx, jnp.int32), jnp.asarray(cand, jnp.int32))
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2).astype(np.int64))
    for i in range(ctx.shape[0]):
        for j, c in enumerate(cand):
            assert (int(h1[i, j]), int(h2[i, j])) == jng._hash_ngram_host(
                list(ctx[i]) + [c])
    assert int(h1.max()) > 2 ** 31  # the upper half of the range is in play


def test_start_of_sequence_backoff(corpus):
    """pos 0: only the bigram (SOS, t) context exists; its score is the
    bigram log-prob where seen (no backoff for the missing trigram context)
    and the unigram with one backoff where not, as JAX's."""
    tlm = tng.train_ngram(corpus, V, order=3, sos=SOS)
    jlm = jng.train_ngram(corpus, V, order=3, sos=SOS)
    toks = np.full((1, 8), 0, np.int32)
    toks[0, 0] = SOS
    out = tng.ngram_score_step(tlm, torch.from_numpy(toks).long(), 0).numpy()
    ref = np.asarray(jng.ngram_score_step(jlm, jnp.asarray(toks), jnp.int32(0)))
    np.testing.assert_array_equal(out, ref)
    assert np.isfinite(out).all()
    firsts = {s[0] for s in corpus}
    seen, unseen = min(firsts), max(set(range(3, V)) - firsts)
    assert out[0, seen] > out[0, unseen]
    uni = np.asarray(tlm.unigram)
    assert out[0, unseen] == np.float32(uni[unseen] + np.float32(np.log(0.4)))


def test_npz_both_ways(tmp_path, corpus):
    """An npz written by either package loads in the other with the same
    tables and scores."""
    jlm = jng.train_ngram(corpus, V, order=3, alpha=0.3, sos=SOS)
    tlm = tng.train_ngram(corpus, V, order=3, alpha=0.3, sos=SOS)
    jng.save_ngram(str(tmp_path / "j.npz"), jlm)
    tng.save_ngram(str(tmp_path / "t.npz"), tlm)
    from_j = tng.load_ngram(str(tmp_path / "j.npz"))
    from_t = jng.load_ngram(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "t.npz") as d:
        assert d["keys1_0"].dtype == np.uint32 and int(d["order"]) == 3
    assert (from_j.order, from_j.alpha) == (3, 0.3)
    toks = _buffers(9, 8, 10)
    ref = np.asarray(jng.ngram_score_step(jlm, jnp.asarray(toks), jnp.int32(5)))
    for lm in (from_j, tlm):
        np.testing.assert_array_equal(
            tng.ngram_score_step(lm, torch.from_numpy(toks).long(), 5).numpy(), ref)
    np.testing.assert_array_equal(
        np.asarray(jng.ngram_score_step(from_t, jnp.asarray(toks), jnp.int32(5))), ref)


def test_ngram_train_cli_matches_jax(tmp_path):
    """bin.ngram_train against agacs_tpu.bin.ngram_train on a Kaldi text
    file (English and Mandarin, the whisper tokenizer, vocabulary 51865):
    the same npz arrays."""
    from agacs_tpu.bin import ngram_train as jax_cli
    from agacs_tpu_torch.bin import ngram_train as cli

    text = tmp_path / "text"
    text.write_text("u1 hello world 你好\nu2 we go to the 市场 today\nu3 \n"
                    "u4 hello 你好 world again\nu5 the world is big 世界很大\n",
                    encoding="utf-8")
    jout = jax_cli.main(["--train_text", str(text), "--output", str(tmp_path / "j.npz")])
    tout = cli.main(["--train_text", str(text), "--output", str(tmp_path / "t" / "t.npz"),
                     "--order", "3", "--alpha", "0.4"])
    assert tout["n_seqs"] == jout["n_seqs"] == 4
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t" / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["unigram"].shape == (51865,)


def test_device_move_and_weight_without_scorer():
    """`NgramLM.to` moves every table; composed_beam_decode refuses an
    n-gram weight without its scorer."""
    from agacs_tpu_torch.decode.composed_beam import composed_beam_decode

    lm = tng.train_ngram([[3, 4, 5]], 10, order=3, sos=SOS).to("cpu")
    assert all(t.device.type == "cpu" for t in [lm.unigram, *lm.keys1, *lm.keys2, *lm.logps])
    with pytest.raises(ValueError):
        composed_beam_decode(lambda c, p, s: (torch.zeros(c.shape[0], 10), s),
                             torch.zeros(1, 2), batch=1, vocab=10, beam_size=2, primer=(1,),
                             max_steps=3, eot=2, max_pos=8, ngram_weight=0.3)

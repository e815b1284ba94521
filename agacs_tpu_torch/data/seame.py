"""SEAME-style Mandarin-English transcript normalization + data prep
(counterpart of `agacs_tpu/data/seame.py`).

Behavior-equivalent port of the reference recipe's preprocessing
(`egs2/seame/asr1/local/preprocess.py`): punctuation/fullwidth stripping,
control-char removal, noise-tag canonicalization, <unk> canonicalization,
space insertion between hanzi, language extraction helpers, and the
corpus-layout prep (SEAME's phaseI/II transcript files and the
SEAME-dev-set splits -> kaldi data dirs, `prepare_seame_corpus`).
"""

from __future__ import annotations

import collections
import os
import random
import re

from agacs_tpu_torch.data.io import write_scp

# punctuation translated to spaces (preprocess.py:31-32)
_REMOVE_PUNC = "()[]{}.,?·@，。、「」＃\"~-—#%_`｀×*（）［］&【】～ｌ\\"
_PUNC_TABLE = str.maketrans(_REMOVE_PUNC, " " * len(_REMOVE_PUNC))

# fullwidth latin -> ascii + é -> e (preprocess.py:34-36)
_FW_SRC = (
    "ａｂｃｄｅｆｇｈｉｊｋｌｍｎｏｐｑｒｓｔｕｖｗｘｙｚ"
    "ＡＢＣＤＥＦＧＨＩＪＫＬＭＮＯＰＱＲＳＴＵＶＷＸＹＺé"
)
_FW_DST = "abcdefghijklmnopqrstuvwxyz" * 2 + "e"
_FW_TABLE = str.maketrans(_FW_SRC, _FW_DST)

_CONTROL_RE = re.compile(
    "[%s]" % re.escape("".join(map(chr, list(range(0x00, 0x20)) + list(range(0x7F, 0xA0)))))
)

_NOISE_WORDS = {"ppl", "ppc", "ppb", "ppo", "<v-noise>"}


def remove_control_chars(text: str) -> str:
    return _CONTROL_RE.sub("", text)


def remove_redundant_whitespaces(text: str) -> str:
    return re.sub(" +", " ", text).strip()


def is_english_char(c: str) -> bool:
    return "a" <= c.lower() <= "z"


def is_mandarin_char(c: str) -> bool:
    return (
        not is_english_char(c)
        and not c.isdigit()
        and c not in (" ", "<", ">", "'")
    )


def extract_mandarin_only(text: str) -> str:
    return "".join(c for c in text if is_mandarin_char(c))


def extract_non_mandarin(text: str) -> str:
    return " ".join(
        w for w in text.split(" ") if w and not any(is_mandarin_char(c) for c in w)
    )


def insert_space_between_mandarin(text: str) -> str:
    """Space-wrap hanzi (preprocess.py:81-94; note the reference leaves the
    FIRST character unwrapped — replicated)."""
    if len(text) <= 1:
        return text
    out = [text[0]]
    for c in text[1:]:
        out.append(f" {c} " if is_mandarin_char(c) else c)
    return "".join(out)


def remove_repeated_noise(text: str, tag: str = "<noise>") -> str:
    """Collapse runs of the noise tag (preprocess.py:97-112)."""
    if len(re.findall(re.escape(tag), text)) <= 1:
        return text
    words = text.split()
    out = []
    for w in words:
        if w == tag and out and out[-1] == tag:
            continue
        out.append(w)
    return " ".join(out)


def normalize_text(text: str) -> str:
    """Full SEAME transcript normalization (preprocess.py:115-151)."""
    t = re.sub(r"\(((pp)(\w)+)\)", "<noise>", text.lower())
    t = re.sub(r"\<((pp)(\w)+)\>", "<noise>", t)
    t = t.translate(_PUNC_TABLE)
    t = remove_control_chars(t)
    t = " ".join("<noise>" if w in _NOISE_WORDS else w for w in t.split())
    t = t.translate(_FW_TABLE)
    t = t.replace("<unl>", "<unk>")
    t = t.replace("< unk >", "<unk>")
    t = re.sub(r"\<((unk)[a-z ]+)\>", "<unk>", t)
    t = insert_space_between_mandarin(t)
    t = remove_redundant_whitespaces(t)
    t = remove_repeated_noise(t, "<noise>")
    return t


# --------------------------------------------------------------------------
# Corpus-layout prep: raw SEAME checkout + SEAME-dev-set repo -> data dirs
# (behavior port of preprocess.py:154-643 __main__ flow)
# --------------------------------------------------------------------------

_SPLITS = ("train", "valid", "devman", "devsge")


def _fit_format(digit: str) -> float:
    """preprocess.py:258-264 quirky half-up rounding helper."""
    str_digit = str(float(digit) / 10.0)
    return float(digit) + 1 if int(str_digit[-1]) >= 5 else float(digit)


def _norm_time(t: str) -> str:
    """Timestamp -> the dev-set 5-digit 10-ms-unit convention
    (preprocess.py:215-227)."""
    if len(t) < 5:
        return str(int(round(_fit_format(t) / 10, 0))).zfill(5)
    return str(int(round(float(t) / 10, 0)))


def _speaker_of(idx: str) -> str:
    """preprocess.py:231-235 speaker-id extraction."""
    head = idx.split("_")[0]
    return head[2:-2].lower() if head[0].isdigit() else head[:5].lower()


def read_transcripts(corpus_dir: str) -> dict:
    """Parse SEAME phaseII transcripts under
    {conversation,interview}/transcript/phaseII/*.txt into the utterance
    dict (preprocess.py:186-256 read_trans; phaseI is parsed when phaseII
    is absent, matching the 4-column fallback at :198-204)."""
    data: dict[str, dict] = {}
    for atp in ("conversation", "interview"):
        audio_dir = os.path.abspath(os.path.join(corpus_dir, atp, "audio"))
        if not os.path.isdir(audio_dir):
            continue
        audio_ids = {
            os.path.splitext(f)[0].lower() for f in os.listdir(audio_dir)
        }
        for phs in ("phaseII", "phaseI"):
            tdir = os.path.join(corpus_dir, atp, "transcript", phs)
            if not os.path.isdir(tdir):
                continue
            for txt in sorted(os.listdir(tdir)):
                with open(os.path.join(tdir, txt), encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        parts = line.split("\t")
                        if phs == "phaseII":
                            if len(parts) != 5:
                                continue
                            idx, start, end, _lang, text = parts
                        else:
                            if len(parts) != 4:
                                continue  # "no transcript" rows skipped
                            idx, start, end, text = parts
                        start_ms, end_ms = start, end
                        s, e = _norm_time(start), _norm_time(end)
                        name = f"{idx}-{s}-{e}".lower()
                        if name in data:
                            continue
                        if idx.split("-")[0].lower() not in audio_ids:
                            raise FileNotFoundError(
                                f"{idx}: no FLAC in {audio_dir}"
                            )
                        data[name] = {
                            "text": text,
                            "start": s,
                            "end": e,
                            "speaker": _speaker_of(idx),
                            "split": "train",
                            # original-case recording id: the on-disk FLAC
                            # name (preprocess.py:238-241)
                            "audio_pth": os.path.join(
                                audio_dir, idx.split("-")[0] + ".flac"
                            ),
                            "start_ms": start_ms,
                            "end_ms": end_ms,
                            "phase": phs,
                        }
            break  # only one phase dir per type (phaseII preferred)
    return data


def _read_dev_ids(path: str) -> list[str]:
    """SEAME-dev-set {dev_man,dev_sge}/text first columns, speaker prefix
    stripped (preprocess.py:169-183 read_text rmspk=True)."""
    ids = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                ids.append(line.split()[0].split("-", 1)[-1].lower())
    return ids


def assign_splits(data: dict, repo_dir: str, num_val: int | None = None) -> dict:
    """Speaker-disjoint split assignment from the official dev-set repo
    (preprocess.py:267-343): devman/devsge by ±3-unit time matching,
    train restricted to wav_file.txt recordings, the rest 'other', then a
    deterministic (seed 531) 5% validation carve-out of train."""
    # dev sets: match utterances by recording id + approximate times
    by_rec: dict[str, list[str]] = {}
    for key in data:
        by_rec.setdefault(key.split("-")[0], []).append(key)
    for splitname, sub in (("devman", "dev_man"), ("devsge", "dev_sge")):
        for tid in _read_dev_ids(os.path.join(repo_dir, sub, "text")):
            rec, s, e = tid.split("-")
            s, e = float(s), float(e)
            for key in by_rec.get(rec, ()):
                _, ks, ke = key.split("-")
                if abs(s - float(ks)) < 3 and abs(e - float(ke)) < 3:
                    data[key]["split"] = splitname
                    break

    # train sieve: recordings listed in the repo's train/wav_file.txt
    train_recs = set()
    with open(os.path.join(repo_dir, "train", "wav_file.txt"),
              encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                train_recs.add(line.split("/")[-2].lower())
    for key, content in data.items():
        if content["split"] == "train" and key.split("-")[0] not in train_recs:
            content["split"] = "other"

    # validation carve-out (preprocess.py:312-331 split_val, seed 531)
    tr = [k for k, v in data.items() if v["split"] == "train"]
    random.Random(531).shuffle(tr)
    n_val = num_val if num_val else int(len(tr) * 0.05)
    for k in tr[len(tr) - n_val:]:
        data[k]["split"] = "valid"
    return data


def _sort_by_speaker(data: dict) -> dict:
    """Speaker -> recording -> start-time ordering (preprocess.py:597-625)."""
    by_spk: dict[str, list[str]] = {}
    for k, v in data.items():
        by_spk.setdefault(v["speaker"], []).append(k)
    ordered = []
    for spk in sorted(by_spk):
        keys = sorted(by_spk[spk])
        by_rec: dict[str, list[str]] = {}
        for k in keys:
            by_rec.setdefault(k.split("-")[0], []).append(k)
        for rec in by_rec.values():
            ordered += sorted(rec, key=lambda k: int(k.split("-")[1]))
    return {k: data[k] for k in ordered}


def write_split_dirs(data: dict, out_dir: str) -> dict:
    """Kaldi-format outputs per split (preprocess.py:358-478 write_f):
    wav.scp (recording-level FLAC paths — decoded natively here instead of
    the reference's `flac -c -d |` pipe), segments, text (= the
    reference's text.rm.noise, kept tags, see local/data.sh:48), text.ori,
    text.clean, utt2spk, spk2gender, list; plus the train-side
    text.man/token.man.{1,2}/text.eng.bpe (preprocess.py:480-521,629-643).
    Filters: empty cleaned text, duration <= 10 ms."""
    data = _sort_by_speaker(data)
    stats: dict[str, dict] = {}
    for split in _SPLITS:
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        wav, text, text_ori, text_clean, utt2spk, segs = {}, {}, {}, {}, {}, {}
        gender: dict[str, str] = {}
        ids = []
        for key, c in data.items():
            if c["split"] != split:
                continue
            norm = normalize_text(c["text"])
            clean = remove_redundant_whitespaces(
                norm.replace("<noise>", "").replace("<unk>", "")
            )
            if not clean:
                continue
            rec, s, e = key.split("-")
            if float(e) - float(s) <= 1:
                continue
            idx = f"{rec}-{s.zfill(6)}-{e.zfill(6)}"
            spkr = c["speaker"]
            utt = f"{spkr}-{idx}"
            if spkr[-1] in ("m", "f"):
                gender[spkr] = spkr[-1]
            else:
                for g in reversed(rec.split("_")[0]):
                    if g.lower() in ("m", "f"):
                        gender[spkr] = g.lower()
                        break
            ids.append(utt)
            wav[rec] = c["audio_pth"]
            text[utt] = norm.replace("<unk>", "<UNK>")
            text_ori[utt] = c["text"]
            text_clean[utt] = clean
            utt2spk[utt] = spkr
            segs[utt] = f"{rec} {float(s) / 100} {float(e) / 100}"
        write_scp(os.path.join(d, "wav.scp"), wav)
        write_scp(os.path.join(d, "text"), text)
        write_scp(os.path.join(d, "text.ori"), text_ori)
        write_scp(os.path.join(d, "text.clean"), text_clean)
        write_scp(os.path.join(d, "utt2spk"), utt2spk)
        write_scp(os.path.join(d, "spk2gender"), dict(sorted(gender.items())))
        write_scp(os.path.join(d, "segments"), segs)
        spk2utt: dict[str, list] = {}
        for u, s_ in utt2spk.items():
            spk2utt.setdefault(s_, []).append(u)
        write_scp(
            os.path.join(d, "spk2utt"),
            {s_: " ".join(us) for s_, us in spk2utt.items()},
        )
        with open(os.path.join(d, "list"), "w", encoding="utf-8") as f:
            f.write("".join(u + "\n" for u in ids))
        stats[split] = {"n_utts": len(ids), "n_spk": len(set(utt2spk.values()))}

    # train-side tokenizer inputs
    counter = collections.Counter()
    man_lines, eng_lines = [], []
    for key, c in data.items():
        if c["split"] != "train":
            continue
        t = remove_redundant_whitespaces(
            normalize_text(c["text"]).replace("<noise>", "").replace("<unk>", "")
        )
        man = extract_mandarin_only(t)
        counter.update(man)
        if man:
            man_lines.append(man)
        eng = extract_non_mandarin(t)
        if eng:
            eng_lines.append(eng)
    tdir = os.path.join(out_dir, "train")
    with open(os.path.join(tdir, "text.man"), "w", encoding="utf-8") as f:
        f.write("".join(l + "\n" for l in man_lines))
    vocab = sorted(counter.keys())
    with open(os.path.join(tdir, "token.man.1"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab))
    with open(os.path.join(tdir, "token.man.2"), "w", encoding="utf-8") as f:
        f.write('bpe_nlsyms="<noise>,▁' + ",▁".join(vocab) + '"\n')
        f.write(f"man_chars={len(vocab)}")
    with open(os.path.join(tdir, "text.eng.bpe"), "w", encoding="utf-8") as f:
        f.write("".join(l + "\n" for l in eng_lines))
    stats["man_vocab"] = len(vocab)
    return stats


def prepare_seame_corpus(
    corpus_dir: str, repo_dir: str, out_dir: str, num_val: int | None = None
) -> dict:
    """Raw SEAME + SEAME-dev-set repo -> data/{train,valid,devman,devsge}."""
    data = read_transcripts(corpus_dir)
    data = assign_splits(data, repo_dir, num_val=num_val)
    return write_split_dirs(data, out_dir)

"""Kaldi-style data-dir utilities (counterpart of `agacs_tpu/data/datadir.py`)
— the `utils/` scripts as a library.

The reference's recipes lean on Kaldi's shell/perl helpers for data-dir
hygiene and job fan-out: `validate_data_dir.sh`, `fix_data_dir.sh`,
`split_scp.pl` / `split_data.sh`, `subset_data_dir.sh`, `filter_scp.pl`,
`utt2spk_to_spk2utt.pl` (cloned via `tools/Makefile:34-35`, used
throughout `egs2/TEMPLATE/asr1/asr.sh`). This module reimplements the
subset those recipes exercise as pure Python over the same file formats
(wav.scp / text / utt2spk / spk2utt / segments / utt2num_samples).

Semantics kept from Kaldi:
  - a data dir's key space is the utterance id; files must be unique-keyed
    and are kept sorted (C-locale order) so set operations are mergeable
  - fix = intersect utterance sets across all per-utt files, drop strays,
    resort, regenerate spk2utt from utt2spk
  - split is speaker-disjoint when utt2spk exists (split_data.sh default),
    contiguous otherwise
"""

from __future__ import annotations

import os
import random
import shutil

from agacs_tpu_torch.data.io import read_scp, write_scp

# per-utterance files that participate in key intersection / splitting
PER_UTT_FILES = ("wav.scp", "text", "utt2spk", "segments", "utt2num_samples")


def load_dir(d: str) -> dict[str, dict[str, str]]:
    """All recognized per-utt files present in `d` as {name: {utt: value}}.

    With a `segments` file the utterance key space comes from segments and
    wav.scp is recording-keyed (returned under 'wav.scp' untouched)."""
    out = {}
    for name in PER_UTT_FILES + ("spk2utt",):
        p = os.path.join(d, name)
        if os.path.exists(p):
            out[name] = read_scp(p)
    return out


def utt2spk_to_spk2utt(utt2spk: dict[str, str]) -> dict[str, str]:
    spk: dict[str, list[str]] = {}
    for u, s in utt2spk.items():
        spk.setdefault(s, []).append(u)
    return {s: " ".join(sorted(us)) for s, us in sorted(spk.items())}


def spk2utt_to_utt2spk(spk2utt: dict[str, str]) -> dict[str, str]:
    out = {}
    for s, us in spk2utt.items():
        for u in us.split():
            out[u] = s
    return dict(sorted(out.items()))


def filter_keys(entries: dict[str, str], keys) -> dict[str, str]:
    """filter_scp.pl: keep entries whose key is in `keys`, input order."""
    keyset = set(keys)
    return {k: v for k, v in entries.items() if k in keyset}


def _utt_keyed_names(files: dict) -> list[str]:
    """Names of files keyed by utterance id (wav.scp is recording-keyed
    when segments exists)."""
    names = [n for n in PER_UTT_FILES if n in files]
    if "segments" in files and "wav.scp" in files:
        names.remove("wav.scp")
    return names


def validate_data_dir(d: str, require_text: bool = True) -> list[str]:
    """Returns a list of problems (empty = valid) — validate_data_dir.sh."""
    problems: list[str] = []
    files = load_dir(d)
    if "wav.scp" not in files:
        problems.append("missing wav.scp")
    if require_text and "text" not in files:
        problems.append("missing text")
    if not files:
        return problems

    # sortedness + duplicate keys (read_scp keeps last dup silently; re-scan)
    for name in files:
        p = os.path.join(d, name)
        keys = []
        with open(p, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    keys.append(line.split(maxsplit=1)[0])
        if len(set(keys)) != len(keys):
            problems.append(f"{name}: duplicate keys")
        if keys != sorted(keys):
            problems.append(f"{name}: not sorted")

    utt_names = _utt_keyed_names(files)
    if utt_names:
        base = set(files[utt_names[0]])
        for name in utt_names[1:]:
            got = set(files[name])
            if got != base:
                only_a = sorted(base - got)[:3]
                only_b = sorted(got - base)[:3]
                problems.append(
                    f"utterance mismatch between {utt_names[0]} and {name} "
                    f"(e.g. {only_a} vs {only_b})"
                )
    if "segments" in files and "wav.scp" in files:
        recs = set(files["wav.scp"])
        for u, v in files["segments"].items():
            parts = v.split()
            if len(parts) != 3:
                problems.append(f"segments: malformed entry {u!r}")
                continue
            rec, start, end = parts
            try:
                start_f, end_f = float(start), float(end)
            except ValueError:
                problems.append(f"segments: malformed entry {u!r}")
                continue
            if rec not in recs:
                problems.append(f"segments: {u} references unknown recording {rec}")
            elif end_f <= start_f:
                problems.append(f"segments: {u} has non-positive duration")
    if "utt2spk" in files and "spk2utt" in files:
        if utt2spk_to_spk2utt(files["utt2spk"]) != dict(
            sorted(files["spk2utt"].items())
        ):
            problems.append("spk2utt is not consistent with utt2spk")
    if "utt2spk" in files:
        # kaldi warns when utt2spk is not speaker-contiguous; treat the
        # hard error only (empty speaker)
        if any(not s for s in files["utt2spk"].values()):
            problems.append("utt2spk: empty speaker id")
    return problems


def fix_data_dir(d: str) -> int:
    """Intersect utt sets across per-utt files, sort, dedupe, regenerate
    spk2utt (fix_data_dir.sh). Returns the number of utterances kept."""
    files = load_dir(d)
    utt_names = _utt_keyed_names(files)
    if not utt_names:
        return 0
    keep = set(files[utt_names[0]])
    for name in utt_names[1:]:
        keep &= set(files[name])
    if "segments" in files and "wav.scp" in files:
        # drop utterances whose recording is missing (fix_data_dir.sh
        # filters segments against wav.scp before intersecting)
        recs = set(files["wav.scp"])
        # an empty/malformed segments value (no fields) is dropped rather
        # than raising IndexError
        keep = {
            u for u in keep
            if files["segments"][u].split()[:1] and
            files["segments"][u].split()[0] in recs
        }
    for name in utt_names:
        kept = {k: files[name][k] for k in sorted(keep)}
        write_scp(os.path.join(d, name), kept)
    if "segments" in files and "wav.scp" in files:
        # drop recordings no longer referenced
        used = {files["segments"][u].split()[0] for u in sorted(keep)}
        wav = {k: v for k, v in sorted(files["wav.scp"].items()) if k in used}
        write_scp(os.path.join(d, "wav.scp"), wav)
    if "utt2spk" in files:
        u2s = {k: files["utt2spk"][k] for k in sorted(keep)}
        write_scp(os.path.join(d, "spk2utt"), utt2spk_to_spk2utt(u2s))
    return len(keep)


def _copy_subset(src: str, dst: str, utts: list[str]) -> None:
    files = load_dir(src)
    os.makedirs(dst, exist_ok=True)
    keep = sorted(utts)
    for name in _utt_keyed_names(files):
        write_scp(
            os.path.join(dst, name),
            {k: files[name][k] for k in keep if k in files[name]},
        )
    if "segments" in files and "wav.scp" in files:
        used = {
            files["segments"][u].split()[0] for u in keep if u in files["segments"]
        }
        write_scp(
            os.path.join(dst, "wav.scp"),
            {k: v for k, v in sorted(files["wav.scp"].items()) if k in used},
        )
    if "utt2spk" in files:
        u2s = {k: files["utt2spk"][k] for k in keep if k in files["utt2spk"]}
        write_scp(os.path.join(dst, "spk2utt"), utt2spk_to_spk2utt(u2s))


def split_data_dir(d: str, n: int, out_root: str | None = None) -> list[str]:
    """Split into n job shards (split_data.sh): speaker-disjoint when
    utt2spk exists, contiguous otherwise. Returns the shard dirs."""
    files = load_dir(d)
    utt_names = _utt_keyed_names(files)
    utts = sorted(files[utt_names[0]]) if utt_names else []
    if n <= 0 or n > max(len(utts), 1):
        raise ValueError(f"cannot split {len(utts)} utterances into {n} shards")
    out_root = out_root or os.path.join(d, f"split{n}")
    if os.path.isdir(out_root):
        # only ever delete something that looks like a previous split
        # output (digit-named shard subdirs); refuse arbitrary targets —
        # split_data.sh never deletes pre-existing directories
        entries = os.listdir(out_root)
        if entries and not all(e.isdigit() for e in entries):
            raise ValueError(
                f"refusing to overwrite {out_root!r}: it is not a previous "
                "split output (non-shard entries present)"
            )
        shutil.rmtree(out_root)

    shards: list[list[str]] = [[] for _ in range(n)]
    if "utt2spk" in files:
        # greedy speaker binning: speakers in order, always into the
        # currently-smallest shard — speaker-disjoint like split_data.sh
        by_spk: dict[str, list[str]] = {}
        for u in utts:
            by_spk.setdefault(files["utt2spk"][u], []).append(u)
        for _, us in sorted(by_spk.items(), key=lambda kv: (-len(kv[1]), kv[0])):
            shards[min(range(n), key=lambda i: len(shards[i]))].extend(us)
    else:
        k, m = divmod(len(utts), n)
        at = 0
        for i in range(n):
            size = k + (1 if i < m else 0)
            shards[i] = utts[at : at + size]
            at += size

    dirs = []
    for i, sh in enumerate(shards, 1):
        dst = os.path.join(out_root, str(i))
        _copy_subset(d, dst, sh)
        dirs.append(dst)
    return dirs


def subset_data_dir(
    d: str, out: str, n: int, mode: str = "first", seed: int = 0
) -> int:
    """subset_data_dir.sh: first/last/random n utterances into `out`."""
    if n <= 0:
        # kaldi's subset_data_dir.sh rejects n<=0 (and utts[-0:] would
        # silently mean "all" in the last mode)
        raise ValueError(f"subset size must be positive, got {n}")
    files = load_dir(d)
    utt_names = _utt_keyed_names(files)
    utts = sorted(files[utt_names[0]]) if utt_names else []
    n = min(n, len(utts))
    if mode == "first":
        pick = utts[:n]
    elif mode == "last":
        pick = utts[-n:]
    elif mode == "random":
        rng = random.Random(seed)
        pick = rng.sample(utts, n)
    else:
        raise ValueError(f"unknown subset mode {mode!r}")
    _copy_subset(d, out, pick)
    return len(pick)

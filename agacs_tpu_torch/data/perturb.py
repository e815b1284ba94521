"""Speed perturbation (counterpart of `agacs_tpu/data/perturb.py`): the
recipe's stage 1 (`asr.sh:503`, `utils/perturb_data_dir_speed.sh`: sox
speed 0.9/1.0/1.1).

`sox speed f` resamples the signal so duration scales by 1/f (pitch and
tempo both shift); here polyphase resampling by 1/f through scipy. Applied
offline to a data dir, like the reference, so training sees static shapes.
"""

from __future__ import annotations

import os
from fractions import Fraction

import numpy as np

from agacs_tpu_torch.data.io import read_scp, read_wav, write_scp, write_wav


def speed_perturb(audio: np.ndarray, factor: float) -> np.ndarray:
    """Resample so len(out) ≈ len(audio) / factor (sox `speed` semantics)."""
    if factor == 1.0:
        return audio
    from scipy.signal import resample_poly

    frac = Fraction(1.0 / factor).limit_denominator(1000)
    return resample_poly(audio, frac.numerator, frac.denominator).astype(np.float32)


def perturb_data_dir(data_dir: str, out_dir: str,
                     factors: tuple[float, ...] = (0.9, 1.0, 1.1)) -> None:
    """data dir -> combined dir with sp{factor}- prefixed utterances
    (perturb_data_dir_speed.sh naming: 'sp0.9-<utt>'). Factor 1.0 keeps
    each entry's wav.scp value as it is (an ark entry stays one); the
    others are written as WAV files under `out_dir/wavs`."""
    wav = read_scp(os.path.join(data_dir, "wav.scp"))
    text = read_scp(os.path.join(data_dir, "text"))
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    out_wav, out_text = {}, {}
    for utt, path in wav.items():
        for f in factors:
            if f == 1.0:
                out_wav[utt] = path
                out_text[utt] = text[utt]
                continue
            new_utt = f"sp{f}-{utt}"
            audio, sr = read_wav(path)
            new_path = os.path.join(out_dir, "wavs", f"{new_utt}.wav")
            write_wav(new_path, speed_perturb(audio, f), sr)
            out_wav[new_utt] = new_path
            out_text[new_utt] = text[utt]
    write_scp(os.path.join(out_dir, "wav.scp"), dict(sorted(out_wav.items())))
    write_scp(os.path.join(out_dir, "text"), dict(sorted(out_text.items())))

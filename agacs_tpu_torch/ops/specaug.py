"""SpecAug on (B, T, n_mels) log-mel features (counterpart of
`agacs_tpu/ops/specaug.py`): a piecewise-linear time warp, then freq masks
on the mel axis and time masks on the frame axis (the axes their names
claim, as in JAX; the reference swaps them).

The random draws are split from their application: `draw_specaug` takes
every random number from a `torch.Generator`, `apply_specaug` is a pure
function of the features and the draws, so a test can hand both packages
the same draws. The draws follow JAX's distributions (warp center in
[w, T-w), shift in [-w, w), widths in [lo, hi), starts in [0, D-hi)), not
its bits.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugConfig:
    apply_time_warp: bool = True
    time_warp_window: int = 5
    apply_freq_mask: bool = True
    freq_mask_width_range: tuple[int, int] = (0, 30)
    num_freq_mask: int = 2
    apply_time_mask: bool = True
    time_mask_width_range: tuple[int, int] = (0, 40)
    num_time_mask: int = 2

    @classmethod
    def from_dict(cls, d: dict | None) -> "SpecAugConfig":
        if not d:
            return cls()
        d = dict(d)
        d.pop("time_warp_mode", None)  # always the linear-index warp here
        for k in ("freq_mask_width_range", "time_mask_width_range"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


@dataclasses.dataclass
class SpecAugDraws:
    """Per-utterance random numbers of one SpecAug call (None: step off).

    warp_center, warp_to: (B,) source center and where it moves to;
    freq_*/time_*: (B, num_mask) mask widths and starts."""

    warp_center: torch.Tensor | None = None
    warp_to: torch.Tensor | None = None
    freq_widths: torch.Tensor | None = None
    freq_starts: torch.Tensor | None = None
    time_widths: torch.Tensor | None = None
    time_starts: torch.Tensor | None = None


def _randint(g: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=g, device=g.device)


def draw_specaug(generator: torch.Generator, b: int, t: int, n_mels: int,
                 cfg: SpecAugConfig) -> SpecAugDraws:
    """Draw the random numbers of SpecAug on (b, t, n_mels) features."""
    d = SpecAugDraws()
    w = cfg.time_warp_window
    if cfg.apply_time_warp and t - w > w:
        d.warp_center = _randint(generator, w, t - w, (b,))
        d.warp_to = d.warp_center + _randint(generator, -w, w, (b,)) + 1
    for name, on, (lo, hi), n, size in (
        ("freq", cfg.apply_freq_mask, cfg.freq_mask_width_range, cfg.num_freq_mask,
         n_mels),
        ("time", cfg.apply_time_mask, cfg.time_mask_width_range, cfg.num_time_mask, t),
    ):
        if on:
            setattr(d, f"{name}_widths", _randint(generator, lo, max(hi, 1), (b, n)))
            setattr(d, f"{name}_starts",
                    _randint(generator, 0, max(1, size - hi), (b, n)))
    return d


def time_warp(spec: torch.Tensor, center: torch.Tensor, warped: torch.Tensor
              ) -> torch.Tensor:
    """Piecewise-linear warp (JAX `_time_warp` :70-97): output frame
    `warped` reads source frame `center`; [0, w] maps onto [0, c] and
    [w, T-1] onto [c, T-1], linearly interpolated between frames."""
    b, t, _ = spec.shape
    c = center.to(spec.device, torch.float32)[:, None]
    w = warped.to(spec.device, torch.float32)[:, None]
    out_pos = torch.arange(t, dtype=torch.float32, device=spec.device)[None, :]
    src = torch.where(
        out_pos < w,
        out_pos * c / torch.clamp(w, min=1.0),
        c + (out_pos - w) * (t - 1 - c) / torch.clamp(t - 1 - w, min=1.0),
    ).clamp(0.0, t - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    frac = (src - lo.float())[..., None]
    rows = torch.arange(b, device=spec.device)[:, None]
    return (spec[rows, lo] * (1.0 - frac) + spec[rows, hi] * frac).to(spec.dtype)


def mask_along_axis(spec: torch.Tensor, axis: int, widths: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
    """Zero the spans [start, start + width) along `axis` (1 = time,
    2 = freq), per utterance (JAX `_mask_along_axis` :48-67)."""
    size = spec.shape[axis]
    aran = torch.arange(size, device=spec.device)[None, None, :]
    widths = widths.to(spec.device)[..., None]
    starts = starts.to(spec.device)[..., None]
    mask = ((starts <= aran) & (aran < starts + widths)).any(dim=1)  # (B, size)
    shape = [spec.shape[0], 1, 1]
    shape[axis] = size
    return spec * (~mask).to(spec.dtype).reshape(shape)


def apply_specaug(spec: torch.Tensor, draws: SpecAugDraws) -> torch.Tensor:
    """SpecAug (`specaug` :100-121) on (B, T, n_mels) features with the
    given draws: warp, then freq masks (axis 2), then time masks (axis 1)."""
    if draws.warp_center is not None:
        spec = time_warp(spec, draws.warp_center, draws.warp_to)
    if draws.freq_widths is not None:
        spec = mask_along_axis(spec, 2, draws.freq_widths, draws.freq_starts)
    if draws.time_widths is not None:
        spec = mask_along_axis(spec, 1, draws.time_widths, draws.time_starts)
    return spec


def specaug(generator: torch.Generator, spec: torch.Tensor,
            cfg: SpecAugConfig = SpecAugConfig(),
            rows: tuple[int, int, int] | None = None) -> torch.Tensor:
    """SpecAug of `spec` (B, T, n_mels). `rows` (start, stop, global B):
    `spec` holds rows start:stop of a global batch (one data rank's block),
    so the draws are made for the global batch, as JAX draws them, and
    this block's are applied; the generator then advances as one
    process's would."""
    b, t, f = spec.shape
    if rows is None:
        return apply_specaug(spec, draw_specaug(generator, b, t, f, cfg))
    start, stop, global_b = rows
    draws = draw_specaug(generator, global_b, t, f, cfg)
    for field in dataclasses.fields(draws):
        v = getattr(draws, field.name)
        if v is not None:
            setattr(draws, field.name, v[start:stop])
    return apply_specaug(spec, draws)

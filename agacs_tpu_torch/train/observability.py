"""Observability sinks (counterpart of `agacs_tpu/train/observability.py`):
TensorBoard event files, matplotlib training curves, per-epoch
attention-map plots, and a wandb-compatible metrics exporter.

The reference emits per-epoch metrics to TensorBoard
(`espnet2/train/trainer.py:254-265`), matplotlib curves
(`reporter.matplotlib_plot`), attention-map PNGs (`trainer.py:802+`,
`--num_att_plot`) and wandb incl. model artifacts
(`trainer.py:397-415`). This module provides the same sinks without the
tensorboard or wandb packages: the event-file format (TFRecord framing
with masked CRC-32C + a hand-rolled minimal protobuf encoding of
Event/Summary) is written directly, by JAX's writer and reader line for
line, and `WandbSink` writes JAX's offline `metrics.jsonl` + artifact
manifest. `plot_attention_epoch` runs this package's model. Without
matplotlib the two plot functions raise ImportError, which the train CLI
turns into one log line.
"""

from __future__ import annotations

import os
import struct
import time


# --------------------------------------------------------- crc32c (Castagnoli)

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- minimal protobuf encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag = field 1 (string), simple_value = field 2 (float)
    return _pb_bytes(1, tag.encode()) + _pb_float(2, value)


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           values: list[tuple[str, float]] | None = None) -> bytes:
    # Event: wall_time=1 (double), step=2 (int64), file_version=3 (string),
    # summary=5 (message)
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_varint(2, step)
    if file_version is not None:
        out += _pb_bytes(3, file_version.encode())
    if values:
        # Summary: repeated Value value = 1 (each Value length-delimited)
        summary = b"".join(
            _pb_bytes(1, _summary_value(t, v)) for t, v in values
        )
        out += _pb_bytes(5, summary)
    return out


class TensorboardWriter:
    """Scalar-only TensorBoard event writer (tfevents TFRecord format)."""

    def __init__(self, logdir: str, suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.agacs{suffix}"
        self._f = open(os.path.join(logdir, fname), "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        vals = [(k, float(v)) for k, v in scalars.items()]
        self._write(_event(time.time(), step=step, values=vals))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_event_file(path: str) -> list[dict]:
    """Parse a scalar event file back (verification / tooling). Returns
    [{step, wall_time, values: {tag: value}}] — checks the masked CRCs."""
    events = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header CRC mismatch"
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(data), "data CRC mismatch"
            events.append(_parse_event(data))
    return events


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = data[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return v, i
        shift += 7


def _parse_fields(data: bytes):
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v = struct.unpack("<d", data[i : i + 8])[0]
            i += 8
        elif wire == 5:
            v = struct.unpack("<f", data[i : i + 4])[0]
            i += 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            v = data[i : i + n]
            i += n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(data: bytes) -> dict:
    out = {"step": 0, "wall_time": 0.0, "values": {}}
    for field, wire, v in _parse_fields(data):
        if field == 1 and wire == 1:
            out["wall_time"] = v
        elif field == 2 and wire == 0:
            out["step"] = v
        elif field == 5 and wire == 2:
            tag, val = None, None
            for vf, vw, vv in _parse_fields(v):  # Summary.Value fields
                if vf == 1 and vw == 2:
                    for f2, w2, v2 in _parse_fields(vv):
                        if f2 == 1 and w2 == 2:
                            tag = v2.decode()
                        elif f2 == 2 and w2 == 5:
                            val = v2
                    if tag is not None and val is not None:
                        out["values"][tag] = val
                        tag = val = None
    return out


# --------------------------------------------------------- matplotlib curves

class WandbSink:
    """The reference's wandb sink (`espnet2/train/trainer.py:397-415`):
    per-epoch metric dict + model-file artifacts, as JAX's offline form:
    one `{"epoch": N, "<phase>/<metric>": v, ...}` object per epoch in
    `<exp_dir>/metrics.jsonl` plus an `artifacts.json` manifest for
    `log_artifact` calls, in wandb's flat `phase/metric` key convention so
    they can be replayed into a real run (`wandb.log(json.loads(line))`).
    JAX's sink also logs to wandb when the package imports; the port never
    contacts the service."""

    def __init__(self, exp_dir: str):
        self.exp_dir = exp_dir
        os.makedirs(exp_dir, exist_ok=True)
        self._jsonl = os.path.join(exp_dir, "metrics.jsonl")
        self._manifest = os.path.join(exp_dir, "artifacts.json")

    def log_epoch(self, epoch: int, history_epoch: dict) -> None:
        """history_epoch: {"train": {...}, "valid": {...}} for one epoch."""
        import json

        flat = {"epoch": epoch}
        for phase, metrics in history_epoch.items():
            for k, v in metrics.items():
                flat[f"{phase}/{k}"] = float(v)
        with open(self._jsonl, "a") as f:
            f.write(json.dumps(flat) + "\n")

    def log_artifact(self, path: str, kind: str = "model") -> None:
        """Register a produced file (checkpoint, averaged params) — the
        reference uploads these as wandb artifacts (trainer.py:406-414)."""
        import json

        entry = {"path": os.path.abspath(path), "kind": kind,
                 "logged_at": time.time()}
        manifest = []
        if os.path.exists(self._manifest):
            with open(self._manifest) as f:
                manifest = json.load(f)
        manifest.append(entry)
        with open(self._manifest, "w") as f:
            json.dump(manifest, f, indent=1)


def plot_history(history: dict, out_dir: str) -> list[str]:
    """Per-metric PNG curves over epochs, train/valid lines together
    (reporter.matplotlib_plot). history: {epoch: {phase: {metric: v}}}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    epochs = sorted(history)
    metrics = sorted({
        m for ep in epochs for ph in history[ep] for m in history[ep][ph]
        if not m.endswith("_time")
    })
    written = []
    for m in metrics:
        fig, ax = plt.subplots(figsize=(5, 3.2))
        any_line = False
        for phase in ("train", "valid"):
            xs = [e for e in epochs if m in history[e].get(phase, {})]
            if not xs:
                continue
            ax.plot(xs, [history[e][phase][m] for e in xs],
                    marker="o", markersize=3, label=phase)
            any_line = True
        if not any_line:
            plt.close(fig)
            continue
        ax.set_xlabel("epoch")
        ax.set_ylabel(m)
        ax.grid(alpha=0.3)
        ax.legend()
        fig.tight_layout()
        path = os.path.join(out_dir, f"{m}.png")
        fig.savefig(path, dpi=110)
        plt.close(fig)
        written.append(path)
    return written


# ------------------------------------------------- per-epoch attention plots

def plot_attention_epoch(model, cfg, dataset, utt_ids, out_dir: str, epoch: int
                         ) -> list[str]:
    """Attention-map PNGs for fixed utterances each eval epoch
    (trainer.py:802+ plot_attention / --num_att_plot): decoder
    self-attention probabilities per layer x head under teacher forcing
    (`whisper_decode(collect_full_maps=True)`, on the model's device)."""
    import numpy as np
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from agacs_tpu_torch.models.asr_model import encode
    from agacs_tpu_torch.models.whisper import whisper_decode
    from agacs_tpu_torch.train.losses import add_sos_eos

    dev = next(model.parameters()).device
    written = []
    for utt in utt_ids:
        item = dataset[utt]
        with torch.no_grad():
            speech = torch.from_numpy(np.asarray(item["speech"], np.float32)[None]).to(dev)
            lens = torch.tensor([len(item["speech"])], device=dev)
            enc, _ = encode(model, cfg, speech, lens, train=False)
            ys = torch.from_numpy(item["text"][None].astype(np.int64)).to(dev)
            ys_in, _ = add_sos_eos(ys, cfg.sos, cfg.eos, cfg.ignore_id)
            _, aux = whisper_decode(model, ys_in, enc, src_layer=0, collect_full_maps=True)
        maps = aux["maps"].float().cpu().numpy()  # (L, 1, h, T, T)
        probs = np.exp(maps - maps.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        n_l, _, n_h = probs.shape[:3]
        fig, axes = plt.subplots(
            n_l, n_h, figsize=(1.4 * n_h, 1.4 * n_l), squeeze=False
        )
        for li in range(n_l):
            for hi in range(n_h):
                ax = axes[li][hi]
                ax.imshow(probs[li, 0, hi], cmap="viridis", aspect="auto")
                ax.set_xticks([])
                ax.set_yticks([])
                if hi == 0:
                    ax.set_ylabel(f"L{li}", fontsize=7)
        fig.suptitle(f"{utt} (epoch {epoch})", fontsize=8)
        fig.tight_layout()
        d = os.path.join(out_dir, "att_ws", utt)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"ep{epoch}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    return written

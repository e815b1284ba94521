"""Tensor parallelism of the whisper family over the mesh's "model" axis.

JAX shards parameters by its rule table (`parallel/mesh.py
param_sharding_rules`) and GSPMD inserts the collectives. Here
`shard_whisper` cuts each parameter the table names to this rank's slice
(its JAX path from `models/checkpoint.jax_leaf`, the table's dim moved to
nn.Linear's (out, in) layout by `port_dim`), and the modules close each
column / row pair with explicit collectives, Megatron's pair of
operators:

  copy_in     identity forward, all-reduce of the gradient over "model"
              (a replicated input entering rank-local work);
  reduce_out  all-reduce forward, identity backward (the partial sums of
              a row-parallel product);
  gather_last all-gather of the last dim forward, this rank's slice back.

  attention   q / k / v (and query_cs / key_cs) column-parallel, the
              heads local (K1 on the card runs on the rank's own heads),
              `out` row-parallel;
  MLP         fc1 column-, fc2 row-parallel;
  adapters    down column-, up row-parallel;
  conv stem   conv1 column- (out channels), conv2 row-parallel (in);
  side ladder the downsamples column-parallel and gathered (their
              outputs feed the ladder's replicated stream), the upsample
              row-parallel on its rank's slice of the input;
  token_emb   vocabulary-sharded after `pad_vocab_rows`: the lookup masks
              the other ranks' rows and all-reduces; the tied logits are
              gathered and cut back to n_vocab.

A replicated tensor that enters per-head work (the PE gate, the CS loss's
learnable c_val) goes through copy_in, so its gradient is summed over the
heads of every rank. A group whose parameters the table does not all
shard, or whose heads the model axis does not divide, stays replicated
with a logging.warning, as JAX drops a rule (its numbers are the same
either way).

The int8 trunk follows what JAX's `shard_summary` reports after
`quantize_frozen_linears` runs on sharded weights: `w_q` is sharded as
its `w` is, `w_s` with a column-parallel bias and whole for a
row-parallel linear. The weights are quantised whole before they are cut,
and the row scales a sharded activation needs are the maxima over every
rank (an all-reduce of the local maxima): x's in a row-parallel forward,
dy·w_s's in a column-parallel dgrad (the fused q/k/v dgrad included). So
the int8 numbers are the unsharded ones up to the order of the partial
sums, which now and then moves a row-quantised value of the next layer
across a rounding edge (one int8 step). Under tensor parallelism the int8 MLP runs its two linears apart (K8
each, with the exchange), not the fused K2, whose hidden row scale would
need the exchange inside the kernel; that rounds the hidden to the compute
dtype between them.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from agacs_tpu_torch.models.checkpoint import jax_leaf
from agacs_tpu_torch.models.whisper import _as
from agacs_tpu_torch.ops.int8_linear import _dgrad, _matmul, _scale, int8_gemm
from agacs_tpu_torch.parallel.mesh import Parallel, pad_vocab_rows, param_sharding_rules


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.size = rank, size
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, -1)[ctx.rank].contiguous(), None, None, None


def _quant_by(v: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`row_quant_ref` of v with the row maxima `amax` given (the maxima
    over every rank's columns)."""
    s = _scale(amax)
    return torch.round(v / s).to(torch.int8), s


class _Int8Row(torch.autograd.Function):
    """A row-parallel int8 product's partial sum: x's columns are this
    rank's slice, its row scale the maximum over every rank's slice."""

    @staticmethod
    def forward(ctx, x2, w_q, w_s, w_t, group):
        ctx.save_for_backward(w_q, w_s)
        ctx.x_dtype = x2.dtype
        v = x2.float()
        amax = v.abs().amax(-1, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, s = _quant_by(v, amax)
        return int8_gemm(q, s, w_q, w_s, out_dtype=x2.dtype,
                         w_t=w_t() if w_t is not None and q.is_cuda else None)

    @staticmethod
    def backward(ctx, g):
        w_q, w_s = ctx.saved_tensors
        return _dgrad(g.contiguous(), w_q, w_s, ctx.x_dtype), None, None, None, None


class _Int8Col(torch.autograd.Function):
    """A column-parallel int8 product (x whole, this rank's output
    columns); its dgrad's row scale is the maximum over every rank's
    columns of dy·w_s, and its dx a partial sum that `copy_in` adds up."""

    @staticmethod
    def forward(ctx, x2, w_q, w_s, w_t, group):
        ctx.save_for_backward(w_q, w_s)
        ctx.x_dtype, ctx.group = x2.dtype, group
        return _matmul(x2, w_q, w_s, w_t)

    @staticmethod
    def backward(ctx, g):
        w_q, w_s = ctx.saved_tensors
        v = g.contiguous().float() * w_s
        amax = v.abs().amax(-1, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=ctx.group)
        q, s = _quant_by(v, amax)
        return int8_gemm(q, s, w_q, dgrad=True, out_dtype=ctx.x_dtype), None, None, None, None


class TensorParallel:
    """This rank's place on the "model" axis and the collectives the
    sharded modules call (`models/whisper.py` reads it as `module.tp`)."""

    def __init__(self, par: Parallel):
        self.group = par.group("model")
        self.rank, self.size = par.model_rank, par.n_model

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.group)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(x, self.group, self.rank, self.size)

    def scatter_last(self, x: torch.Tensor) -> torch.Tensor:
        return self.copy_in(x).chunk(self.size, -1)[self.rank]

    def heads(self, n_head: int) -> slice:
        """This rank's heads of `n_head` (the whole count)."""
        per = n_head // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def int8_col(self, x: torch.Tensor, w_q, w_s, w_t=None) -> torch.Tensor:
        """x (..., d_in) whole, w_q (d_in, this rank's columns)."""
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and x.requires_grad:
            y = _Int8Col.apply(x2, w_q, w_s, w_t, self.group)
        else:
            y = _matmul(x2, w_q, w_s, w_t)
        return y.reshape(*x.shape[:-1], w_q.shape[1])

    def col(self, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel linear on an input that went through copy_in."""
        if hasattr(lin, "weight_q"):
            y = self.int8_col(x, lin.weight_q, lin.weight_s, lin.weight_t)
            return y if lin.bias is None else y + lin.bias.to(y.dtype)
        return lin(x)

    def row(self, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel linear on this rank's slice of its input: the
        partial product all-reduced, then the (whole) bias."""
        if hasattr(lin, "weight_q"):
            x2 = x.reshape(-1, x.shape[-1])
            y = _Int8Row.apply(x2, lin.weight_q, lin.weight_s, lin.weight_t, self.group)
            y = y.reshape(*x.shape[:-1], lin.weight_q.shape[1])
        else:
            y = F.linear(x, _as(lin.weight, x.dtype))
        y = self.reduce_out(y)
        return y if lin.bias is None else y + _as(lin.bias, y.dtype)

    def row_conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        y = self.reduce_out(conv._conv_forward(x, _as(conv.weight, x.dtype), None))
        return y + _as(conv.bias, y.dtype)[:, None]

    def col_gather(self, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel linear whose output feeds replicated work."""
        return self.gather_last(lin(self.copy_in(x)))

    def row_scatter(self, lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel linear on a replicated input."""
        return self.row(lin, self.scatter_last(x))

    def vocab_embed(self, weight: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of a vocabulary-sharded table: this rank's rows looked up,
        the others' zero, summed over the ranks."""
        lo = self.rank * weight.shape[0]
        mine = (tokens >= lo) & (tokens < lo + weight.shape[0])
        e = F.embedding(torch.where(mine, tokens - lo, 0), weight)
        return self.reduce_out(e * mine[..., None].to(e.dtype))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _jax_shape(layout: str, layer: int | None, shape: tuple) -> tuple:
    if layout == "linear":
        shape = shape[::-1]
    elif layout == "conv":  # (out, in, k) -> (k, in, out)
        shape = (shape[2], shape[1], shape[0])
    return shape if layer is None else (1, *shape)


def port_dim(name: str, shape: tuple) -> int | None:
    """The dim of the port tensor `name` (of port shape `shape`) that JAX's
    rule table shards over "model", or None. `weight_q` (JAX's (in, out)
    layout) follows its `w` rule; `weight_s` is sharded with a
    column-parallel linear and whole with a row-parallel one."""
    if name.endswith(".weight_s"):
        d = port_dim(name[: -1] + "q", (1, shape[0]))
        return 0 if d == 1 else None
    key, layer, layout = jax_leaf(name)
    path = key.replace("/", ".")
    if name.endswith(".weight_q"):
        path, layout = path[: -len("w_q")] + "w", "plain"
    spec = param_sharding_rules(path, _jax_shape(layout, layer, tuple(shape)))
    if "model" not in spec:
        return None
    d = spec.index("model") - (layer is not None)
    nd = len(shape)
    if layout == "linear":
        d = nd - 1 - d
    elif layout == "conv":
        d = {0: 2, 1: 1, 2: 0}[d]
    return d


def _tensors(model: nn.Module) -> dict[str, torch.Tensor]:
    """Parameters and the int8 trunk's buffers, by state-dict name."""
    out = dict(model.named_parameters())
    out.update({n: b for n, b in model.named_buffers()
                if n.endswith((".weight_q", ".weight_s"))})
    return out


def placed_leaves(model: nn.Module):
    """(dotted JAX path, sharded over "model") of every parameter and int8
    buffer of `model`, in state-dict order."""
    dims = getattr(model, "tp_dims", {})
    for name in _tensors(model):
        yield jax_leaf(name)[0].replace("/", "."), name in dims


def _cut(model: nn.Module, tensors: dict, name: str, dim: int, tp: TensorParallel) -> None:
    t = tensors[name]
    if t.shape[dim] % tp.size:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not divide {tp.size}")
    per = t.shape[dim] // tp.size
    local = t.data.narrow(dim, tp.rank * per, per).clone()
    if isinstance(t, nn.Parameter):
        t.data = local
    else:
        mod_name, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod_name), leaf, local)
    model.tp_dims[name] = dim


def _group(model, tensors, prefix, leaves, tp, expect) -> bool:
    """Shard the named leaves of one column / row group when the table
    shards each of them on the dim `expect` gives it (and it divides);
    else leave the group whole with a warning."""
    names = [f"{prefix}.{leaf}" for leaf in leaves if f"{prefix}.{leaf}" in tensors]
    dims = {n: port_dim(n, tuple(tensors[n].shape)) for n in names}
    ok = all(dims[n] == expect(n) and tensors[n].shape[dims[n]] % tp.size == 0
             if expect(n) is not None else dims[n] is None for n in names)
    if not ok:
        logging.warning("shard_params: tensor-parallel rules dropped for %s %s (a dim "
                        "not divisible by the model axis %d) — the group is REPLICATED",
                        prefix, {n: tuple(tensors[n].shape) for n in names}, tp.size)
        return False
    for n in names:
        if expect(n) is not None:
            _cut(model, tensors, n, dims[n], tp)
    return True


def _linear_dims(kind: str):
    """The port dim of each leaf of a column ("col") or row ("row") linear
    (nn.Linear (out, in); int8 w_q (in, out))."""
    def expect(name: str):
        if name.endswith(".weight_q"):
            return 1 if kind == "col" else 0
        if name.endswith(".weight_s"):
            return 0 if kind == "col" else None
        if name.endswith(".bias"):
            return 0 if kind == "col" else None
        return 0 if kind == "col" else 1
    return expect


_LIN = (".weight", ".bias", ".weight_q", ".weight_s")


def _leaves(*mods: str) -> list[str]:
    return [m + s for m in mods for s in _LIN]


def shard_whisper(model: nn.Module, par: Parallel) -> nn.Module:
    """Cut a whisper `Model`'s parameters to this rank's slices and mark
    its modules (`tp`) to run the collectives. The model must be whole
    (int8 trunk quantised already); no optimizer may hold its parameters
    yet. Sets `model.tp_dims` {state-dict name: sharded dim}."""
    from agacs_tpu_torch.models.whisper import (
        MLP, Adapter, MultiHeadAttention, Whisper, WhisperDecoder, WhisperEncoder, _Side)

    if not isinstance(model, Whisper):
        logging.warning("shard_params: JAX's tensor-parallel rules name no parameter of "
                        "%s — every parameter is REPLICATED", type(model).__name__)
        return model
    tp = TensorParallel(par)
    model.tp_dims = {}
    tensors = _tensors(model)
    col, row = _linear_dims("col"), _linear_dims("row")
    for prefix, mod in list(model.named_modules()):
        if isinstance(mod, MultiHeadAttention):
            cols = ["query", "key", "value"] + (["query_cs", "key_cs"] if mod.pe else [])

            def expect(n, cols=cols, prefix=prefix):
                sub = n[len(prefix) + 1:].split(".")[0]
                return (col if sub in cols else row)(n)

            if mod.n_head % tp.size == 0 and _group(
                    model, tensors, prefix, _leaves(*cols, "out"), tp, expect):
                mod.tp, mod.n_head = tp, mod.n_head // tp.size
                mod.head_slice = tp.heads(mod.n_head * tp.size)
        elif isinstance(mod, MLP):
            if _group(model, tensors, prefix, _leaves("0", "2"), tp,
                      lambda n, p=prefix: (col if n.startswith(p + ".0.") else row)(n)):
                mod.tp = tp
        elif isinstance(mod, Adapter):
            if _group(model, tensors, prefix, _leaves("model.0", "model.2"), tp,
                      lambda n, p=prefix: (col if n.startswith(p + ".model.0.") else row)(n)):
                mod.tp = tp
        elif isinstance(mod, WhisperEncoder):
            if _group(model, tensors, prefix, ["conv1.weight", "conv1.bias", "conv2.weight",
                                               "conv2.bias"], tp,
                      lambda n: {"conv1.weight": 0, "conv1.bias": 0,
                                 "conv2.weight": 1}.get(n.split(".", 1)[1])):
                mod.tp = tp
        elif isinstance(mod, _Side):
            downs = ["downsample_input"] + [f"downsample_layers.{i}"
                                            for i in range(len(mod.downsample_layers))]
            if hasattr(mod, "downsample_encoder_input"):
                downs.append("downsample_encoder_input")
            ok = _group(model, tensors, prefix, _leaves(*downs), tp, col)
            ok = _group(model, tensors, prefix, _leaves("upsample_output"), tp, row) and ok
            if ok:
                mod.tp = tp
            elif any(n.startswith(prefix + ".") for n in model.tp_dims):
                raise ValueError(f"{prefix}: its downsamples and upsample must shard together")
        elif isinstance(mod, WhisperDecoder):
            name = f"{prefix}.token_embedding.weight"
            w = tensors[name]
            w.data = pad_vocab_rows(w.data, tp.size)
            _cut(model, tensors, name, 0, tp)
            mod.tp = tp
    model.tp = tp
    return model


def localize(model: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor `name` (a checkpoint's or an
    optimizer moment's); the tensor itself where `name` is not sharded."""
    dim = getattr(model, "tp_dims", {}).get(name)
    if dim is None:
        return full
    tp = model.tp
    if name.endswith("token_embedding.weight"):
        full = pad_vocab_rows(full, tp.size)
    return full.chunk(tp.size, dim)[tp.rank].contiguous()


def gather_full(model: nn.Module, name: str, local: torch.Tensor) -> torch.Tensor:
    """The whole tensor `name` from every model rank's slice (the vocabulary
    padding cut off); `local` itself where `name` is not sharded. A
    collective: every model rank calls it in the same order."""
    dim = getattr(model, "tp_dims", {}).get(name)
    if dim is None:
        return local
    tp = model.tp
    parts = [torch.empty_like(local) for _ in range(tp.size)]
    dist.all_gather(parts, local.contiguous(), group=tp.group)
    full = torch.cat(parts, dim)
    if name.endswith("token_embedding.weight"):
        full = full[: model.cfg.n_vocab]
    return full


def gather_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The whole model's state dict (every sharded tensor gathered)."""
    return {n: gather_full(model, n, t) for n, t in model.state_dict().items()}

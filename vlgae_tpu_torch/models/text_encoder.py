"""Text encoders (counterpart of vlgae_tpu/models/text_encoder.py):
the ``MLPEncoder`` of ``exp=vlgae``, the BiLSTM ``RNNEncoder`` of
``exp=lang_only``, the dropout-only ``BlankEncoder`` (any other encoder
``_target_``) and the ``MultiEncoder`` that joins named sub-encoders."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .nn import Dropping, ScalarMix, shared_dropout, shared_keep_shape


class MLPEncoder(Dropping):
    """Linear encoder; in training, element-wise dropout then shared
    dropout (one mask per (row, feature), shared along the sequence)."""

    def __init__(self, n_in: int, n_hidden: int, dropout: float = 0.0,
                 shared_dropout: float = 0.0):
        super().__init__()
        self.linear = nn.Linear(n_in, n_hidden)
        self.n_hidden = n_hidden
        self.dropout = dropout
        self.shared_dropout = shared_dropout

    def get_dim(self, field: str = "x") -> int:
        return self.n_hidden

    def forward(self, emb, mask):
        x = self.linear(emb)
        if self.active(self.dropout):
            x = x * self.keep_mask(x.shape, self.dropout, x) / (1 - self.dropout)
        if self.active(self.shared_dropout):
            p = self.shared_dropout
            x = shared_dropout(x, p, self.keep_mask(shared_keep_shape(x), p, x))
        return {"x": x}


class BlankEncoder(Dropping):
    """The embedding passed through, with element-wise dropout in
    training."""

    def __init__(self, n_in: int, dropout: float = 0.0):
        super().__init__()
        self.n_hidden = n_in
        self.dropout = dropout

    def get_dim(self, field: str = "x") -> int:
        return self.n_hidden

    def forward(self, emb, mask):
        x = emb
        if self.active(self.dropout):
            x = x * self.keep_mask(x.shape, self.dropout, x) / (1 - self.dropout)
        return {"x": x}


class MultiEncoder(nn.Module):
    """Named sub-encoders over the same embedding, and a field mapping:
    each output field is the concatenation of ``<encoder>.<field>``
    sources. The sub-encoders sit under flax's names for them
    (``encoders_<i>_1``, ``i`` their position), so their parameters carry
    over from the JAX package by name."""

    def __init__(self, encoders: Sequence[Tuple[str, nn.Module]],
                 mapping: Sequence[Tuple[str, Sequence[str]]]):
        super().__init__()
        self.names = {}
        for i, (name, enc) in enumerate(encoders):
            self.add_module(f"encoders_{i}_1", enc)
            self.names[name] = f"encoders_{i}_1"
        self.mapping = tuple((field, tuple(src)) for field, src in mapping)

    def encoder(self, name: str) -> nn.Module:
        return getattr(self, self.names[name])

    def get_dim(self, field: str = "x") -> int:
        for out_field, sources in self.mapping:
            if out_field == field:
                return sum(self.encoder(src.split(".")[0]).get_dim(src.split(".")[1])
                           for src in sources)
        raise KeyError(field)

    def forward(self, emb, mask):
        outs = {name: self.encoder(name)(emb, mask) for name in self.names}
        result = {}
        for out_field, sources in self.mapping:
            parts = [outs[e][f] for e, f in (src.split(".") for src in sources)]
            result[out_field] = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
        return result


class _Gates(nn.Module):
    """The eight gate projections of flax's ``OptimizedLSTMCell``, under its
    names: ``ii/if/ig/io`` act on the input (no bias), ``hi/hf/hg/ho`` on
    the hidden state (with bias). Gate order i, f, g, o."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        for g in "ifgo":
            self.add_module(f"i{g}", nn.Linear(n_in, hidden, bias=False))
            self.add_module(f"h{g}", nn.Linear(hidden, hidden))

    def stacked(self):
        """``(W_x [4H, n_in], W_h [4H, H], b [4H])`` in gate order."""
        w_x = torch.cat([getattr(self, f"i{g}").weight for g in "ifgo"])
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in "ifgo"])
        b = torch.cat([getattr(self, f"h{g}").bias for g in "ifgo"])
        return w_x, w_h, b


class _Cell(nn.Module):
    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.OptimizedLSTMCell_0 = _Gates(n_in, hidden)


class _LSTMLayer(Dropping):
    """One direction of one layer, with variational recurrent dropout: one
    keep mask per (sentence, unit), scaled by ``1 / (1 - p)``, multiplies
    ``h`` on its way into the cell at every step. A padded step carries the
    (unmasked) state over and emits zeros. The reverse direction runs over
    the flipped padded sequence, so its padding comes first and the zero
    state passes through it. The input projection of all steps is one
    product; the recurrence is a step loop (a library LSTM cannot mask ``h``
    per step)."""

    def __init__(self, n_in: int, hidden: int, reverse: bool = False,
                 recurrent_dropout: float = 0.0):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        self.recurrent_dropout = recurrent_dropout
        self.cell = _Cell(n_in, hidden)

    def forward(self, x, mask):
        B, L, _ = x.shape
        H = self.hidden
        p = self.recurrent_dropout
        hmask = None
        if self.active(p):
            hmask = self.keep_mask((B, H), p, x) / (1 - p)
        w_x, w_h, b = self.cell.OptimizedLSTMCell_0.stacked()
        xs = F.linear(x, w_x)  # [B, L, 4H]
        c = x.new_zeros(B, H)
        h = x.new_zeros(B, H)
        ys = [None] * L
        order = range(L - 1, -1, -1) if self.reverse else range(L)
        for t in order:
            z = xs[:, t] + F.linear(h if hmask is None else h * hmask, w_h, b)
            i, f, g, o = z.chunk(4, -1)
            nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            nh = torch.sigmoid(o) * torch.tanh(nc)
            keep = mask[:, t, None]
            c = torch.where(keep, nc, c)
            h = torch.where(keep, nh, h)
            ys[t] = torch.where(keep, nh, 0.0)
        return torch.stack(ys, 1)


class RNNEncoder(Dropping):
    """BiLSTM encoder with variational dropout (``exp=lang_only``).

    Returns ``x`` and ``hiddens [2, B, H]``: of the last layer, the forward
    direction's output at each sentence's last word and the backward
    direction's at position 0. ``x`` is the chosen layer's ``[fwd, bwd]``
    outputs (``output_layers=-2``: every layer's, concatenated, or with
    ``mix`` their ``ScalarMix``), then projected to ``reproject_out`` and
    joined by the raw embedding (``cat_emb``). ``reproject_emb`` projects
    the embedding before the first layer. In training: element-wise then
    shared dropout on the input, shared dropout (``lstm_dropout``) between
    layers below the top one, and element-wise then shared dropout on the
    output before its projection.

    The two projections are dense layers that flax names ``Dense_0``,
    ``Dense_1`` in the order they are made (``Dense_0`` is the port's
    ``linear``): ``reproject_emb`` first when both are set. ``proj_size``
    raises, as in vlgae_tpu."""

    def __init__(self, n_in: int, hidden_size: int = 200, num_layers: int = 2,
                 reproject_emb: int = 0, reproject_out: int = 0, mix: bool = False,
                 pre_shared_dropout: float = 0.0, pre_dropout: float = 0.0,
                 post_shared_dropout: float = 0.0, post_dropout: float = 0.0,
                 lstm_dropout: float = 0.33, shared_dropout_flag: bool = True,
                 output_layers: int = -1, proj_size: int = 0,
                 init_version: str = "zy", cat_emb: bool = False):
        super().__init__()
        if proj_size:
            raise NotImplementedError("proj_size > 0 is not supported")
        if init_version not in ("zy", "biased"):
            raise ValueError(f"unknown init_version: {init_version!r}")
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.pre_shared_dropout = pre_shared_dropout
        self.pre_dropout = pre_dropout
        self.post_shared_dropout = post_shared_dropout
        self.post_dropout = post_dropout
        self.lstm_dropout = lstm_dropout
        self.output_layers = output_layers
        self.mix = mix
        self.cat_emb = cat_emb
        self.init_version = init_version
        dense = iter(("linear", "Dense_1"))
        self.emb_proj = self.out_proj = None
        if reproject_emb:
            self.emb_proj = next(dense)
            self.add_module(self.emb_proj, nn.Linear(n_in, reproject_emb))
        rec = lstm_dropout if shared_dropout_flag else 0.0
        d_in = reproject_emb or n_in
        for i in range(num_layers):
            d = d_in if i == 0 else 2 * hidden_size
            self.add_module(f"fwd_{i}", _LSTMLayer(d, hidden_size, False, rec))
            self.add_module(f"bwd_{i}", _LSTMLayer(d, hidden_size, True, rec))
        n_out = 2 * hidden_size
        if output_layers == -2:
            if mix:
                self.ScalarMix_0 = ScalarMix(num_layers)
            else:
                n_out *= num_layers
        if reproject_out:
            self.out_proj = next(dense)
            self.add_module(self.out_proj, nn.Linear(n_out, reproject_out))
            n_out = reproject_out
        self._n_out = n_out + (n_in if cat_emb else 0)

    @property
    def n_hidden(self) -> int:
        """The width of ``x``."""
        return self._n_out

    def get_dim(self, field: str = "x") -> int:
        return self.n_hidden

    @property
    def hx_size(self) -> int:
        """The width of the ``hx`` context (both directions' final states)."""
        return 2 * self.hidden_size

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        """``init_version``: ``zy`` orthogonal kernels and zero biases;
        ``biased`` Xavier-uniform kernels, zero biases with the forget gate's
        at 1. The projections and the mix keep the init of
        :func:`~vlgae_tpu_torch.training.pipeline.init_params`."""
        for name, p in self.named_parameters():
            if not name.startswith(("fwd_", "bwd_")):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.fill_(1.0 if self.init_version == "biased"
                        and name.rsplit(".", 2)[-2] == "hf" else 0.0)
            elif self.init_version == "zy":
                rows, cols = p.shape
                a = torch.randn(max(rows, cols), min(rows, cols), generator=generator)
                q, r = torch.linalg.qr(a)
                q = q * torch.sign(torch.diagonal(r))
                p.copy_(q if rows >= cols else q.T)
            else:
                bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def _drop(self, x, p_elem, p_shared):
        if self.active(p_elem):
            x = x * self.keep_mask(x.shape, p_elem, x) / (1 - p_elem)
        if self.active(p_shared):
            x = shared_dropout(x, p_shared,
                               self.keep_mask(shared_keep_shape(x), p_shared, x))
        return x

    def forward(self, emb, mask):
        x = emb
        if self.emb_proj is not None:
            x = getattr(self, self.emb_proj)(x)
        x = self._drop(x, self.pre_dropout, self.pre_shared_dropout)
        layer_outputs = []
        for i in range(self.num_layers):
            fwd = getattr(self, f"fwd_{i}")(x, mask)
            bwd = getattr(self, f"bwd_{i}")(x, mask)
            x = torch.cat([fwd, bwd], -1)
            if i + 1 < self.num_layers:
                x = self._drop(x, 0.0, self.lstm_dropout)
            layer_outputs.append(x)
        idx = torch.clamp_min(mask.sum(-1) - 1, 0)
        h_fwd = fwd[torch.arange(fwd.shape[0], device=fwd.device), idx]
        if self.output_layers != -2:
            out = layer_outputs[self.output_layers]
        elif self.mix:
            out = self.ScalarMix_0(layer_outputs)
        else:
            out = torch.cat(layer_outputs, -1)
        out = self._drop(out, self.post_dropout, self.post_shared_dropout)
        if self.out_proj is not None:
            out = getattr(self, self.out_proj)(out)
        if self.cat_emb:
            out = torch.cat([out, emb], -1)
        return {"x": out, "hiddens": torch.stack([h_fwd, bwd[:, 0]])}

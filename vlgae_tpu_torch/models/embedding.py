"""Composite embeddings: static word and tag items (with their variational
VAE/IB heads), the char-CNN item and the subword BERT item (counterpart of
vlgae_tpu/models/embedding.py), with the independent dropout across items in
training, and the GloVe loader of the word table.

The JAX package runs transformers' ``FlaxBertModule``; the port imports
no ``transformers`` (no package its card is sure to have), so
:class:`Bert` is a small BERT encoder written here
with the same parameter tree (``embeddings``, ``encoder.layer.<k>``):
word + position + token-type embeddings and LayerNorm, then layers of
self-attention and a GELU feed-forward, each closed by a residual
LayerNorm. Flax's conventions are kept: the config's LayerNorm eps (1e-12
by default), exact GELU,
masked keys get the bias ``finfo(f32).min``. Attention is a plain matmul
and softmax. A frozen BERT (``requires_grad: false``, the recipe) runs
under ``torch.no_grad()``, as the JAX package stops its gradient, and its
parameters stay out of the optimizer. Its shape is the JAX package's
fallback (:class:`BertConfig`) or a local directory's ``config.json``
(:func:`encoder_config_from_dir`, read with ``json``: no ``transformers``),
whose ``model_type`` picks the encoder: ``bert`` (or none) the BERT here,
``granitemoehybrid`` the granite-4.0-h stack of
:mod:`.granite_hybrid` (same item, pooling and stride windows).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .granite_hybrid import GraniteConfig, GraniteHybrid
from .nn import Dropping, ScalarMix, independent_dropout, variational_kl


@dataclasses.dataclass(frozen=True)
class EmbeddingItemCfg:
    """One embedding item."""

    name: str
    field: str
    kind: str  # 'static' | 'transformer' | 'char'
    n_vocab: int = 0
    embedding_dim: int = 100
    mode: str = "basic"  # 'basic' | 'vae' | 'ib'
    out_dim: int = 0  # the variational output width
    normalize_method: str = "mean+std"
    normalize_time: str = "nowhere"  # nowhere | begin | epoch | batch
    # transformer-only
    n_layers: int = 1
    n_out: int = 0
    requires_grad: bool = False
    pooling: str = "mean"  # first | last | mean
    stride: int = 256
    layer_dropout: float = 0.0  # ScalarMix layer dropout
    # char-only
    char_dim: int = 50
    kernel_sizes: Tuple[int, ...] = (1, 3, 5)
    filter_nums: Tuple[int, ...] = (20, 30, 40)

    @property
    def embed_size(self) -> int:
        if self.mode != "basic":
            return self.out_dim
        if self.kind == "transformer":
            return self.n_out if self.n_out else self.embedding_dim
        return self.embedding_dim


# transformers' BertConfig defaults, for the fields a config.json leaves out
_HF_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, intermediate_size=3072,
                max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12)
# the values of the fields that change the function, as the port's Bert computes it
_BERT_FIXED = {"model_type": "bert", "hidden_act": "gelu",
               "position_embedding_type": "absolute"}


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The BERT's shape. The defaults are the random-init BERT of
    ``exp=vlgae`` when no local checkpoint directory exists
    (vlgae_tpu/training/factory.py ``_bert_config``)."""

    vocab_size: int = 8192
    hidden_size: int = 128
    num_hidden_layers: int = 2
    num_attention_heads: int = 2
    intermediate_size: int = 256
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_dir(cls, path: str) -> "BertConfig":
        """The shape in ``<path>/config.json`` (a field it leaves out takes
        transformers' default). A value the port's :class:`Bert` does not
        compute (another ``model_type``, ``hidden_act`` or
        ``position_embedding_type``, heads that do not divide the width)
        raises a ``ValueError``."""
        with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
            disk = json.load(f)
        for key, want in _BERT_FIXED.items():
            if disk.get(key, want) != want:
                raise ValueError(f"{path}/config.json: {key}={disk[key]!r}; the port's "
                                 f"Bert computes {key}={want!r} only")
        c = cls(**{k: type(v)(disk.get(k, v)) for k, v in _HF_BERT.items()})
        if c.hidden_size % c.num_attention_heads:
            raise ValueError(f"{path}/config.json: hidden_size {c.hidden_size} is not a "
                             f"multiple of num_attention_heads {c.num_attention_heads}")
        return c


def encoder_config_from_dir(path: str):
    """The text encoder's shape in ``<path>/config.json``: a
    :class:`GraniteConfig` for ``model_type: granitemoehybrid``, else a
    :class:`BertConfig` (which raises for any other ``model_type``)."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        kind = json.load(f).get("model_type", "bert")
    if kind == GraniteConfig.model_type:
        return GraniteConfig.from_dir(path)
    return BertConfig.from_dir(path)


class StaticItem(Dropping):
    """Lookup table, started from ``pretrained`` when given. ``row_map``
    remaps ids before the lookup: words that occur in dev/test only and
    have no pretrained vector share the unk row, so they never train private
    vectors.

    ``mode='vae'`` / ``'ib'`` put a Gaussian head on the looked-up vectors
    (a dense ``enc`` to mean and log-variance of ``out_dim`` each; ``ib``
    also a learned prior ``target_mean``/``target_lvar``): in training the
    reparameterised draw (noise from the generator of
    :func:`~.nn.set_dropout_generator`), at eval the mean, with the KL term
    alongside (:meth:`embed`)."""

    def __init__(self, cfg: EmbeddingItemCfg, pretrained=None, row_map=None):
        super().__init__()
        if cfg.mode not in ("basic", "vae", "ib"):
            raise ValueError(f"unknown embedding mode: {cfg.mode!r}")
        self.mode = cfg.mode
        self.embedding = nn.Parameter(torch.randn(cfg.n_vocab, cfg.embedding_dim))
        if cfg.mode != "basic":
            self.enc = nn.Linear(cfg.embedding_dim, 2 * cfg.out_dim)
        if cfg.mode == "ib":
            self.target_mean = nn.Parameter(torch.zeros(1, cfg.out_dim))
            self.target_lvar = nn.Parameter(torch.zeros(1, cfg.out_dim))
        # the table a fresh model starts from (kept out of the state dict)
        self.pretrained = (None if pretrained is None
                           else torch.as_tensor(np.asarray(pretrained), dtype=torch.float32))
        self.register_buffer(
            "row_map", None if row_map is None
            else torch.tensor(row_map, dtype=torch.long), persistent=False)

    def embed(self, ids, sample: bool = True):
        """``(vectors, kl)``: the table's rows (``kl`` None), or under a
        variational mode the draw (with ``sample`` in training) or the mean,
        and the KL term."""
        ids = ids.long()
        if self.row_map is not None:
            ids = self.row_map[ids]
        h = F.embedding(ids, self.embedding)
        if self.mode == "basic":
            return h, None
        mean, lvar = self.enc(h).chunk(2, -1)
        z = mean
        if sample and self.training:
            z = mean + torch.exp(0.5 * lvar) * self.noise(mean.shape, mean)
        target = (self.target_mean, self.target_lvar) if self.mode == "ib" else None
        return z, variational_kl(mean, lvar, target)

    def forward(self, ids):
        return self.embed(ids)[0]


class CharItem(nn.Module):
    """Char-CNN word embeddings: characters through a ``char_dim`` table,
    one 1-D convolution a ``(kernel_size, filter_num)`` pair along the word
    with flax's "SAME" padding (``k - 1`` in all, the larger half on the
    right), ReLU, a max over the word's characters (padding ones masked
    with -1e9), and ``proj`` to ``embedding_dim``. Char id 0 is padding; a
    word of padding only embeds to exactly 0."""

    def __init__(self, cfg: EmbeddingItemCfg):
        super().__init__()
        self.cfg = cfg
        self.char_embedding = nn.Parameter(torch.randn(cfg.n_vocab, cfg.char_dim))
        for k, nf in zip(cfg.kernel_sizes, cfg.filter_nums):
            self.add_module(f"conv{k}", nn.Conv1d(cfg.char_dim, nf, k))
        self.proj = nn.Linear(sum(cfg.filter_nums), cfg.embedding_dim)

    def embed(self, chars):
        """``([B, L, embedding_dim], None)`` of char ids ``[B, L, W]``."""
        B, L, W = chars.shape
        chars = chars.reshape(B * L, W).long()
        cmask = (chars > 0)[..., None]  # [BL, W, 1]
        h = torch.where(cmask, F.embedding(chars, self.char_embedding), 0.0)
        h = h.transpose(1, 2)  # [BL, C, W]
        pooled = []
        for k in self.cfg.kernel_sizes:
            c = getattr(self, f"conv{k}")(F.pad(h, ((k - 1) // 2, k // 2)))
            c = torch.where(cmask, torch.relu(c.transpose(1, 2)), -1e9)
            pooled.append(c.amax(1))
        out = self.proj(torch.cat(pooled, -1))
        out = torch.where(cmask.any(1), out, 0.0)
        return out.view(B, L, -1), None

    def forward(self, chars):
        return self.embed(chars)[0]


class _Table(nn.Module):
    def __init__(self, n, d):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(n, d) * 0.02)

    def forward(self, ids):
        return F.embedding(ids, self.embedding)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = _Table(c.vocab_size, c.hidden_size)
        self.position_embeddings = _Table(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = _Table(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, ids, position_ids, token_type_ids):
        h = (self.word_embeddings(ids) + self.token_type_embeddings(token_type_ids)
             + self.position_embeddings(position_ids))
        return self.LayerNorm(h)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        H = c.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)


class _Dense(nn.Module):
    def __init__(self, n_in, n_out, eps=None):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(n_out, eps=eps)


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.n_heads = c.num_attention_heads
        # flax names this submodule ``self``
        self.add_module("self", _Attention(c))
        self.output = _Dense(c.hidden_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, h, bias):
        att = getattr(self, "self")
        B, S, H = h.shape
        hd = H // self.n_heads

        def heads(x):
            return x.view(B, S, self.n_heads, hd).transpose(1, 2)

        q = heads(att.query(h)) / (hd ** 0.5)
        k, v = heads(att.key(h)), heads(att.value(h))
        w = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        ctx = (w @ v).transpose(1, 2).reshape(B, S, H)
        return self.output.LayerNorm(self.output.dense(ctx) + h)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = BertAttention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, h, bias):
        h = self.attention(h, bias)
        x = F.gelu(self.intermediate.dense(h))  # exact GELU
        return self.output.LayerNorm(self.output.dense(x) + h)


class BertEncoder(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_hidden_layers))


class Bert(nn.Module):
    """BERT without the pooler; returns all hidden states (embeddings
    first), like ``output_hidden_states=True``."""

    def __init__(self, c: BertConfig):
        super().__init__()
        self.config = c
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoder(c)

    def forward(self, ids, mask):
        B, S = ids.shape
        pos = torch.arange(S, device=ids.device)[None].expand(B, S)
        h = self.embeddings(ids, pos, torch.zeros_like(ids))
        bias = torch.where(mask[:, None, None, :], 0.0,
                           torch.finfo(torch.float32).min)
        states = [h]
        for layer in self.encoder.layer:
            h = layer(h, bias)
            states.append(h)
        return states


class TransformerItem(nn.Module):
    """Subword encoder (frozen unless ``requires_grad``): BERT, or the
    granite stack for a :class:`GraniteConfig` (held as ``bert`` too, so
    the frozen pattern and the spans are the same), with ScalarMix, stride
    windows for inputs longer than the position limit, and pooling of each
    word's subword span [first, last]."""

    def __init__(self, cfg: EmbeddingItemCfg, bert_config):
        super().__init__()
        self.cfg = cfg
        self.bert = (GraniteHybrid(bert_config) if isinstance(bert_config, GraniteConfig)
                     else Bert(bert_config))
        if cfg.n_layers > 1:
            self.scalar_mix = ScalarMix(cfg.n_layers, cfg.layer_dropout)
        if cfg.n_out:
            self.projection = nn.Linear(bert_config.hidden_size, cfg.n_out)

    def _encode(self, ids, mask):
        layers = self.bert(ids, mask)[-self.cfg.n_layers:]
        if self.cfg.n_layers > 1:
            return self.scalar_mix(layers)
        return layers[-1]

    def forward(self, subword, subword_mask, subword_first, subword_last=None):
        return self.project(self.words(subword, subword_mask, subword_first, subword_last))

    def words(self, subword, subword_mask, subword_first, subword_last=None):
        """Each word's pooled states ``[B, L, H]``, before the projection
        (all of the item that a frozen encoder computes without gradient)."""
        with torch.set_grad_enabled(self.cfg.requires_grad and torch.is_grad_enabled()):
            h = self._hidden(subword, subword_mask)
        return self._pool(h, subword_first, subword_last)

    def project(self, h_words):
        """The trainable projection of the pooled words (``n_out``), if any."""
        return self.projection(h_words) if self.cfg.n_out else h_words

    @property
    def frozen(self) -> bool:
        """Whether :meth:`words` takes no gradient and draws nothing: a
        frozen encoder whose layer mix, if any, drops no layer."""
        return not self.cfg.requires_grad and (self.cfg.n_layers == 1
                                               or self.cfg.layer_dropout == 0)

    def _hidden(self, subword, subword_mask):
        """Mixed BERT states of every subword position [B, S, H]."""
        cfg = self.cfg
        subword = subword.long()
        B, S = subword.shape
        max_len = self.bert.config.max_position_embeddings
        if S <= max_len:
            h = self._encode(subword, subword_mask)
        else:
            # window 0 keeps [0, max_len); window k > 0 keeps its last
            # ``stride`` positions
            stride = min(int(cfg.stride) or max_len // 2, max_len)
            n_win = -(-(S - max_len) // stride) + 1
            pad_to = max_len + (n_win - 1) * stride
            ids = F.pad(subword, (0, pad_to - S))
            msk = F.pad(subword_mask, (0, pad_to - S))
            win_ids = torch.stack([ids[:, k * stride: k * stride + max_len]
                                   for k in range(n_win)], 1)
            win_msk = torch.stack([msk[:, k * stride: k * stride + max_len]
                                   for k in range(n_win)], 1)
            hw = self._encode(win_ids.view(B * n_win, max_len),
                              win_msk.view(B * n_win, max_len))
            hw = hw.view(B, n_win, max_len, -1)
            parts = [hw[:, 0]] + [hw[:, k, max_len - stride:]
                                  for k in range(1, n_win)]
            h = torch.cat(parts, 1)[:, :S]
        return h

    def _pool(self, h, subword_first, subword_last):
        """Pool each word's subword span [first, last]."""
        cfg = self.cfg
        first = subword_first.long()
        last = first if subword_last is None else subword_last.long()
        if cfg.pooling == "first":
            h_words = torch.gather(h, 1, first[..., None].expand(-1, -1, h.shape[-1]))
        elif cfg.pooling == "last":
            h_words = torch.gather(h, 1, last[..., None].expand(-1, -1, h.shape[-1]))
        elif cfg.pooling == "mean":
            csum = torch.cat([torch.zeros_like(h[:, :1]), torch.cumsum(h, 1)], 1)
            D = h.shape[-1]
            tot = (torch.gather(csum, 1, (last + 1)[..., None].expand(-1, -1, D))
                   - torch.gather(csum, 1, first[..., None].expand(-1, -1, D)))
            n_sub = torch.clamp_min(last - first + 1, 1).to(h.dtype)
            h_words = tot / n_sub[..., None]
        else:
            raise ValueError(f"unknown pooling: {cfg.pooling!r}")
        return h_words


class CompositeEmbedding(Dropping):
    """Concatenation of embedding items (each registered under its flax
    name, so parameter paths match the JAX package), with the independent
    dropout across items in training."""

    def __init__(self, items: Tuple[EmbeddingItemCfg, ...],
                 bert_config: Optional[BertConfig] = None,
                 dropout: float = 0.0, pretrained=None, row_maps=None):
        super().__init__()
        self.items = items
        self.dropout = dropout
        for cfg in items:
            if cfg.kind == "transformer":
                mod = TransformerItem(cfg, bert_config)
            elif cfg.kind == "static":
                mod = StaticItem(cfg, (pretrained or {}).get(cfg.name),
                                 (row_maps or {}).get(cfg.name))
            elif cfg.kind == "char":
                mod = CharItem(cfg)
            else:
                raise NotImplementedError(f"embedding kind {cfg.kind!r} is not ported")
            self.add_module(cfg.name, mod)

    @property
    def embed_size(self) -> int:
        return sum(cfg.embed_size for cfg in self.items)

    def embed_item(self, name: str, ids):
        """Embed raw ids with one item's table (used for token_emb); a
        variational item gives its posterior mean, in training too."""
        mod = getattr(self, name)
        return mod.embed(ids, sample=False)[0] if isinstance(mod, StaticItem) else mod(ids)

    # the batch fields a transformer item reads
    SUBWORD_FIELDS = ("subword", "subword_mask", "subword_first", "subword_last")

    def frozen(self, inputs):
        """``{name: words}`` of the frozen transformer items
        (:attr:`TransformerItem.frozen`): what :meth:`forward` takes as
        ``frozen`` so that those encoders can run ahead of the rest."""
        return {cfg.name: getattr(self, cfg.name).words(
                    *(inputs.get(k) for k in self.SUBWORD_FIELDS))
                for cfg in self.items
                if cfg.kind == "transformer" and getattr(self, cfg.name).frozen}

    def forward(self, inputs, frozen=None):
        """``(embedding, aux)``; ``frozen``: the words of
        :meth:`frozen`, computed beforehand (``None``: computed here)."""
        embs, aux = [], {}
        for cfg in self.items:
            mod = getattr(self, cfg.name)
            if cfg.kind == "transformer" and frozen is not None and cfg.name in frozen:
                h = mod.project(frozen[cfg.name])
            elif cfg.kind == "transformer":
                h = mod(*(inputs.get(k) for k in self.SUBWORD_FIELDS))
            else:
                h, kl = mod.embed(inputs[cfg.field])
                if kl is not None:
                    aux["kl"] = kl if "kl" not in aux else aux["kl"] + kl
            aux[cfg.name] = h
            embs.append(h)
        if self.active(self.dropout) and embs:
            keeps = [self.keep_mask(e.shape[:2], self.dropout, e) for e in embs]
            embs = independent_dropout(embs, self.dropout, keeps)
        seq_len = max(e.shape[1] for e in embs)
        embs = [e.expand(e.shape[0], seq_len, e.shape[2]) if e.shape[1] == 1
                else e for e in embs]
        return torch.cat(embs, -1), aux


def load_glove(path, vocab, dim: int, lower: bool = True):
    """GloVe-format vectors aligned to ``vocab``: ``(table [len(vocab), dim],
    found)``. Rows of words the file lacks are N(0, 1) from numpy seed 0, the
    padding row is zero; ``found`` is the set of vocab words the file has.
    Lines with another number of fields are skipped."""
    table = np.random.default_rng(0).normal(
        0, 1, (len(vocab), dim)).astype(np.float32)
    found = set()
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            w = parts[0].lower() if lower else parts[0]
            if w in vocab:
                table[vocab[w]] = np.asarray(parts[1:], np.float32)
                found.add(w)
    table[vocab.pad_index] = 0.0
    return table, found


def glove_row_map(vocab, found) -> tuple:
    """Index remap that ties the words of dev/test only without a
    pretrained vector to the unk row."""
    unk = vocab.unk_index
    return tuple(unk if (vocab.is_no_create(w) and w not in found) else i
                 for i, w in enumerate(vocab.idx2word))


@torch.no_grad()
def normalize_embedding_(table, method: str = "mean+std", counts=None):
    """Re-whiten one embedding table in place (counterpart of
    ``normalize_embedding_params``). With ``counts`` (token frequencies by
    row) a count-weighted scalar mean and std; otherwise per-dimension
    statistics over rows 1.. (the padding row kept), Bessel-corrected and
    without an epsilon."""
    if counts is not None:
        w = torch.as_tensor(counts, dtype=torch.float32, device=table.device)
        w = (w / torch.clamp_min(w.sum(), 1.0))[:, None]
        mean = (table * w).sum()
        std = torch.sqrt((((table - mean) ** 2) * w).sum() + 1e-6)
        data = table
        if method in ("mean", "mean+std"):
            data = data - mean
        if method in ("std", "mean+std"):
            data = data / std
        table.copy_(data)
        return
    data = table[1:]
    mean = data.mean(0, keepdim=True)
    std = data.std(0, keepdim=True, unbiased=True)
    if method == "mean":
        data = data - mean
    elif method == "std":
        data = data / std
    elif method == "mean+std":
        data = (data - mean) / std
    else:
        raise ValueError(method)
    table[1:] = data

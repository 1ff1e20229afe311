"""Text encoders (counterpart of vlgae_tpu/models/text_encoder.py):
the ``MLPEncoder`` of ``exp=vlgae``."""

from __future__ import annotations

from torch import nn

from .nn import Dropping, shared_dropout, shared_keep_shape


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

    def forward(self, emb, mask):
        x = self.linear(emb)
        if self.active(self.dropout):
            x = x * self.keep_mask(x.shape, self.dropout, x) / (1 - self.dropout)
        if self.active(self.shared_dropout):
            p = self.shared_dropout
            x = shared_dropout(x, p, self.keep_mask(shared_keep_shape(x), p, x))
        return {"x": x}

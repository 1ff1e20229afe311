"""Text encoders (counterpart of vlgae_tpu/models/text_encoder.py):
the ``MLPEncoder`` of ``exp=vlgae``, eval forward."""

from __future__ import annotations

from torch import nn


class MLPEncoder(nn.Module):
    """Linear encoder (its dropouts act only in training)."""

    def __init__(self, n_in: int, n_hidden: int):
        super().__init__()
        self.linear = nn.Linear(n_in, n_hidden)
        self.n_hidden = n_hidden

    def forward(self, emb, mask):
        return {"x": self.linear(emb)}

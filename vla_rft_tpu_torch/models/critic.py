"""Critic (value) model: the decoder trunk and a scalar token-value head
(port of vla_rft_tpu/models/critic.py, verl's token-classification value
model and dp_critic).

`CriticModel` is a `Decoder` named `backbone` (no LM head: the trunk's
final-norm hidden states are all it gives) and an f32 `value_head` (H -> 1,
no bias) over the hidden states cast to f32.  Its state dict is
`flax_to_torch(tree, "critic")` of the reference's parameters.  On the card
the trunk's attention runs kernel #1, and #2 / #3 in a backward."""
from __future__ import annotations

import torch
from torch import nn

from vla_rft_tpu_torch.models.layers import Dense
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig


class CriticModel(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Decoder(cfg)
        self.backbone.lm_head = None  # the trunk runs with compute_logits=False
        self.value_head = Dense(cfg.hidden_size, 1, bias=False, dtype=torch.float32,
                                param_dtype=torch.float32)

    def forward(self, input_ids, positions=None, kv_lens=None, kv_starts=None) -> torch.Tensor:
        """(B, S) f32 values, one per position."""
        _, hidden = self.backbone(input_ids, positions=positions, kv_lens=kv_lens,
                                  kv_starts=kv_starts, compute_logits=False)
        return self.value_head(hidden.float())[..., 0]


def compute_values(critic: CriticModel, input_ids, attention_mask, position_ids,
                   response_length: int) -> torch.Tensor:
    """(B, R) values over the response: the value at position t - 1 for
    response token t (the positions before each response token), zero where
    the response mask is 0.  Pad keys are masked by kv_starts, keys past the
    response's end by kv_lens, as in `compute_log_probs`."""
    P = input_ids.shape[1] - response_length
    pad_counts = (1 - attention_mask[:, :P]).sum(dim=1).to(torch.int32)
    values = critic(input_ids, positions=position_ids, kv_starts=pad_counts,
                    kv_lens=attention_mask.sum(dim=1).to(torch.int32) + pad_counts)
    v = values[:, -response_length - 1:-1]
    return v * attention_mask[:, -response_length:].to(v.dtype)

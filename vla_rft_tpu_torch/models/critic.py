"""Critic (value) model: the decoder trunk and a scalar token-value head
(port of vla_rft_tpu/models/critic.py, verl's token-classification value
model and dp_critic).

`ScalarHeadModel` is a `Decoder` named `backbone` (no LM head: the trunk's
final-norm hidden states are all it gives) and an f32 scalar head (H -> 1,
no bias) over the hidden states cast to f32, named by the subclass:
`CriticModel`'s is `value_head`, `models/reward_model.py::SequenceRewardModel`'s
`score_head`.  `CriticModel`'s state dict is `flax_to_torch(tree, "critic")`
of the reference's parameters.  On the card the trunk's attention runs
kernel #1, and #2 / #3 in a backward."""
from __future__ import annotations

import torch
from torch import nn

from vla_rft_tpu_torch.models.layers import Dense
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig


class ScalarHeadModel(nn.Module):
    head_name = "head"

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Decoder(cfg)
        self.backbone.lm_head = None  # the trunk runs with compute_logits=False
        setattr(self, self.head_name, Dense(cfg.hidden_size, 1, bias=False,
                                            dtype=torch.float32, param_dtype=torch.float32))

    def forward(self, input_ids, positions=None, kv_lens=None, kv_starts=None) -> torch.Tensor:
        """(B, S) f32 head outputs, one per position."""
        _, hidden = self.backbone(input_ids, positions=positions, kv_lens=kv_lens,
                                  kv_starts=kv_starts, compute_logits=False)
        return getattr(self, self.head_name)(hidden.float())[..., 0]


def token_outputs(model: ScalarHeadModel, input_ids, attention_mask, position_ids,
                  response_length: int) -> torch.Tensor:
    """(B, S) head outputs of left-padded prompt + response rows: pad keys
    masked by kv_starts, keys past the response's end by kv_lens, as in
    `compute_log_probs`."""
    P = input_ids.shape[1] - response_length
    pad_counts = (1 - attention_mask[:, :P]).sum(dim=1).to(torch.int32)
    return model(input_ids, positions=position_ids, kv_starts=pad_counts,
                 kv_lens=attention_mask.sum(dim=1).to(torch.int32) + pad_counts)


class CriticModel(ScalarHeadModel):
    head_name = "value_head"


def compute_values(critic: CriticModel, input_ids, attention_mask, position_ids,
                   response_length: int) -> torch.Tensor:
    """(B, R) values over the response: the value at position t - 1 for
    response token t (the positions before each response token), zero where
    the response mask is 0."""
    values = token_outputs(critic, input_ids, attention_mask, position_ids, response_length)
    v = values[:, -response_length - 1:-1]
    return v * attention_mask[:, -response_length:].to(v.dtype)

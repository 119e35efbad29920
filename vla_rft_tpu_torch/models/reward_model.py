"""Model-based reward model: the decoder trunk and a scalar score head read at
the last valid token of each sequence (port of
vla_rft_tpu/models/reward_model.py, verl's RewardModelWorker).

`SequenceRewardModel` is `models/critic.py::ScalarHeadModel` with its head
named `score_head`: a `Decoder` named `backbone` without LM head and an f32
H -> 1 head without bias.  Its state dict is
`flax_to_torch(tree, "reward_model")` of the reference's parameters.  On the
card the trunk's attention runs kernel #1."""
from __future__ import annotations

import torch

from vla_rft_tpu_torch.models.critic import ScalarHeadModel, token_outputs


class SequenceRewardModel(ScalarHeadModel):
    head_name = "score_head"


def compute_rm_score(rm: SequenceRewardModel, input_ids, attention_mask, position_ids,
                     response_length: int) -> torch.Tensor:
    """(B, R) f32: each row's score at its last valid response token, zero
    elsewhere and on a row with no response (fsdp_workers.compute_rm_score).
    Pad keys are masked as in `compute_values`."""
    scores = token_outputs(rm, input_ids, attention_mask, position_ids, response_length)
    resp_mask = attention_mask[:, -response_length:]
    last = (resp_mask.sum(dim=1) - 1).clamp_min(0).long()[:, None]
    last_scores = scores[:, -response_length:].gather(1, last)
    token_scores = torch.zeros_like(scores[:, -response_length:]).scatter(1, last, last_scores)
    return token_scores * resp_mask.float()

"""The configuration the policy-serving path reads.

The reference's `vla_rft_default_config()` (vla_rft_tpu/config.py) holds
the whole training run; the serving path reads only these fields of it
(eval/policy.py:80-84 and the policy half of models/factory.py), with the
same defaults.  The rest comes with the slices that need it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    # actor_rollout_ref.model.num_images_in_input: camera views per request
    num_images_in_input: int = 1
    # processor.action_dim
    action_dim: int = 7
    # data.video.segment_length: the action chunk is segment_length - 1 long
    segment_length: int = 9

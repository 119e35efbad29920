"""The tiny text-RL setting that the PPO tests share, without JAX (the
rank processes of tests/torch_parallel_ranks.py import it too): the f32
Qwen-shaped decoder's sizes, the base overrides, a digit tokenizer, a
numpy-seeded prompt set, a toy scorer and the injected rollout (see
tests/test_torch_ppo.py)."""
import numpy as np
import torch

from vla_rft_tpu_torch.ops.masked import get_response_mask

TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB, P, R, EOS, PAD = 64, 96, 8, 2, 0
CFG = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, head_dim=16, rope_theta=1e6, qkv_bias=True, tie_word_embeddings=True)
BASE = {"data.train_batch_size": 2, "data.val_batch_size": 2, "actor_rollout_ref.rollout.n": 4,
        "actor_rollout_ref.rollout.response_length": R,
        "actor_rollout_ref.rollout.val_kwargs.n": 4,
        "actor_rollout_ref.actor.ppo_mini_batch_size": 4,
        "actor_rollout_ref.actor.optim.lr": 1e-4, "critic.optim.lr": 1e-4,
        "actor_rollout_ref.rollout.log_prob_micro_batch_size_per_gpu": 4,
        "actor_rollout_ref.ref.log_prob_micro_batch_size_per_gpu": 2,
        "processor.eos_token_id": EOS, "processor.pad_token_id": PAD}


class DigitTokenizer:
    """Ids as words, id 4 as "####" (the gsm8k answer marker)."""

    def decode(self, ids):
        return " ".join("####" if i == 4 else str(i) for i in ids)


class PromptSet:
    """Left-padded prompts in P = 96 from a numpy seed: 8..23 tokens in even
    rows (pads of 73 or more), 24..95 in odd ones."""

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)

    def sample_batch(self, b):
        ids = np.full((b, P), PAD, np.int32)
        for i in range(b):
            n = int(self._rng.integers(*((8, 24) if i % 2 == 0 else (24, P))))
            ids[i, P - n:] = self._rng.integers(5, VOCAB, n)
        return {"input_ids": ids, "data_sources": ["openai/gsm8k"] * b,
                "ground_truths": [("7", "9")[i % 2] for i in range(b)]}


def toy_score(data_source, text, gt, extra=None):
    return 1.0 if gt in text.split() else 0.0


def fake_rollout(prompts: np.ndarray) -> dict:
    """generate_sequences' tensor contract for `prompts`, from a numpy seed
    (the row count): random responses, an EOS in every third row, a
    "#### 7" answer starting every fourth."""
    B = prompts.shape[0]
    rng = np.random.default_rng(100 + B)
    resp = rng.integers(5, VOCAB, (B, R)).astype(np.int32)
    resp[1::3, rng.integers(1, R)] = EOS
    resp[::4, :2] = [4, 7]
    mask = get_response_mask(torch.from_numpy(resp), EOS).numpy().astype(np.int32)
    resp = np.where(mask == 1, resp, PAD).astype(np.int32)
    starts = (prompts == PAD).sum(1)
    pos = np.concatenate([np.clip(np.arange(P)[None] - starts[:, None], 0, None),
                          (P - starts)[:, None] + np.arange(R)[None]], 1)
    attn = np.concatenate([np.arange(P)[None] >= starts[:, None], mask], 1)
    return {"prompts": prompts.astype(np.int32), "responses": resp,
            "input_ids": np.concatenate([prompts, resp], 1).astype(np.int32),
            "attention_mask": attn.astype(np.int32), "position_ids": pos.astype(np.int32),
            "response_mask": mask}

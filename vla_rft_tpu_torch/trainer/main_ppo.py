"""Text-RL PPO entry point (port of vla_rft_tpu/trainer/main_ppo.py, verl's
main_ppo).

Reads the prompts of data.train_files through `RLHFDataset`, scores with
`NaiveRewardManager` over the tokenizer of actor_rollout_ref.model.ckpt_path,
loads the policy (Qwen2.5-0.5B) from that directory's `*.safetensors` (the
reference policy becomes a frozen copy of the loaded weights, and so do
PRIME's RM and its reference; the critic, with adv_estimator=gae, and the
value-head RM keep their seeded initialisations, as the reference's do) and
runs `PPOTrainer.fit`.

Usage:
  python -m vla_rft_tpu_torch.trainer.main_ppo \
      actor_rollout_ref.model.ckpt_path=<HF model dir> data.train_files=<parquet> \
      [algorithm.adv_estimator=grpo|gae|rloo|reinforce_plus_plus|remax|prime] \
      [reward_model.enable=True [reward_model.rm_type=value_head|prime]] \
      [trainer.total_training_steps=N] [trainer.test_freq=N] \
      [actor_rollout_ref.model.enable_gradient_checkpointing=true] [--device=cpu]

The reward models: `reward_model.enable=True` scores with a value-head RM
(models/reward_model.py) every row whose data source has no rule scorer;
with `reward_model.rm_type=prime` and `algorithm.adv_estimator=prime`
(recipe/prime.sh's overrides) PRIME's implicit process RM
(workers/prime_rm.py) scores every response token and trains online, with
reward_model.prime_granularity=token|whole, prime_norm, loss_type=ce|dpo,
bon_mode=none|bon_rm|bon_acc, beta_train, lr, update=after|before and
algorithm.reward_dpo_coef / reward_gt_coef (5.0).

The device defaults to the card; `--device=cpu` runs the plain PyTorch
path.  Over ranks it runs under torchrun (or `python -m torch.distributed.run
--nproc_per_node N -m vla_rft_tpu_torch.trainer.main_ppo ...`): the process
group starts from torchrun's variables (NCCL on the card, gloo on the CPU,
or `--backend=gloo|nccl`; ranks that share one card need gloo), config.mesh
(`mesh.dp=.. mesh.fsdp=..`) places the trees and splits the batch (a mesh
the world cannot hold raises, at one process too), each rank runs on
cuda:{LOCAL_RANK % device_count} and loads the checkpoint, only rank 0
prints the step lines, and the group is destroyed at exit.  actor_rollout_ref.model.enable_gradient_checkpointing turns on the
decoder's `remat` (policy, critic and PRIME's RM): at the config's sizes
(mini-batches of 16 rows of 1095 + 568 tokens) the update does not fit an
80 GB card without it.  The rollout pads and stops with the tokenizer's pad and EOS ids
unless processor.pad_token_id / processor.eos_token_id are given: the
reference reads them from `processor.*` alone, whose defaults (9007) are
the world model's, not the tokenizer's, so its prompts' pad keys would not
be masked.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.convert_weights import convert_hf_decoder
from vla_rft_tpu_torch.data.rlhf_dataset import RLHFDataset
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.trainer.config_check import resolve_mesh
from vla_rft_tpu_torch.trainer.ppo_trainer import PPOTrainer
from vla_rft_tpu_torch.utils.weight_files import load_dir
from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager


def run(argv: Optional[List[str]] = None) -> PPOTrainer:
    """Parse `--device=`, `--backend=` and the dotted overrides, start the
    process group under torchrun, build the trainer, load the weights,
    train; returns the trainer."""
    argv = list(sys.argv[1:] if argv is None else argv)
    device, backend = "cuda", None
    for a in list(argv):
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
        elif a.startswith("--backend="):
            backend = a.split("=", 1)[1]
            argv.remove(a)
    dev = resolve_device(device)
    started = pd.initialize_distributed(backend, dev.type)
    try:
        return _run(argv, dev)
    finally:
        if started:
            pd.shutdown()


def _run(argv: List[str], dev) -> PPOTrainer:
    overrides = [a for a in argv if "=" in a]
    config = vla_rft_default_config().apply_overrides(overrides)
    resolve_mesh(config, pd.world_size())  # a mesh the world cannot hold raises first

    model_path = config.actor_rollout_ref.model.ckpt_path
    if not model_path:
        raise SystemExit("actor_rollout_ref.model.ckpt_path is required")
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_path)
    pad = tokenizer.pad_token_id or 0
    given = {a.partition("=")[0].strip() for a in overrides}
    for key, value in (("processor.pad_token_id", pad),
                       ("processor.eos_token_id", tokenizer.eos_token_id)):
        if key not in given and value is not None:
            config.set_path(key, value)

    llm_cfg = dataclasses.replace(
        TransformerConfig.qwen25_0_5b(),
        remat=bool(config.actor_rollout_ref.model.get("enable_gradient_checkpointing", False)))
    dataset = RLHFDataset(
        config.data.get("train_files"), tokenizer,
        prompt_key=config.data.get("prompt_key", "prompt"),
        max_prompt_length=config.data.get("max_prompt_length", 256), pad_token_id=pad,
    )
    trainer = PPOTrainer(config, llm_cfg, tokenizer, dataset,
                         reward_manager=NaiveRewardManager(tokenizer), device=dev)
    sd = load_dir(model_path)
    if sd:
        trainer.load_actor(flax_to_torch(convert_hf_decoder(sd, llm_cfg), "decoder"))
        del sd
    trainer.fit()
    return trainer


if __name__ == "__main__":
    run()

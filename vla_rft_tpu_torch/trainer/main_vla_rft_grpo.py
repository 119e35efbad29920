"""CLI entry point for VLA-RFT GRPO training (port of
vla_rft_tpu/trainer/main_vla_rft_grpo.py).

Usage (the reference's dotted overrides and defaults):
  python -m vla_rft_tpu_torch.trainer.main_vla_rft_grpo \
      trainer.total_training_steps=2 data.train_batch_size=2 \
      actor_rollout_ref.rollout.n=4 world_model_rollout.rollout.weights_int8=true \
      [world_model_rollout.rollout.kv_layout=hd|heads] [--preset=libero|tiny] [--device=cpu]

The device defaults to the card; `--device=cpu` runs the plain PyTorch path.
Every algorithm setting of the reference's trainer runs:
algorithm.adv_estimator (grpo, rloo, reinforce_plus_plus[_baseline],
remax), trainer.use_ac_reward, trainer.reward_fn (mae, mse, wm_logprob),
world_model_rollout.rollout.speculative_k (0..7), and validation
(trainer.val_before_train, trainer.val_only, trainer.test_freq,
trainer.val_iters, trainer.img_save_dir for the frame grids).
Data comes from `data/synthetic.py` (validation from a held-out synthetic
stream); a non-empty data.video.dataset_path (RLDS) is not ported yet and
raises, as do configured checkpoint paths
(actor_rollout_ref.model.ckpt_path, world_model_rollout.model.path,
processor.tokenizer.path, processor.lpips_path): weights are seeded random
(trainer.seed), as the reference's without converted checkpoints.
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional

from vla_rft_tpu_torch.config import vla_rft_default_config
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer

CHECKPOINT_PATHS = ("actor_rollout_ref.model.ckpt_path", "world_model_rollout.model.path",
                    "processor.tokenizer.path", "processor.lpips_path")


def run(argv: Optional[List[str]] = None,
        on_start: Optional[Callable[[VLARFTGRPOTrainer], None]] = None,
        on_step_start: Optional[Callable[[int], None]] = None,
        on_step_end: Optional[Callable[[int, Dict[str, float]], None]] = None
        ) -> VLARFTGRPOTrainer:
    """Parse flags and overrides, build the trainer, fit; returns the
    trainer.  `on_start(trainer)` runs before the first step and the step
    hooks bracket every training_step (see VLARFTGRPOTrainer.fit)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    preset, device = "libero", "cuda"
    for a in list(argv):
        if a.startswith("--preset="):
            preset = a.split("=", 1)[1]
            argv.remove(a)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    config = vla_rft_default_config().apply_overrides([a for a in argv if "=" in a])
    if config.data.video.dataset_path:
        raise NotImplementedError("RLDS data (data.video.dataset_path) is not ported yet")
    for path in CHECKPOINT_PATHS:
        if config.get_path(path):
            raise NotImplementedError(f"loading {path} is not ported yet: weights are seeded "
                                      f"random")
    trainer = VLARFTGRPOTrainer(config, preset=preset, device=device)
    if on_start is not None:
        on_start(trainer)
    trainer.fit(on_step_start=on_step_start, on_step_end=on_step_end)
    return trainer


if __name__ == "__main__":
    run()

"""LIBERO eval CLI: the counterpart of run_libero_eval.py's draccus main.

Port of vla_rft_tpu/eval/main_eval.py.  Builds the policy (seeded random
weights; a checkpoint directory supplies dataset_statistics.json and a
tokenizer) resident on the device, and drives the LIBERO suites from the
host CPU.  `--scripted_env` runs one short episode of `ScriptedEnv` instead
of LIBERO.  The policy runs on the card unless `--device cpu` is given.

    python -m vla_rft_tpu_torch.eval.main_eval --scripted_env
"""
from __future__ import annotations

import argparse
import json


def _strict_bool(s: str) -> bool:
    """Accept only {true,1,yes}/{false,0,no} (case-insensitive): a permissive
    parser silently read `--center_crop 0` as True."""
    v = s.lower()
    if v in ("true", "1", "yes"):
        return True
    if v in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {s!r}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task_suite_name", default="libero_spatial")
    p.add_argument("--num_trials_per_task", type=int, default=50)
    p.add_argument("--num_open_loop_steps", type=int, default=8)
    p.add_argument("--ckpt", default="")
    p.add_argument("--num_tasks", type=int, default=10)
    p.add_argument("--scripted_env", action="store_true", help="fake env smoke test")
    # reference defaults: 2 cameras (third-person + wrist) and eval-time
    # center crop (run_libero_eval.py:99,102)
    p.add_argument("--num_images_in_input", type=int, default=2)
    p.add_argument("--center_crop", type=_strict_bool, default=True)
    p.add_argument("--preset", default="libero", help="model preset (tiny for CPU smoke)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # validate_config (run_libero_eval.py:140): an aug-trained checkpoint
    # MUST be evaluated with the matching center crop
    if "image_aug" in str(args.ckpt):
        assert args.center_crop, (
            "Expecting `center_crop==True` because model was trained with "
            "image augmentations!"
        )

    from vla_rft_tpu_torch.eval.libero_eval import (
        GenerateConfig,
        ScriptedEnv,
        make_libero_env,
        run_suite_eval,
    )
    from vla_rft_tpu_torch.eval.policy import build_policy_fn

    cfg = GenerateConfig(
        task_suite_name=args.task_suite_name,
        num_trials_per_task=args.num_trials_per_task,
        num_open_loop_steps=args.num_open_loop_steps,
        num_images_in_input=args.num_images_in_input,
        center_crop=args.center_crop,
    )
    # shared policy glue (eval/policy.py): the same builder the action
    # server and the ALOHA / Bridge harnesses use
    get_action_chunk = build_policy_fn(
        ckpt=args.ckpt, seed=cfg.seed,
        num_images=cfg.num_images_in_input, center_crop=cfg.center_crop,
        preset=args.preset, device=args.device,
    )

    if args.scripted_env:
        env_factory = lambda tid: (ScriptedEnv(succeed_at=12), "scripted", None)
        num_tasks = 1
        cfg.num_trials_per_task = 1
        cfg.num_steps_wait = 2
    else:
        env_factory = lambda tid: make_libero_env(args.task_suite_name, tid)
        num_tasks = args.num_tasks

    metrics = run_suite_eval(cfg, get_action_chunk, env_factory, num_tasks)
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()

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
stream) unless data.video.dataset_path is set: then from the RLDS shards
`<dataset_path>/<data.video.dataset_name>/*.tfrecord*` (`data/rlds.py`, the
reference's dataset build): data.shuffle_buffer_size, data.image_aug (on by
default) and, with data.val_fraction > 0, a val split held out of the same
shards that validation draws from, normalised with the train split's
statistics.  Windows, images and action chunks take the preset's sizes
(`libero`: the reference's defaults, 9 frames, 8 actions, 224 / 256 px).
The prompt's text tokenizer is `AutoTokenizer` from
actor_rollout_ref.model.ckpt_path (as in the reference; without a path a
ValueError, without `transformers` an ImportError), unless the caller
passes one to `run(tokenizer=...)`.  JPEG frames decode through Pillow's
libjpeg-turbo on either device (`data/image_ops.py`).

Weights are seeded random (trainer.seed) unless checkpoint paths are set;
then the trainer is built, the checkpoints are loaded into its modules in
place (`_maybe_load_pretrained`, the reference's), and training starts:
  actor_rollout_ref.model.ckpt_path  a directory: OpenVLA `*.safetensors`
      (merged; none loads nothing) and the component files action_head--*.pt,
      proprio_projector--*.pt, noisy_action_projector--*.pt and, optionally,
      sigma_net--*.pt (without it the sigma net keeps its initialisation;
      without the other three the expert is not loaded);
  world_model_rollout.model.path  a directory of HF LLaMA `*.safetensors`
      (none loads nothing);
  processor.tokenizer.path  a CompressiveVQModelFSQ weight file, or a
      directory of them with an optional config.json (block_out_channels,
      layers_per_block);
  processor.lpips_path  a file or directory with VGG16 `features.N.*` or
      taming `net.sliceK.N.*` weights and optional `lin{i}.model.1.weight`
      heads (without them LPIPS keeps its heads).
A tokenizer or LPIPS path that holds no weight file raises
FileNotFoundError.  The KL reference policy (use_kl_loss) is the one built
before the load, as in the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import re
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torch import nn

from vla_rft_tpu_torch import convert_weights as cw
from vla_rft_tpu_torch.config import Config, PolicyConfig, WMRewardConfig, vla_rft_default_config
from vla_rft_tpu_torch.convert import flax_to_torch
from vla_rft_tpu_torch.data.rlds import RLDSConfig, RLDSDataset
from vla_rft_tpu_torch.models.factory import policy_configs, wm_reward_configs
from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer
from vla_rft_tpu_torch.utils import weight_files as wf


def run(argv: Optional[List[str]] = None,
        on_start: Optional[Callable[[VLARFTGRPOTrainer], None]] = None,
        on_step_start: Optional[Callable[[int], None]] = None,
        on_step_end: Optional[Callable[[int, Dict[str, float]], None]] = None,
        tokenizer=None) -> VLARFTGRPOTrainer:
    """Parse flags and overrides, build the RLDS datasets when
    data.video.dataset_path is set (the prompts tokenised by `tokenizer`,
    else by the checkpoint's), build the trainer, load the configured
    checkpoints into it, fit; returns the trainer (its `pretrained` holds
    what each load read and took).  `on_start(trainer)` runs after the load,
    before the first step, and the step hooks bracket every training_step
    (see VLARFTGRPOTrainer.fit)."""
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
    dataset = val_dataset = None
    if config.data.video.dataset_path:
        dataset, val_dataset = build_rlds_datasets(
            config, preset, tokenizer if tokenizer is not None else _load_tokenizer(config))
    trainer = VLARFTGRPOTrainer(config, preset=preset, device=device, dataset=dataset,
                                val_dataset=val_dataset)
    trainer.pretrained = _maybe_load_pretrained(trainer, config)
    for family, rec in trainer.pretrained.items():
        print(f"[load] {family}: {rec['tensors']} tensors, {rec['bytes']} bytes read in "
              f"{rec['seconds']:.2f} s")
    if on_start is not None:
        on_start(trainer)
    trainer.fit(on_step_start=on_step_start, on_step_end=on_step_end)
    return trainer


def rlds_config(config: Config, preset: str, **kw) -> RLDSConfig:
    """The RLDSConfig of the reference's dataset build (data_dir,
    dataset_name, shuffle_buffer_size, val_fraction) with the preset's
    window, action and image sizes; `kw` sets the rest (split)."""
    vla_cfg, expert_cfg, _, policy_image = policy_configs(preset,
                                                          PolicyConfig.from_config(config))
    wm_image = wm_reward_configs(preset, WMRewardConfig.from_config(config), tiny_data=False)[5]
    return RLDSConfig(
        data_dir=config.data.video.dataset_path, dataset_name=config.data.video.dataset_name,
        shuffle_buffer_size=config.data.shuffle_buffer_size,
        val_fraction=float(config.data.get("val_fraction", 0.0) or 0.0),
        window_frames=config.data.video.segment_length,
        action_chunk=expert_cfg.num_actions_chunk, action_dim=expert_cfg.action_dim,
        proprio_dim=vla_cfg.proprio_dim, policy_image_size=policy_image,
        wm_image_size=wm_image, **kw)


def build_rlds_datasets(config: Config, preset: str, tokenizer
                        ) -> Tuple[RLDSDataset, Optional[RLDSDataset]]:
    """The train RLDSDataset (data.image_aug) and, with data.val_fraction,
    the val one, which shares the train split's statistics (the
    reference's main_vla_rft_grpo.py:29-53)."""
    train_cfg = rlds_config(config, preset, split="train")
    dataset = RLDSDataset(train_cfg, tokenizer, batch_size=config.data.train_batch_size,
                          image_aug=bool(config.data.get("image_aug", False)))
    val_dataset = None
    if train_cfg.val_fraction > 0:
        val_dataset = RLDSDataset(dataclasses.replace(train_cfg, split="val"), tokenizer,
                                  batch_size=config.data.train_batch_size,
                                  stats=dataset.stats)  # normalisation as in training
    return dataset, val_dataset


def _load_tokenizer(config: Config):
    """The prompt tokenizer: AutoTokenizer from actor_rollout_ref.model.ckpt_path."""
    ckpt = config.actor_rollout_ref.model.ckpt_path
    if not ckpt:
        raise ValueError("RLDS data requires actor_rollout_ref.model.ckpt_path (tokenizer)")
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            "RLDS data reads the prompt tokenizer from actor_rollout_ref.model.ckpt_path with "
            "transformers' AutoTokenizer, and transformers is not installed: install it, or "
            "pass a tokenizer to run(tokenizer=...)") from e
    return AutoTokenizer.from_pretrained(ckpt)


def _nbytes(path: str, patterns=wf.WEIGHT_PATTERNS) -> int:
    return sum(os.path.getsize(f) for f in wf.weight_files(path, patterns))


def _load_into(module: nn.Module, tree: Dict[str, Any], which: str,
               keep: Tuple[str, ...] = ()) -> int:
    """Copy a converted Flax-layout tree into `module`'s parameters in place
    (each cast to the parameter's dtype and device).  Every parameter must
    be in the tree except those under a `keep` prefix, which keep their
    values; a name the module lacks raises.  Returns the tensors copied."""
    sd = flax_to_torch(tree, which)
    missing, unexpected = module.load_state_dict(sd, strict=False)
    bad = [k for k in missing if not k.startswith(keep)] if keep else list(missing)
    if bad or unexpected:
        raise RuntimeError(f"loading {which}: missing {bad[:8]} ({len(bad)}), unexpected "
                           f"{unexpected[:8]} ({len(unexpected)})")
    return len(sd)


def _maybe_load_pretrained(trainer: VLARFTGRPOTrainer, config: Config) -> Dict[str, dict]:
    """Load the configured checkpoints into the trainer's modules in place
    (the reference's `_maybe_load_pretrained`: its converters, then
    `flax_to_torch`), one family at a time, each freed before the next.
    The optimizer keeps pointing at the expert's parameters; the int8 WM
    copy is re-quantised from the loaded WM at its next use.  Returns
    {family: {"tensors", "bytes", "seconds"}} for what was loaded."""
    b, report = trainer.bundle, {}

    def done(family, t0, tensors, nbytes):
        gc.collect()
        report[family] = {"tensors": tensors, "bytes": nbytes,
                          "seconds": time.perf_counter() - t0}

    ckpt = config.actor_rollout_ref.model.ckpt_path
    if ckpt:
        t0 = time.perf_counter()
        sd = wf.load_dir(ckpt)
        if sd:
            tree = cw.convert_openvla(sd, b.vla_cfg)
            del sd
            done("vla", t0, _load_into(b.vla, tree, "vla"), _nbytes(ckpt, ["*.safetensors"]))
            del tree
        # the component checkpoints (action_head--*.pt etc.)
        t0 = time.perf_counter()
        try:
            files = {name: wf.find_checkpoint_file(ckpt, name) for name in
                     ("action_head", "proprio_projector", "noisy_action_projector")}
            try:
                files["sigma_net"] = wf.find_checkpoint_file(ckpt, "sigma_net")
            except FileNotFoundError:
                pass
            sds = {name: wf.load_torch_state_dict(f) for name, f in files.items()}
            tree = cw.convert_action_expert(sds["action_head"], sds.get("sigma_net"),
                                            sds["proprio_projector"],
                                            sds["noisy_action_projector"], b.expert_cfg)
            del sds
            # without sigma_net--*.pt the sigma net keeps its initialisation
            keep = () if "sigma_net" in files else ("sigma_net.",)
            n = _load_into(b.expert, tree, "expert", keep)
            done("expert", t0, n, sum(os.path.getsize(f) for f in files.values()))
        except FileNotFoundError:
            pass
    wm_path = config.world_model_rollout.model.path
    if wm_path:
        t0 = time.perf_counter()
        sd = wf.load_dir(wm_path)
        if sd:
            tree = cw.convert_hf_decoder(sd, b.wm_cfg)
            del sd
            done("wm", t0, _load_into(b.wm, tree, "wm"), _nbytes(wm_path, ["*.safetensors"]))
            del tree

    # the visual tokenizer: a diffusers-style directory (config.json + weight
    # files) or one torch file
    tok_path = config.processor.tokenizer.path
    if tok_path:
        t0 = time.perf_counter()
        sd = wf.load_state_dicts(tok_path)
        kw = {}
        mcfg = wf.read_model_config(tok_path)
        if "block_out_channels" in mcfg:
            kw["n_blocks"] = len(mcfg["block_out_channels"])
        if "layers_per_block" in mcfg:
            kw["layers_per_block"] = int(mcfg["layers_per_block"])
        tree = cw.convert_compressive_vq(sd, **kw)
        del sd
        done("tokenizer", t0, _load_into(b.tokenizer, tree, "tokenizer"),
             _nbytes(tok_path))
        del tree

    # LPIPS: torchvision `features.N.*` or taming `net.sliceK.N.*` VGG16
    # weights, plus optional `lin{i}.model.1.weight` heads
    lpips_path = config.processor.get("lpips_path", None)
    if lpips_path:
        t0 = time.perf_counter()
        vgg_sd, lin_sd = _split_lpips_sd(wf.load_state_dicts(lpips_path))
        if not vgg_sd:
            raise ValueError(
                f"no VGG16 feature weights (features.N.* / net.sliceK.N.*) in {lpips_path}")
        tree = cw.convert_lpips(vgg_sd, lin_sd or None)
        del vgg_sd, lin_sd
        # without heads in the file LPIPS keeps its own
        keep = () if "lin0" in tree["params"] else ("lin",)
        done("lpips", t0, _load_into(b.lpips, tree, "lpips", keep),
             _nbytes(lpips_path))
    return report


def _split_lpips_sd(sd: Dict[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition an LPIPS state dict into torchvision-layout VGG conv weights
    and lin heads.  Taming's vgg16 wrapper keeps the original `features`
    index as the module name inside each slice (`net.slice2.5.weight` is
    torchvision's `features.5.weight`), so slices translate by dropping the
    slice prefix."""
    vgg_sd, lin_sd = {}, {}
    for k, v in sd.items():
        m = re.fullmatch(r"(?:net\.)?slice\d+\.(\d+)\.(weight|bias)", k)
        if m:
            vgg_sd[f"features.{m.group(1)}.{m.group(2)}"] = v
        elif k.startswith("features."):
            vgg_sd[k] = v
        elif re.match(r"lin\d+\.", k):
            lin_sd[k] = v
    return vgg_sd, lin_sd


if __name__ == "__main__":
    run()

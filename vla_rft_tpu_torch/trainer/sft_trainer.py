"""SFT trainers (port of vla_rft_tpu/trainer/sft_trainer.py).

* `SFTTrainer`: masked next-token cross-entropy through a `Decoder`
  (verl's FSDPSFTTrainer), clipped AdamW with an optional warmup.  The repo
  trains its world model this way.
* `VLAFlowSFTTrainer`: flow-matching behaviour cloning of the action expert
  over precomputed, frozen VLM contexts.
* `VLAAdapterSFTTrainer`: the same loss with the gradient flowing through
  `encode_context` into the VLM (VLA-Adapter's finetune stage); the
  reference's `multi_transform` labels freeze the vision towers
  ("featurizer" in a name) and/or the LLM ("language_model").

Each step is `compute_loss` -> `backward` (gradients of every parameter,
frozen ones included, as `jax.value_and_grad` gives them) -> `update`
(`clip_by_global_norm` over all gradients, then one `AdamW` per group; the
frozen group is left out).  On the card every attention layer of the
decoder runs the flash forward (#1) and, in `backward`, the flash backward
(#2, #3).  Random draws come from a `torch.Generator`; a caller that must
match another run passes the noise dict itself.  `PrismaticAlignTrainer`
is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vla_rft_tpu_torch.models.action_head import ActionExpert, sample_noisy_actions
from vla_rft_tpu_torch.models.factory import build_decoder
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.ops.masked import logprobs_from_logits
from vla_rft_tpu_torch.trainer.optim import AdamW, clip_by_global_norm, warmup_constant_schedule
from vla_rft_tpu_torch.workers.flow_actor import encode_context


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy or torch leaves -> tensors on `device` (dtypes kept)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def flow_bc_loss(expert: ActionExpert, hidden: torch.Tensor, proprio: torch.Tensor,
                 noise_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """mean((flow_pred - u)^2) in f32 (the reference's `_loss` of the flow
    trainers)."""
    flow_pred = expert.predict_flow(hidden, noise_dict["gt_noisy_actions"],
                                    noise_dict["gt_timesteps"].float(), proprio)
    return torch.mean((flow_pred.float() - noise_dict["flow"].float()) ** 2)


class _Trainer:
    """Shared step: loss -> gradients of `self.params` -> clip -> AdamW per
    group.  Subclasses set `params` (every parameter the loss reads),
    `groups` (the AdamW of each trained group) and `grad_clip`."""

    params: List[nn.Parameter]
    groups: Sequence[AdamW]
    grad_clip: float

    def backward(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """d loss / d params; a parameter the loss does not reach gets zeros."""
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]

    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Clip by the global norm of all gradients (frozen ones count), then
        step each group; returns the norm before clipping."""
        grads, norm = clip_by_global_norm(grads, self.grad_clip)
        by_param = {id(p): g for p, g in zip(self.params, grads)}
        for opt in self.groups:
            opt.step([by_param[id(p)] for p in opt.params])
        return norm


class SFTTrainer(_Trainer):
    """Masked next-token CE of a `Decoder` (labels -100 are ignored)."""

    def __init__(self, llm_cfg: TransformerConfig, lr=1e-5, weight_decay=0.01, grad_clip=1.0,
                 warmup_steps=0, seed=0, *, device="cuda", llm: Optional[Decoder] = None):
        self.llm = llm if llm is not None else build_decoder(llm_cfg, device=device, seed=seed)
        self.device = self.llm.embed_tokens.weight.device
        sched = warmup_constant_schedule(0.0, lr, warmup_steps) if warmup_steps else lr
        self.params = list(self.llm.parameters())
        self.groups = [AdamW(self.params, sched, weight_decay=weight_decay)]
        self.grad_clip = grad_clip

    def compute_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        kv_lens = batch["attention_mask"].sum(-1).to(torch.int32)
        logits, _ = self.llm(batch["input_ids"], kv_lens=kv_lens)
        shift_logits, shift_labels = logits[:, :-1], batch["labels"][:, 1:]
        mask = (shift_labels != -100).float()
        lp = logprobs_from_logits(shift_logits, shift_labels.clamp_min(0))
        return -(lp * mask).sum() / mask.sum().clamp_min(1)

    def training_step(self, batch: Dict[str, Any]) -> float:
        loss = self.compute_loss(to_device(batch, self.device))
        self.update(self.backward(loss))
        return float(loss.detach())


class VLAFlowSFTTrainer(_Trainer):
    """Flow-matching BC of the action expert over frozen VLM contexts."""

    def __init__(self, expert: ActionExpert, lr=1e-4, grad_clip=1.0):
        self.expert = expert
        self.params = list(expert.parameters())
        self.groups = [AdamW(self.params, lr)]
        self.grad_clip = grad_clip

    def compute_loss(self, hidden, proprio, noise_dict) -> torch.Tensor:
        return flow_bc_loss(self.expert, hidden, proprio, noise_dict)

    def training_step(self, gen: Optional[torch.Generator], hidden: torch.Tensor,
                      gt_actions: torch.Tensor, proprio: torch.Tensor,
                      noise_dict: Optional[Dict[str, torch.Tensor]] = None) -> float:
        if noise_dict is None:
            noise_dict = sample_noisy_actions(gen, gt_actions, self.expert.cfg)
        loss = self.compute_loss(hidden, proprio, noise_dict)
        self.update(self.backward(loss))
        return float(loss.detach())


class VLAAdapterSFTTrainer(_Trainer):
    """Flow-matching BC with a trainable VLM: the gradient flows through
    `encode_context` into the backbone.  Groups as the reference labels
    them: the expert (expert_lr), the VLM (lr), and frozen subtrees (the
    vision towers with `freeze_vision_backbone`, the LLM with `freeze_llm`)
    that get gradients but no update."""

    def __init__(self, vla: nn.Module, expert: ActionExpert, lr: float = 2e-5,
                 expert_lr: float = 1e-4, grad_clip: float = 1.0,
                 freeze_vision_backbone: bool = False, freeze_llm: bool = False):
        self.vla, self.expert = vla, expert
        self.labels: Dict[str, str] = {}
        groups: Dict[str, List[nn.Parameter]] = {"vla": [], "expert": [], "frozen": []}
        for prefix, module in (("vla", vla), ("expert", expert)):
            for name, p in module.named_parameters():
                label = prefix
                if prefix == "vla" and freeze_vision_backbone and "featurizer" in name:
                    label = "frozen"
                if prefix == "vla" and freeze_llm and "language_model" in name:
                    label = "frozen"
                self.labels[f"{prefix}.{name}"] = label
                groups[label].append(p)
        self.params = groups["vla"] + groups["expert"] + groups["frozen"]
        self.groups = [AdamW(groups["vla"], lr), AdamW(groups["expert"], expert_lr)]
        self.grad_clip = grad_clip
        self.device = next(expert.parameters()).device

    def compute_loss(self, batch: Dict[str, torch.Tensor], noise_dict) -> torch.Tensor:
        hidden = encode_context(self.vla, batch)
        return flow_bc_loss(self.expert, hidden, batch["proprio"], noise_dict)

    def training_step(self, gen: Optional[torch.Generator], batch: Dict[str, Any],
                      noise_dict: Optional[Dict[str, torch.Tensor]] = None) -> float:
        batch = to_device(batch, self.device)
        if noise_dict is None:
            noise_dict = sample_noisy_actions(gen, batch["actions"], self.expert.cfg)
        loss = self.compute_loss(batch, noise_dict)
        self.update(self.backward(loss))
        return float(loss.detach())

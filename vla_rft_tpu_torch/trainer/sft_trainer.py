"""SFT trainers (port of vla_rft_tpu/trainer/sft_trainer.py).

* `SFTTrainer`: masked next-token cross-entropy through a `Decoder`
  (verl's FSDPSFTTrainer), clipped AdamW with an optional warmup, over the
  data ranks of `mesh` (the reference's default `MeshConfig()`: dp = the
  world).  The repo trains its world model this way.
* `VLAFlowSFTTrainer`: flow-matching behaviour cloning of the action expert
  over precomputed, frozen VLM contexts.
* `VLAAdapterSFTTrainer`: the same loss with the gradient flowing through
  `encode_context` into the VLM (VLA-Adapter's finetune stage); the
  reference's `multi_transform` labels freeze the vision towers
  ("featurizer" in a name) and/or the LLM ("language_model").
* `PrismaticAlignTrainer`: the prismatic pretraining stages' caption
  next-token loss through `OpenVLA.lm_forward`; only the projector trains
  ("projector" in a name), the towers and the LLM are frozen.

Each step is `compute_loss` -> `backward` (gradients of every parameter,
frozen ones included, as `jax.value_and_grad` gives them) -> `update`
(`parallel/mesh.py::DataRanks.step`: the sum over the data ranks, one
clip by the global norm of all gradients, then one `AdamW` per group; the
frozen group is left out).  On the card every attention layer of the
decoder runs the flash forward (#1) and, in `backward`, the flash backward
(#2, #3).  Random draws come from a `torch.Generator`; a caller that must
match another run passes the noise dict itself.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vla_rft_tpu_torch.models.action_head import ActionExpert, sample_noisy_actions
from vla_rft_tpu_torch.models.action_masks import IGNORE_INDEX
from vla_rft_tpu_torch.models.factory import build_decoder
from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.ops.masked import logprobs_from_logits
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.trainer.optim import AdamW, warmup_constant_schedule
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
    group, over the data ranks of `ranks` (one process unless a subclass
    sets them).  Subclasses set `params` (every parameter the loss reads),
    `groups` (the AdamW of each trained group) and `grad_clip`."""

    params: List[nn.Parameter]
    groups: Sequence[AdamW]
    grad_clip: float
    ranks: pm.DataRanks = pm.DataRanks(None)

    def backward(self, loss: torch.Tensor) -> List[torch.Tensor]:
        """d loss / d params (this rank's share of them: `DataRanks.backward`);
        a parameter the loss does not reach gets zeros."""
        self.ranks.backward(loss)
        return self.ranks.take_grads(self.params)

    def update(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """Sum over the data ranks, clip by the global norm of all gradients
        (frozen ones count), then step each group; returns the norm before
        clipping."""
        return self.ranks.step(self.params, self.groups, self.grad_clip, grads)


class SFTTrainer(_Trainer):
    """Masked next-token CE of a `Decoder` (labels -100 are ignored).

    `mesh` is a `parallel.mesh.MeshConfig` resolved against the world (its
    ValueError for a mesh the world cannot hold); the decoder is placed by
    `shard_params_fsdp` (FSDP2 at fsdp > 1).  Every rank passes the same
    global batch and takes its (dp, fsdp) rows; its loss share is
    -(lp . mask).sum() over the global label count, the gradients are
    summed over the data ranks, clipped by the norm of the whole gradient
    and stepped by one AdamW (`update`, `DataRanks.step`), and
    `training_step` returns the global loss.  At one rank this is the
    plain step."""

    def __init__(self, llm_cfg: TransformerConfig, lr=1e-5, weight_decay=0.01, grad_clip=1.0,
                 warmup_steps=0, seed=0, *, device="cuda", llm: Optional[Decoder] = None,
                 mesh: Optional[pm.MeshConfig] = None):
        world = pd.world_size()
        mesh_cfg = (mesh or pm.MeshConfig()).resolve(world)
        if llm is None:
            device = torch.device(device)
            if world > 1 and device.type == "cuda" and device.index is None:
                device = pd.rank_device("cuda")
            llm = build_decoder(llm_cfg, device=device, seed=seed)
        self.llm = llm
        self.device = self.llm.embed_tokens.weight.device
        self.mesh = pm.make_mesh(mesh_cfg, self.device.type) if world > 1 else None
        self.ranks = pm.DataRanks(self.mesh)
        pm.shard_params_fsdp(self.mesh, self.llm, reshard_after_forward=False)
        sched = warmup_constant_schedule(0.0, lr, warmup_steps) if warmup_steps else lr
        self.params = list(self.llm.parameters())
        self.groups = [AdamW([pm.local(p) for p in self.params], sched,
                             weight_decay=weight_decay)]
        self.grad_clip = grad_clip

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     label_count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-(lp . mask).sum() over `label_count` (the batch's own labels by
        default)."""
        kv_lens = batch["attention_mask"].sum(-1).to(torch.int32)
        logits, _ = self.llm(batch["input_ids"], kv_lens=kv_lens)
        shift_logits, shift_labels = logits[:, :-1], batch["labels"][:, 1:]
        mask = (shift_labels != -100).float()
        lp = logprobs_from_logits(shift_logits, shift_labels.clamp_min(0))
        if label_count is None:
            label_count = mask.sum().clamp_min(1)
        return -(lp * mask).sum() / label_count

    def training_step(self, batch: Dict[str, Any]) -> float:
        batch = to_device(batch, self.device)
        label_count = (batch["labels"][:, 1:] != -100).float().sum().clamp_min(1)
        share = self.compute_loss(self.ranks.rows(batch), label_count)
        self.update(self.backward(share))
        return float(self.ranks.sum(share.detach().clone()))


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


class PrismaticAlignTrainer(_Trainer):
    """The prismatic pretraining 'align' stage: caption next-token loss
    through `OpenVLA.lm_forward`, only the projector trained (AdamW at
    optax's defaults), every other VLA parameter frozen.  The frozen
    parameters still get gradients: the reference clips by the global norm
    of all of them before its `multi_transform`."""

    def __init__(self, vla: nn.Module, lr: float = 1e-3, grad_clip: float = 1.0):
        self.vla = vla
        self.labels = {name: "projector" if "projector" in name else "frozen"
                       for name, _ in vla.named_parameters()}
        named = list(vla.named_parameters())
        trained = [p for n, p in named if self.labels[n] == "projector"]
        self.params = trained + [p for n, p in named if self.labels[n] == "frozen"]
        self.groups = [AdamW(trained, lr)]
        self.grad_clip = grad_clip
        self.device = next(vla.parameters()).device

    def compute_loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """-mean log p(label) over the labels that are not IGNORE_INDEX, in
        f32; position i predicts token i+1."""
        logits = self.vla.lm_forward(batch["input_ids"], batch["pixel_values"],
                                     batch["attention_mask"])
        labels = batch["labels"][:, 1:]
        lp = logprobs_from_logits(logits[:, :-1].float(), labels.clamp_min(0))
        mask = (labels != IGNORE_INDEX).float()
        return -(lp * mask).sum() / mask.sum().clamp_min(1.0)

    def training_step(self, batch: Dict[str, Any]) -> float:
        loss = self.compute_loss(to_device(batch, self.device))
        self.update(self.backward(loss))
        return float(loss.detach())

"""PRIME's implicit process reward model worker (port of
vla_rft_tpu/workers/prime_rm.py, verl's recipe/prime/prime_dp_rm.py).

The reward model is a causal LM.  Each response token's process score is
log p_rm(token) - log p_ref(token) at temperature 1 (`compute_log_probs`),
optionally collapsed onto the last valid token (`whole` granularity) and
normalised over the batch (`prime_norm`).  The RM trains online: one
AdamW step per training step after clipping by the global norm, on the CE
loss of its summed scores against the verifier's outcome (`ce`) or on the
DPO loss against its group's detached Q values (`dpo`).

The reference differentiates the whole batch in one program.  Here the
gradient is accumulated in f32 over micro-batches of whole groups
(`update_micro_batch` rows, a multiple of n_samples), then clipped and
applied once: the same update up to summation order.  Every batch-wide
term keeps its whole-batch meaning: the `ce` loss and the `dpo` loss with
`bon_mode` none are means over the B rows (each micro-batch adds its mean x
rows / B), the `bon_*` losses sums, `prime/dpo_acc` a mean over the groups;
the DPO's group Q values and accs come from the micro-batch's own whole
groups.  `prime_norm` divides by a max over the whole batch, so it is
applied once the scoring chunks are joined.

Over ranks (`ranks`, the trainer's `parallel/mesh.py::DataRanks`) every
method takes the global rows and works on this rank's share of them, whole
groups as the trainer lays them out: the scores are gathered before
`prime_norm`; an update's micro-batches are the rank's own, each loss
divided as the global batch divides, the gradient summed over the data
ranks and clipped by the norm of the whole gradient, and the metrics
summed over the ranks.  A forward without gradients holds the RM (or the
reference) whole for the call (`mesh.gathered`); the update runs sharded.

The reference log-probs do not depend on the RM's weights: a caller may
compute them once a step and hand them to both the score and the update
(`ref_log_probs`, which the reference's update accepts too).  The trainer
hands in its reference policy's, which is this worker's `ref`.  On the card every forward runs kernel #1 per layer (and
once more per layer when the decoder's `remat` recomputes it), every
backward #2 and #3.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from vla_rft_tpu_torch.models.transformer import Decoder
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.trainer import prime_core
from vla_rft_tpu_torch.trainer.optim import AdamW
from vla_rft_tpu_torch.workers.llm_rollout import compute_log_probs


@dataclasses.dataclass
class PRIMERMConfig:
    response_length: int
    beta: float = 0.05
    granularity: str = "token"  # 'token' | 'whole'
    norm_mode: str = "batch_norm"
    loss_type: str = "ce"  # 'ce' | 'dpo'
    bon_mode: str = "none"  # 'none' | 'bon_rm' | 'bon_acc'
    lr: float = 1e-6
    grad_clip: float = 10.0
    n_samples: int = 4
    # rows per forward: the RM's scoring log-probs, the reference's
    # log-probs, and an update's micro-batch (rounded down to whole groups,
    # at least one); None is the whole batch
    score_micro_batch: Optional[int] = None
    ref_micro_batch: Optional[int] = None
    update_micro_batch: Optional[int] = None


class PRIMERewardWorker:
    """The RM `model` (trained) and its reference `ref` (frozen; never an
    alias of the trained weights), both `Decoder`s, placed by the caller;
    `ranks` the data ranks (None: one process)."""

    def __init__(self, model: Decoder, ref: Decoder, cfg: PRIMERMConfig,
                 ranks: Optional[pm.DataRanks] = None):
        if ref is model:
            raise ValueError("the PRIME reference must be a copy of its own")
        self.model = model.requires_grad_(True).train()
        self.ref = ref.requires_grad_(False).eval()
        self.cfg = cfg
        self.ranks = ranks or pm.DataRanks(None)
        self.params = list(model.parameters())
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """optax.adamw(lr) with optax's default weight decay (1e-4), afresh
        (over this rank's shards)."""
        self.opt = AdamW([pm.local(p) for p in self.params], self.cfg.lr)

    @torch.no_grad()
    def load(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The RM and its reference both from a `Decoder` state dict, and the
        optimizer afresh."""
        pm.load_full_state_dict(self.model, state_dict)
        pm.load_full_state_dict(self.ref, state_dict)
        self.reset_optimizer()

    # ------------------------------------------------------------- scores
    def _log_probs(self, model: Decoder, input_ids, attention_mask, position_ids,
                   chunk: Optional[int], grad: bool = False) -> torch.Tensor:
        B = input_ids.shape[0]
        chunk = chunk or B
        return torch.cat([
            compute_log_probs(model, input_ids[i:i + chunk], attention_mask[i:i + chunk],
                              position_ids[i:i + chunk], self.cfg.response_length, 1.0,
                              grad=grad)[0]
            for i in range(0, B, chunk)])

    @torch.no_grad()
    def _local_ref(self, input_ids, attention_mask, position_ids) -> torch.Tensor:
        with pm.gathered(self.ref):
            return self._log_probs(self.ref, input_ids, attention_mask, position_ids,
                                   self.cfg.ref_micro_batch)

    @torch.no_grad()
    def ref_log_probs(self, input_ids, attention_mask, position_ids) -> torch.Tensor:
        """(B, R) f32 log-probs of the responses under the frozen reference,
        `ref_micro_batch` rows a forward."""
        rows = self.ranks.rows
        return self.ranks.gather(self._local_ref(rows(input_ids), rows(attention_mask),
                                                 rows(position_ids)))

    def _token_scores(self, lp: torch.Tensor, ref: torch.Tensor,
                      attention_mask: torch.Tensor):
        """The implicit process scores lp - ref on the response mask (with
        `whole`, their sum at the last valid token) and the mask."""
        R = self.cfg.response_length
        scores = lp - ref
        mask = attention_mask[:, -R:].float()
        if self.cfg.granularity == "whole":
            last = (mask.sum(-1).to(torch.int32) - 1).clamp_min(0).long()[:, None]
            total = (scores * mask).sum(-1, keepdim=True)
            scores = torch.zeros_like(scores).scatter(1, last, total)
        return scores * mask, mask

    @torch.no_grad()
    def compute_rm_score(self, input_ids, attention_mask, position_ids,
                         ref_log_probs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, R) f32 process scores, `prime_norm`ed over the whole batch; the
        RM's log-probs `score_micro_batch` rows a forward."""
        rows = self.ranks.rows
        seqs = (rows(input_ids), rows(attention_mask), rows(position_ids))
        with pm.gathered(self.model):
            lp = self._log_probs(self.model, *seqs, self.cfg.score_micro_batch)
        ref = self._local_ref(*seqs) if ref_log_probs is None else rows(ref_log_probs)
        scores, _ = self._token_scores(lp, ref, seqs[1])
        return prime_core.prime_norm(self.ranks.gather(scores), self.cfg.norm_mode)

    # ------------------------------------------------------------- update
    def _micro_batch(self, B: int) -> int:
        n = self.cfg.n_samples
        rows = self.cfg.update_micro_batch or B
        return min(B, max(n, rows - rows % n))

    def _loss(self, mb: Dict[str, torch.Tensor], B: int):
        """A micro-batch's share of the whole batch's loss and of its
        `prime/dpo_acc` (both already divided as the whole batch divides)."""
        cfg, n = self.cfg, self.cfg.n_samples
        lp = self._log_probs(self.model, mb["input_ids"], mb["attention_mask"],
                             mb["position_ids"], None, grad=True)
        s, mask = self._token_scores(lp, mb["ref_log_probs"], mb["attention_mask"])
        acc, b = mb["acc"], lp.shape[0]
        if cfg.loss_type == "ce":
            loss = prime_core.compute_ce_dpo_loss_rm(s, acc, mask, cfg.beta) * (b / B)
        else:
            q = (s * mask).sum(-1).detach()
            q_bc = q.reshape(-1, n).repeat_interleave(n, dim=0)  # (b, n): the row's group
            acc_bc = acc.reshape(-1, n).repeat_interleave(n, dim=0)
            loss = prime_core.compute_detach_dpo_loss_rm(s, acc, q_bc, acc_bc, mask, cfg.beta,
                                                         cfg.bon_mode)
            if cfg.bon_mode == "none":
                loss = loss * (b / B)
        dpo_acc = prime_core.compute_dpo_accuracy(s.detach(), acc, mask, n) * (b / B)
        return loss, dpo_acc

    def update_rm(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One optimizer step on `batch` (input_ids, attention_mask,
        position_ids, acc, and optionally ref_log_probs): the gradient summed
        in f32 over micro-batches of whole groups (of this rank's rows) and
        over the data ranks, clipped by its global norm (grad_clip), one
        AdamW step.  Returns prime/rm_loss and prime/dpo_acc of the weights
        before the step."""
        B = batch["input_ids"].shape[0]
        keys = ("input_ids", "attention_mask", "position_ids", "acc", "ref_log_probs")
        b = self.ranks.rows(batch["input_ids"]).shape[0]
        if B % self.cfg.n_samples or b % self.cfg.n_samples:
            raise ValueError(f"{B} rows ({b} on this rank) are not whole groups of "
                             f"{self.cfg.n_samples}")
        mine = {k: self.ranks.rows(batch[k]) for k in keys[:4]}
        mine["ref_log_probs"] = (self._local_ref(*(mine[k] for k in keys[:3]))
                                 if batch.get("ref_log_probs") is None
                                 else self.ranks.rows(batch["ref_log_probs"]))
        step = self._micro_batch(b)
        total: Optional[List[torch.Tensor]] = None
        loss_sum = acc_sum = 0.0
        for i in range(0, b, step):
            mb = {k: mine[k][i:i + step] for k in keys}
            loss, dpo_acc = self._loss(mb, B)
            self.ranks.backward(loss)
            with torch.no_grad():
                grads = self.ranks.take_grads(self.params)
                if total is None:
                    total = [g.float() for g in grads]
                else:
                    for t, g in zip(total, grads):
                        t.add_(g.float())
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + dpo_acc
            del grads, loss
        self.ranks.step(self.params, [self.opt], self.cfg.grad_clip, total)
        rm_loss, dpo_acc = self.ranks.sum(torch.stack([
            torch.as_tensor(x, dtype=torch.float32, device=total[0].device).reshape(())
            for x in (loss_sum, acc_sum)])).tolist()
        return {"prime/rm_loss": rm_loss, "prime/dpo_acc": dpo_acc}

"""What each rank of the parallel tests runs (see torch_parallel_ranks.py).
Every function takes the parent's inputs and returns this rank's results.
Imports no JAX."""
from __future__ import annotations

import torch
import torch.distributed as dist

from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.parallel.pp import decoder_pp_forward, pipeline_spmd
from vla_rft_tpu_torch.parallel.tp import shard_decoder_params_tp
from vla_rft_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_pad_and_slice


def decoder(cfg: dict, sd, **kw) -> Decoder:
    m = Decoder(TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **cfg, **kw))
    m.load_state_dict(sd, strict=True)
    return m


def _placements(module):
    return {k: pm.placement_dim(p) for k, p in module.named_parameters()}


def _grads(module, reduce: bool):
    """{name: grad} summed over the world when `reduce` (a rank's partial
    gradients of a sharded computation)."""
    out = {}
    for k, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        out[k] = pd.all_reduce(g) if reduce else g
    return out


def modules(inp):
    W, r = pd.world_size(), pd.rank()
    out = {}
    ids = inp["ids"]

    # tensor parallelism: the whole world on tp
    mesh = pm.make_mesh(pm.MeshConfig(dp=1, tp=W), "cpu")
    for name in ("tp", "tp_gqa") if W == 2 else ("tp",):
        cfg, sd, x = inp[name]
        m = decoder(cfg, sd)
        shard_decoder_params_tp(mesh, m)
        out[f"{name}_place"] = _placements(m)
        with torch.no_grad():
            out[f"{name}_logits"] = m(x)[0]
        if name == "tp":
            cache = m.init_cache(x.shape[0], 16)
            try:
                m(x[:, :4], cache=cache, cache_index=0)
                out["tp_cache_error"] = None
            except ValueError as e:
                out["tp_cache_error"] = str(e)

    # Ulysses: the whole world on sp
    mesh = pm.make_mesh(pm.MeshConfig(dp=1, sp=W), "cpu")
    group = mesh["sp"].get_group()
    for name in ("sp_mha", "sp_gqa", "sp_pad"):
        q, k, v, kv_lens = inp[name]
        if name == "sp_pad":
            q, _ = ulysses_pad_and_slice(q, W)
            k, _ = ulysses_pad_and_slice(k, W)
            v, pad = ulysses_pad_and_slice(v, W)
            out["sp_pad_pad"] = pad
        s = q.shape[1] // W
        sl = slice(r * s, (r + 1) * s)
        out[name] = ulysses_attention(q[:, sl], k[:, sl], v[:, sl], group, causal=True,
                                      kv_lens=kv_lens)
    cfg, sd = inp["sp_decoder"]
    m = decoder(cfg, sd, ulysses_axis=group)
    B, S = ids.shape
    s = S // W
    sl = slice(r * s, (r + 1) * s)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)[:, sl]
    logits, _ = m(ids[:, sl], positions=pos, kv_lens=torch.full((B,), S, dtype=torch.int32))
    out["sp_decoder_logits"] = logits.detach()
    (logits ** 2).sum().div(B * S * logits.shape[-1]).backward()
    out["sp_decoder_grads"] = _grads(m, reduce=True)

    # the pipeline: the whole world is one pp group
    world = dist.group.WORLD
    ws = torch.linspace(0.5, 1.5, W * 2)
    lw = ws[2 * r: 2 * r + 2]

    def stage(x):
        for w in lw:
            x = x * w + 1.0
        return x

    out["pipe"] = pipeline_spmd(stage, inp["pipe_x"][:2 * W], world)
    for name, M, last in (("pp_m_p", W, False), ("pp_m_2p", 2 * W, False),
                          ("pp_tied_last", 4, True)):
        cfg, sd, x = inp["pp_tied_last" if last else "pp"]
        m = decoder(cfg, sd)
        with torch.no_grad():
            out[name] = decoder_pp_forward(m, x, world, n_microbatches=M, logits_last_only=last)
    cfg, sd, x = inp["pp_grad"]
    m = decoder(cfg, sd)
    logits, _ = decoder_pp_forward(m, x, world, n_microbatches=4)
    (logits ** 2).mean().backward()
    g = _grads(m, reduce=False)
    # a layer's gradient lives on its stage: sum the stages' to compare
    out["pp_grads"] = {k: pd.all_reduce(v) if k.startswith("layers.") else v
                       for k, v in g.items()}

    # FSDP placement and a forward through FSDP2's hooks
    mesh = pm.make_mesh(pm.MeshConfig(dp=1, fsdp=W), "cpu")
    for name, min_size in (("fsdp", 2 ** 16), ("fsdp_small", 1024)):
        cfg, sd, x = inp["fsdp"]
        m = decoder(cfg, sd)
        pm.shard_params_fsdp(mesh, m, min_size=min_size)
        out[f"{name}_place"] = _placements(m)
        with torch.no_grad():
            out[f"{name}_logits"] = m(x)[0]
            out[f"{name}_full_sd"] = {k: v.clone() for k, v in pm.full_state_dict(m).items()}
            pm.load_full_state_dict(m, {k: v + 1 for k, v in sd.items()})
            out[f"{name}_reloaded"] = pm.full_state_dict(m)

    # the batch split over (dp, fsdp); tp / sp ranks share rows
    mesh = pm.make_mesh(pm.MeshConfig(dp=W // 2, fsdp=2), "cpu")
    out["batch"] = pm.shard_batch(mesh, {"a": inp["batch"]})["a"]
    mesh = pm.make_mesh(pm.MeshConfig(dp=W // 2, tp=2), "cpu")
    out["batch_tp"] = pm.shard_batch(mesh, inp["batch"])
    return out


# ----------------------------------------------------------------- the slice
def _same_as(module, sd) -> bool:
    got = pm.full_state_dict(module)
    return set(got) == set(sd) and all(torch.equal(got[k], sd[k].to(got[k].dtype))
                                       for k in sd)


def grpo(inp):
    """One tiny training_step per case (mesh, FSDP size floor) from the same
    weights, batch and pinned draws; a floor under the reference's 2^16
    lets FSDP2 shard the tiny expert too."""
    import functools

    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer

    out, shard = {}, pm.shard_params_fsdp
    for name, mesh, min_size in inp["cases"]:
        cfg = vla_rft_default_config().apply_overrides(
            inp["argv"] + [f"mesh.{k}={v}" for k, v in mesh.items()])
        pm.shard_params_fsdp = functools.partial(shard, min_size=min_size)
        try:
            tr = VLARFTGRPOTrainer(cfg, preset="tiny", device="cpu", params=inp["params"])
        finally:
            pm.shard_params_fsdp = shard
        metrics = tr.training_step(inp["batch"], step=1, pinned=inp["pinned"])
        out[name] = dict(
            metrics=metrics,
            expert={k: v.clone() for k, v in pm.full_state_dict(tr.bundle.expert).items()},
            frozen_same={m: _same_as(getattr(tr.bundle, m), inp["params"][m])
                         for m in ("vla", "wm", "tokenizer", "lpips")},
            sharded=sorted(tr._sharded),
            placed={m: pm.is_sharded(getattr(tr.bundle, m))
                    for m in ("vla", "expert", "wm", "tokenizer", "lpips")})
    return out


def cli(inp):
    """main_vla_rft_grpo.run under the ranks' variables (it starts and
    destroys the process group itself); returns what each rank saved."""
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    saved = []

    def on_start(trainer):
        real = trainer.ckpt.save

        def save(step, state):
            saved.append(step)
            return real(step, state)

        trainer.ckpt.save = save

    tr = main_vla_rft_grpo.run(inp["argv"], on_start=on_start)
    return dict(saved=saved, global_steps=tr.global_steps, world=tr.world,
                data=(tr.data_index, tr.data_count),
                expert={k: v.clone() for k, v in tr.bundle.expert.state_dict().items()},
                group_destroyed=not dist.is_initialized())


# ------------------------------------------------------------- text RL, SFT
class FixedBatch:
    """A dataset whose every batch is `batch` (validate() draws from it)."""

    def __init__(self, batch):
        self.batch = batch

    def sample_batch(self, b):
        assert b == len(self.batch["input_ids"])
        return self.batch


def _rank_rows(tr, rollout):
    """A `_gen` that hands this data rank its rows of the global `rollout`,
    checking that they are the rows of the prompts it was given."""

    def gen(prompts, _gen):
        per = rollout["input_ids"].shape[0] // tr.ranks.count
        sl = slice(tr.ranks.index * per, (tr.ranks.index + 1) * per)
        assert torch.equal(prompts.to(torch.int32), rollout["prompts"][sl])
        return {k: v[sl].clone() for k, v in rollout.items()}

    return gen


def _whole(module):
    return None if module is None else {k: v.clone()
                                        for k, v in pm.full_state_dict(module).items()}


def ppo(inp):
    """One PPOTrainer.training_step per case (name, mesh, FSDP size floor,
    settings, batch key) from the parent's weights and batch, each rank's
    rollout its rows of the parent's global one (a case named remat* with
    the decoders' remat); with `validate`, the case's validate() on the
    same rows.  A case whose step raises a
    ValueError returns its message."""
    import dataclasses
    import functools

    from text_rl_data import BASE, CFG, DigitTokenizer, toy_score
    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.trainer.ppo_trainer import PPOTrainer
    from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager

    out, shard = {}, pm.shard_params_fsdp
    cfg_t = TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)
    for name, mesh, min_size, settings, key in inp["cases"]:
        cfg = vla_rft_default_config().apply_overrides(
            [f"{k}={v}" for k, v in {**BASE, **inp["base"], **settings}.items()]
            + [f"mesh.{k}={v}" for k, v in mesh.items()])
        batch, rollouts = inp["batches"][key], inp["rollouts"][key]
        pm.shard_params_fsdp = functools.partial(shard, min_size=min_size)
        try:
            tr = PPOTrainer(cfg, dataclasses.replace(cfg_t, remat=name.startswith("remat")),
                            DigitTokenizer(), FixedBatch(batch),
                            reward_manager=NaiveRewardManager(DigitTokenizer(),
                                                              compute_score=toy_score),
                            device="cpu")
        finally:
            pm.shard_params_fsdp = shard
        tr.load_actor(inp["actor"])
        if name in inp["ref"]:
            pm.load_full_state_dict(tr.ref, inp["ref"][name])
        for m, k in ((tr.critic, "critic"), (tr.rm, "rm")):
            if m is not None:
                pm.load_full_state_dict(m, inp[k])
        tr._gen = _rank_rows(tr, rollouts["sample"])
        tr._gen_greedy = _rank_rows(tr, rollouts["greedy"])
        ref_start = _whole(tr.ref)
        try:
            metrics = tr.training_step(batch, torch.Generator().manual_seed(0))
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        prime = tr.prime_rm
        out[name] = dict(
            metrics={k: v for k, v in metrics.items() if not k.startswith("timing_s/")},
            actor=_whole(tr.llm), critic=_whole(tr.critic),
            prime=None if prime is None else _whole(prime.model),
            ref_unmoved=all(torch.equal(v, ref_start[k]) for k, v in _whole(tr.ref).items()),
            data=(tr.ranks.index, tr.ranks.count),
            sharded={m: pm.is_sharded(x) for m, x in (("llm", tr.llm), ("ref", tr.ref),
                                                      ("critic", tr.critic), ("rm", tr.rm))
                     if x is not None},
            validate=tr.validate(torch.Generator().manual_seed(3)) if "validate" in key else None)
    return out


def sft(inp):
    """SFTTrainer steps per case (name, mesh, FSDP size floor) from the
    parent's decoder weights over its global batches: the losses and the
    trained decoder."""
    import functools

    from vla_rft_tpu_torch.trainer.sft_trainer import SFTTrainer

    out, shard = {}, pm.shard_params_fsdp
    for name, mesh, min_size in inp["cases"]:
        llm = decoder(inp["cfg"], inp["sd"])
        pm.shard_params_fsdp = functools.partial(shard, min_size=min_size)
        try:
            tr = SFTTrainer(None, lr=inp["lr"], warmup_steps=inp["warmup"], llm=llm,
                            mesh=pm.MeshConfig(**mesh))
        finally:
            pm.shard_params_fsdp = shard
        losses = [tr.training_step(b) for b in inp["batches"]]
        out[name] = dict(losses=losses, llm=_whole(tr.llm), sharded=pm.is_sharded(tr.llm),
                         data=(tr.ranks.index, tr.ranks.count))
    return out


def text(inp):
    """The ppo and sft suites in one start of the ranks."""
    return {"ppo": ppo(inp["ppo"]), "sft": sft(inp["sft"])}


def text_cli(inp):
    """main_ppo.run and main_sft.run (sft.mode=text, then a VLA mode) under
    the ranks' variables, with the Qwen config patched tiny; each run
    starts and destroys the process group itself, on a port of its own
    (a second group on one port's store does not start).  Returns what each
    printed, the trained weights and the VLA mode's refusal."""
    import contextlib
    import io
    import os

    import transformers
    from transformers import PreTrainedTokenizerFast

    from text_rl_data import CFG
    from vla_rft_tpu_torch.models import transformer as t_tf
    from vla_rft_tpu_torch.trainer import main_ppo, main_sft

    tiny = TransformerConfig(dtype=torch.float32, param_dtype=torch.float32, **CFG)
    t_tf.TransformerConfig.qwen25_0_5b = staticmethod(lambda: tiny)
    # AutoTokenizer gives PreTrainedTokenizerFast for sft_data's directory
    transformers.AutoTokenizer = type("AutoTokenizer", (), {"from_pretrained": staticmethod(
        lambda path, *a, **kw: PreTrainedTokenizerFast.from_pretrained(path, *a, **kw))})
    out = {}
    ports = iter(inp["ports"])  # a fresh store for each group the runs start
    for name, fn, argv in (("ppo", main_ppo.run, inp["ppo"]), ("sft", main_sft.run, inp["sft"])):
        os.environ["MASTER_PORT"] = str(next(ports))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(argv)
        tr = res if name == "ppo" else res.trainer
        out[name] = dict(printed=buf.getvalue(), group_destroyed=not dist.is_initialized(),
                         llm={k: v.clone() for k, v in tr.llm.state_dict().items()},
                         data=(tr.ranks.index, tr.ranks.count), sharded=pm.is_sharded(tr.llm))
        if name == "ppo":
            out[name]["ref"] = {k: v.clone() for k, v in tr.ref.state_dict().items()}
        else:
            out[name]["losses"] = res.losses
    os.environ["MASTER_PORT"] = str(next(ports))
    try:
        main_sft.run(inp["vla"])
        out["vla_error"] = None
    except ValueError as e:
        out["vla_error"] = str(e)
    out["vla_group_destroyed"] = not dist.is_initialized()
    return out

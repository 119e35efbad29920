"""Open-X-Embodiment mixture registry and weighted multi-dataset sampling
(port of vla_rft_tpu/data/oxe.py).

The reference's OXE mixture machinery (prismatic/vla/datasets/rlds/oxe/:
mixtures.py's named weighted mixtures, transforms.py's per-dataset
standardisation, materialize.py's weight normalisation and interleave) runs
as tf.data transforms over raw TFDS trajectories; here standardisation is a
numpy hook on the decoded episode ({images, actions, states, lang}) and the
mixing happens per window over per-dataset reservoir streams, with the same
sampling (each window drawn from dataset i with probability w_i / sum w).
Each component normalises with its own statistics before mixing, as the
reference's rlds/dataset.py does inside each dataset's pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vla_rft_tpu_torch.data.rlds import (
    RLDSConfig,
    RLDSDataset,
    assemble_vla_batch,
)

# --------------------------------------------------------------------------
# gripper/action helpers (rlds/utils/data_utils.py semantics, numpy)
# --------------------------------------------------------------------------


def invert_gripper_actions(g: np.ndarray) -> np.ndarray:
    """1-g: datasets encoding +1=close become the OpenVLA convention
    +1=open / 0=close (data_utils.invert_gripper_actions)."""
    return 1.0 - g


def binarize_gripper_actions(g: np.ndarray, open_thresh=0.95, close_thresh=0.05) -> np.ndarray:
    """Continuous [0,1] gripper -> binary with the reference's sticky rule
    (data_utils.binarize_gripper_actions, a reversed tf.scan): ambiguous
    middle values take the NEXT definite command, so a closing ramp reads
    as 'close' for its whole duration; trailing ambiguity keeps the raw
    final value (the scan's initializer is actions[-1])."""
    g = np.asarray(g, np.float32)
    out = np.empty_like(g)
    carried = float(g[-1])
    for i in range(len(g) - 1, -1, -1):
        if g[i] > open_thresh:
            carried = 1.0
        elif g[i] < close_thresh:
            carried = 0.0
        out[i] = carried
    return out


def relabel_actions_from_states(ep: Dict[str, Any]) -> Dict[str, Any]:
    """bridge relabeling (data_utils.relabel_bridge_actions): movement
    actions become next_state - state over the first 6 proprio dims; the
    last window keeps its original action."""
    if ep.get("states") is None or len(ep["actions"]) < 2:
        return ep
    st = np.asarray(ep["states"], np.float32)
    acts = np.array(ep["actions"], np.float32, copy=True)
    n = min(len(acts) - 1, len(st) - 1)
    acts[:n, :6] = st[1 : n + 1, :6] - st[:n, :6]
    ep["actions"] = acts
    return ep


# --------------------------------------------------------------------------
# per-dataset standardization (transforms.py analog, episode-level numpy)
# --------------------------------------------------------------------------


def _t_identity(ep):
    return ep


def _t_libero(ep):
    """libero_dataset_transform (transforms.py:827-841): gripper -1(open)..
    1(close) -> clip 0..1 -> invert (+1 = open)."""
    a = np.array(ep["actions"], np.float32, copy=True)
    a[:, -1] = invert_gripper_actions(np.clip(a[:, -1], 0.0, 1.0))
    ep["actions"] = a
    return ep


def _t_bridge_orig(ep):
    """bridge_orig_dataset_transform (transforms.py:61-87): drop the all-zero
    first step, binarize the gripper, relabel movement from states."""
    ep = {**ep}
    ep["images"] = ep["images"][1:]
    ep["actions"] = np.asarray(ep["actions"], np.float32)[1:]
    if ep.get("states") is not None:
        ep["states"] = np.asarray(ep["states"], np.float32)[1:]
    a = np.array(ep["actions"], copy=True)
    a[:, -1] = binarize_gripper_actions(a[:, -1])
    ep["actions"] = a
    return relabel_actions_from_states(ep)


def _t_rt1(ep):
    """rt1_dataset_transform (transforms.py:102-124): gripper closedness in
    [0,1], +1=close -> clip + invert to +1=open."""
    a = np.array(ep["actions"], np.float32, copy=True)
    a[:, -1] = invert_gripper_actions(np.clip(a[:, -1], 0.0, 1.0))
    ep["actions"] = a
    return ep


def _t_binarize_invert(ep):
    """Generic continuous-closedness datasets (kuka/taco_play family)."""
    a = np.array(ep["actions"], np.float32, copy=True)
    a[:, -1] = invert_gripper_actions(binarize_gripper_actions(np.clip(a[:, -1], 0.0, 1.0)))
    ep["actions"] = a
    return ep


STANDARDIZATION: Dict[str, Callable[[Dict[str, Any]], Dict[str, Any]]] = {
    "bridge_orig": _t_bridge_orig,
    "fractal20220817_data": _t_rt1,
    "kuka": _t_binarize_invert,
    "taco_play": _t_binarize_invert,
    "libero_spatial_no_noops": _t_libero,
    "libero_object_no_noops": _t_libero,
    "libero_goal_no_noops": _t_libero,
    "libero_10_no_noops": _t_libero,
}


def get_standardization(name: str) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    return STANDARDIZATION.get(name, _t_identity)


# --------------------------------------------------------------------------
# named mixtures (mixtures.py OXE_NAMED_MIXTURES — weights kept verbatim
# for sampling parity; entries are (tfds dataset name, sampling weight))
# --------------------------------------------------------------------------

OXE_NAMED_MIXTURES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_orig", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    # mixtures.py:28-41
    "rtx": [
        ("fractal20220817_data", 0.54087122203),
        ("kuka", 0.8341046294),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 2.0),
        ("berkeley_cable_routing", 3.0),
        ("roboturk", 1.0),
        ("viola", 2.0),
        ("berkeley_autolab_ur5", 1.0),
        ("toto", 1.0),
    ],
    # mixtures.py oxe_magic_soup_plus (the OpenVLA pretraining mixture)
    "oxe_magic_soup_plus": [
        ("fractal20220817_data", 0.54087122203),
        ("kuka", 0.8341046294),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 1.0),
        ("berkeley_cable_routing", 1.0),
        ("roboturk", 2.0),
        ("viola", 2.0),
        ("berkeley_autolab_ur5", 2.0),
        ("toto", 1.0),
        ("language_table", 0.1),
        ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
        ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
        ("utaustin_mutex", 1.0),
        ("berkeley_fanuc_manipulation", 2.0),
        ("cmu_stretch", 1.0),
        ("bc_z", 0.2),
        ("fmb_dataset", 1.0),
        ("dobbe", 0.2),
        ("droid", 0.06),
    ],
    # LIBERO fine-tuning mixtures (mixtures.py:197-214)
    "libero_spatial_no_noops": [("libero_spatial_no_noops", 1.0)],
    "libero_object_no_noops": [("libero_object_no_noops", 1.0)],
    "libero_goal_no_noops": [("libero_goal_no_noops", 1.0)],
    "libero_10_no_noops": [("libero_10_no_noops", 1.0)],
    "libero_4_task_suites_no_noops": [
        ("libero_spatial_no_noops", 1.0),
        ("libero_object_no_noops", 1.0),
        ("libero_goal_no_noops", 1.0),
        ("libero_10_no_noops", 1.0),
    ],
}


# --------------------------------------------------------------------------
# weighted mixture dataset
# --------------------------------------------------------------------------


@dataclasses.dataclass
class MixtureComponent:
    name: str
    dataset: RLDSDataset
    weight: float
    transform: Callable[[Dict[str, Any]], Dict[str, Any]]


class WeightedMixtureDataset:
    """Weighted interleave over per-dataset reservoir streams.

    Equivalent role to make_interleaved_dataset (rlds/dataset.py) +
    get_oxe_dataset_kwargs_and_weights (oxe/materialize.py:34-133): weights
    are normalized over the components actually present, each batch slot
    draws its source dataset iid by weight, and every component normalizes
    with its OWN statistics before mixing.  Exposes the same next_batch /
    state_dict surface as RLDSDataset so trainers don't care which they get.
    """

    def __init__(
        self,
        components: Sequence[MixtureComponent],
        tokenizer,
        batch_size: int,
        max_seq_len: int = 96,
        pad_token_id: int = 151643,
        image_aug: bool = False,
        seed: int = 0,
    ):
        if not components:
            raise ValueError("mixture needs at least one present component")
        self.components = list(components)
        total = sum(c.weight for c in self.components)
        self.probs = np.array([c.weight / total for c in self.components])
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.pad_token_id = pad_token_id
        self.image_aug = image_aug
        self.seed = seed
        self._step = 0
        # install the standardization hook on each component's streams
        for c in self.components:
            for s in c.dataset._streams:
                s.episode_transform = c.transform

    @property
    def stats(self) -> Dict[str, Any]:
        """Per-dataset statistics keyed by component name (the reference
        saves per-dataset stats for later un-normalization)."""
        return {c.name: c.dataset.stats for c in self.components}

    def next_batch(self) -> Dict[str, np.ndarray]:
        self._step += 1
        rng = np.random.default_rng((self.seed, self._step))
        counts = rng.multinomial(self.batch_size, self.probs)
        windows: List[Dict[str, Any]] = []
        for c, n in zip(self.components, counts):
            if n:
                windows.extend(c.dataset.draw_windows(int(n), rng))
        order = rng.permutation(len(windows))
        windows = [windows[i] for i in order]
        cfg = self.components[0].dataset.cfg
        return assemble_vla_batch(
            windows, self.tokenizer, cfg, rng,
            pad_token_id=self.pad_token_id, max_seq_len=self.max_seq_len,
            image_aug=self.image_aug,
        )

    # resumable: step counter + every component's stream state
    def state_dict(self):
        out = {"step": self._step}
        for c in self.components:
            for k, v in c.dataset.state_dict().items():
                out[f"{c.name}/{k}"] = v
        return out

    def load_state_dict(self, state):
        self._step = int(state["step"])
        for c in self.components:
            sub = {
                k.split("/", 1)[1]: v
                for k, v in state.items()
                if k.startswith(c.name + "/")
            }
            if sub:
                c.dataset.load_state_dict(sub)


def make_mixture_dataset(
    mixture: str,
    data_dir: str,
    tokenizer,
    batch_size: int,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    skip_missing: bool = True,
    **kw,
) -> WeightedMixtureDataset:
    """Build a WeightedMixtureDataset from a named mixture.  Components whose
    tfrecords are absent under data_dir/<name>/ are skipped (with a warning)
    when skip_missing — the reference's materialize loop fails hard instead,
    but partial local mirrors are the common case off-cluster."""
    if mixture not in OXE_NAMED_MIXTURES:
        raise KeyError(f"unknown mixture {mixture!r}; have {sorted(OXE_NAMED_MIXTURES)}")
    comps = []
    for name, weight in OXE_NAMED_MIXTURES[mixture]:
        cfg = RLDSConfig(data_dir=data_dir, dataset_name=name, **(cfg_overrides or {}))
        try:
            ds = RLDSDataset(cfg, tokenizer, batch_size=batch_size, **kw)
        except FileNotFoundError:
            if not skip_missing:
                raise
            print(f"[oxe] mixture {mixture!r}: component {name!r} missing, skipping")
            continue
        comps.append(MixtureComponent(name, ds, weight, get_standardization(name)))
    return WeightedMixtureDataset(
        comps, tokenizer, batch_size,
        image_aug=kw.get("image_aug", False),
        seed=(cfg_overrides or {}).get("seed", 0),
    )

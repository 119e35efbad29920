"""The port's OXE mixtures (data/oxe.py) and batch prefetcher
(data/prefetch.py) against the JAX package, on the CPU.

Episodes come from numpy with fixed seeds and are written by the
reference's make_episode_example; every comparison is exact (the
standardisations are numpy in both packages, the batches those of
tests/test_torch_rlds.py).
"""
import io
import time

import numpy as np
import pytest
import tensorflow  # noqa: F401  (the reference's decode imports it: here, not in a test)
from PIL import Image

from vla_rft_tpu.data import oxe as j_oxe
from vla_rft_tpu.data import rlds as j_rlds
from vla_rft_tpu.data import tfrecord as j_tf
from vla_rft_tpu_torch.data import oxe as t_oxe
from vla_rft_tpu_torch.data import rlds as t_rlds
from vla_rft_tpu_torch.data.prefetch import PrefetchingLoader
from vla_rft_tpu_torch.eval.policy import _StubTokenizer

TOK = _StubTokenizer()
SIZES = dict(window_frames=9, action_chunk=8, policy_image_size=28, wm_image_size=32)


def _assert_batches_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _write_ds(tmp_path, name, bias, seed, n_episodes=3, T=12):
    rng = np.random.default_rng(seed)
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    cfg = j_rlds.RLDSConfig()
    payloads = []
    for e in range(n_episodes):
        imgs = []
        for _ in range(T):
            b = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)).save(b, "JPEG")
            imgs.append(b.getvalue())
        actions = rng.uniform(-0.4, 0.4, (T, 7)) + bias
        actions[:, -1] = rng.uniform(-1, 1, T)  # a gripper in [-1, 1]
        payloads.append(j_rlds.make_episode_example(imgs, actions, rng.normal(size=(T, 8)),
                                                    f"{name} {e}", cfg))
    j_tf.write_records(str(d / "shard-0.tfrecord"), payloads)


def _episode(seed, T=10):
    rng = np.random.default_rng(seed)
    return {"images": list(range(T)), "actions": rng.uniform(-1, 1, (T, 7)).astype(np.float32),
            "states": rng.normal(size=(T, 8)).astype(np.float32), "lang": "x"}


def test_gripper_helpers_and_relabel_equal_the_reference():
    rng = np.random.default_rng(0)
    for g in (rng.uniform(0, 1, 50), np.array([1.0, 0.7, 0.4, 0.02, 0.3, 0.98]),
              np.array([0.99, 0.5, 0.5]), np.array([0.5])):
        np.testing.assert_array_equal(t_oxe.invert_gripper_actions(g),
                                      j_oxe.invert_gripper_actions(g))
        np.testing.assert_array_equal(t_oxe.binarize_gripper_actions(g),
                                      j_oxe.binarize_gripper_actions(g))
    for ep in (_episode(1), {**_episode(2, T=1)}, {**_episode(3), "states": None}):
        t_out = t_oxe.relabel_actions_from_states({**ep})
        j_out = j_oxe.relabel_actions_from_states({**ep})
        np.testing.assert_array_equal(t_out["actions"], j_out["actions"])


@pytest.mark.parametrize("name", sorted(j_oxe.STANDARDIZATION) + ["an_unknown_dataset"])
def test_standardizations_equal_the_reference(name):
    for seed in range(3):
        t_out = t_oxe.get_standardization(name)(_episode(seed))
        j_out = j_oxe.get_standardization(name)(_episode(seed))
        assert sorted(t_out) == sorted(j_out)
        for k in t_out:
            if k == "lang":
                assert t_out[k] == j_out[k]
            else:
                np.testing.assert_array_equal(np.asarray(t_out[k]), np.asarray(j_out[k]))


def test_named_mixtures_equal_the_reference():
    assert t_oxe.OXE_NAMED_MIXTURES == j_oxe.OXE_NAMED_MIXTURES
    assert sorted(t_oxe.STANDARDIZATION) == sorted(j_oxe.STANDARDIZATION)


def _mixtures(tmp_path):
    """The same two-component mixture (a LIBERO suite and an identity one)
    built by each package."""
    _write_ds(tmp_path, "libero_goal_no_noops", 0.0, 1)
    _write_ds(tmp_path, "ds_b", 5.0, 2)
    out = []
    for rl, ox in ((t_rlds, t_oxe), (j_rlds, j_oxe)):
        comps = [ox.MixtureComponent(
            name, rl.RLDSDataset(rl.RLDSConfig(data_dir=str(tmp_path), dataset_name=name,
                                               shuffle_buffer_size=16, **SIZES),
                                 TOK, batch_size=6), w, ox.get_standardization(name))
            for name, w in (("libero_goal_no_noops", 3.0), ("ds_b", 1.0))]
        out.append(ox.WeightedMixtureDataset(comps, TOK, batch_size=6, image_aug=True, seed=1))
    return out


def test_mixture_draws_and_state_equal_the_reference(tmp_path):
    t_mix, j_mix = _mixtures(tmp_path)
    np.testing.assert_array_equal(t_mix.probs, j_mix.probs)
    assert t_mix.stats == j_mix.stats
    for _ in range(5):
        _assert_batches_equal(t_mix.next_batch(), j_mix.next_batch())
    state = t_mix.state_dict()
    assert state == j_mix.state_dict() and state["step"] == 5
    (tmp_path / "again").mkdir()
    t2, j2 = _mixtures(tmp_path / "again")
    t2.load_state_dict(state)
    j2.load_state_dict(state)
    assert t2.state_dict() == j2.state_dict() == state
    for _ in range(2):
        _assert_batches_equal(t2.next_batch(), j2.next_batch())


def test_make_mixture_dataset_equals_the_reference(tmp_path, capsys):
    _write_ds(tmp_path, "libero_spatial_no_noops", 0.0, 3)
    mixes = [ox.make_mixture_dataset("libero_4_task_suites_no_noops", str(tmp_path), TOK,
                                     batch_size=4, cfg_overrides=SIZES)
             for ox in (t_oxe, j_oxe)]
    assert capsys.readouterr().out.count("missing, skipping") == 6  # 3 of 4, both packages
    assert [c.name for c in mixes[0].components] == [c.name for c in mixes[1].components] == [
        "libero_spatial_no_noops"]
    for _ in range(2):
        _assert_batches_equal(mixes[0].next_batch(), mixes[1].next_batch())
    with pytest.raises(KeyError):
        t_oxe.make_mixture_dataset("nope", str(tmp_path), TOK, batch_size=4)
    with pytest.raises(FileNotFoundError):
        t_oxe.make_mixture_dataset("bridge", str(tmp_path), TOK, batch_size=4,
                                   skip_missing=False)


# ---------------------------------------------------------------- prefetch
class _Counter:
    def __init__(self, fail_at=None, exc=RuntimeError):
        self.i, self.fail_at, self.exc = 0, fail_at, exc

    def next_batch(self):
        self.i += 1
        if self.i == self.fail_at:
            raise self.exc("inner failed")
        return {"i": self.i}

    def state_dict(self):
        return {"step": self.i}

    def load_state_dict(self, s):
        self.i = s["step"]


def test_prefetch_keeps_the_order_and_the_batches(tmp_path):
    _write_ds(tmp_path, "ds", 0.0, 4)
    mk = lambda rl: rl.RLDSDataset(rl.RLDSConfig(data_dir=str(tmp_path), dataset_name="ds",
                                                 shuffle_buffer_size=8, **SIZES), TOK,
                                   batch_size=3, image_aug=True)
    loader, ref = PrefetchingLoader(mk(t_rlds), buffer_size=2), mk(j_rlds)
    try:
        for _ in range(4):
            _assert_batches_equal(loader.next_batch(), ref.next_batch())
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_prefetch_passes_state_through_and_closes():
    inner = _Counter()
    loader = PrefetchingLoader(inner, buffer_size=2)
    assert [loader.next_batch()["i"] for _ in range(5)] == [1, 2, 3, 4, 5]
    deadline = time.time() + 5
    while inner.i < 7 and time.time() < deadline:  # the producer runs ahead, bounded
        time.sleep(0.01)
    assert loader.state_dict() == inner.state_dict() == {"step": 7}
    loader.load_state_dict({"step": 100})
    assert inner.i == 100
    loader.close()
    assert not loader._thread.is_alive()


@pytest.mark.parametrize("exc", [RuntimeError, StopIteration])
def test_prefetch_hands_an_error_to_the_consumer(exc):
    loader = PrefetchingLoader(_Counter(fail_at=3, exc=exc), buffer_size=4)
    assert [loader.next_batch()["i"] for _ in range(2)] == [1, 2]
    with pytest.raises(exc):
        loader.next_batch()
    loader._thread.join(5)
    assert not loader._thread.is_alive()
    loader.close()

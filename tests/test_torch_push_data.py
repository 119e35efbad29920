"""The port's push segment data (vla_rft_tpu_torch/data/push_data.py) against
the JAX package's, on the CPU.

Both collect `CollectConfig(n_segments=12, max_chunks_per_episode=4)` in
their own push env (as tests/test_push_evidence.py collects it) and every
field must be bit-equal; `PushSegmentDataset` batches over the same
segments and index split bit-equal, also after a resume; the segment files
round-trip between the two packages and refuse another renderer's
version; `train_val_split` gives the reference's indices.
"""
import numpy as np
import pytest

from vla_rft_tpu.data import push_data as j_push
from vla_rft_tpu_torch.data import push_data as t_push
from vla_rft_tpu_torch.eval.mujoco_push_env import RENDER_VERSION

CFG = dict(n_segments=12, max_chunks_per_episode=4, seed=0)


@pytest.fixture(scope="module")
def collections():
    pytest.importorskip("mujoco")
    return (t_push.collect_push_segments(t_push.CollectConfig(**CFG)),
            j_push.collect_push_segments(j_push.CollectConfig(**CFG)))


def _assert_same(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_collect_push_segments_equals_the_reference(collections):
    got, ref = collections
    _assert_same(got, ref)
    assert got["raw_pixel_values"].shape == (12, 9, 32, 32, 3)
    assert got["policy_pixels"].shape == (12, 64, 64, 3)
    assert t_push.CollectConfig() == t_push.CollectConfig(**{
        f: getattr(j_push.CollectConfig(), f) for f in t_push.CollectConfig.__dataclass_fields__})


@pytest.mark.parametrize("expert_targets", [False, True])
def test_push_segment_dataset_batches_and_resume(collections, expert_targets):
    data, _ = collections
    tr, _ = t_push.train_val_split(data, val_frac=0.25, seed=0)
    kw = dict(batch_size=3, seed=2, expert_targets=expert_targets, indices=tr)
    port, ref = t_push.PushSegmentDataset(data, **kw), j_push.PushSegmentDataset(data, **kw)
    assert len(port) == len(ref) == len(tr)
    for _ in range(3):
        _assert_same(port.next_batch(), ref.next_batch())
    state = port.state_dict()
    assert state == ref.state_dict() == {"step": 3}
    after = port.next_batch()
    port.load_state_dict(state)
    _assert_same(port.next_batch(), after)
    np.testing.assert_array_equal(
        after["actions"], data["expert_actions" if expert_targets else "actions"][
            tr[np.random.default_rng((2, 3)).integers(0, len(tr), 3)]])
    _assert_same(ref.next_batch(), after)
    _assert_same(next(iter(port)), ref.next_batch())  # the stream goes on from step 4


def test_segment_files_round_trip_and_refuse_other_renderers(collections, tmp_path):
    data, _ = collections
    path = str(tmp_path / "seg.npz")
    t_push.save_segments(path, data)
    _assert_same(t_push.load_segments(path), data)
    _assert_same(j_push.load_segments(path), data)  # the reference reads the port's file
    j_push.save_segments(str(tmp_path / "ref.npz"), data)
    _assert_same(t_push.load_segments(str(tmp_path / "ref.npz")), data)

    np.savez_compressed(str(tmp_path / "old.npz"), **data, render_version=np.int32(1))
    with pytest.raises(ValueError, match=f"render_version=1 .* version {RENDER_VERSION}"):
        t_push.load_segments(str(tmp_path / "old.npz"))
    np.savez_compressed(str(tmp_path / "untagged.npz"), **data)
    with pytest.warns(UserWarning, match="predates render_version"):
        _assert_same(t_push.load_segments(str(tmp_path / "untagged.npz")), data)


@pytest.mark.parametrize("n,val_frac,seed", [(12, 0.25, 0), (40, 0.1, 3), (5, 0.1, 1)])
def test_train_val_split_equals_the_reference(n, val_frac, seed):
    data = {"actions": np.zeros((n, 8, 7), np.float32)}
    tr, va = t_push.train_val_split(data, val_frac, seed)
    rtr, rva = j_push.train_val_split(data, val_frac, seed)
    np.testing.assert_array_equal(tr, rtr)
    np.testing.assert_array_equal(va, rva)
    assert len(va) == max(1, int(n * val_frac)) and not set(tr) & set(va)
    assert sorted(np.concatenate([tr, va]).tolist()) == list(range(n))

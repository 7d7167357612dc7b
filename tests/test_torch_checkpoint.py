"""The port's checkpoints (repro_torch/train/checkpoint.py) on torch trees:
the seven behaviours of tests/test_checkpoint.py, on a tree of dicts and a
list with an int32 and a bf16 leaf, plus the two things a torch tree adds
(the async snapshot is a copy; each leaf comes back in the ``like`` tree's
dtype and on its device)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(2)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": [torch.randn((3,), generator=g).to(torch.bfloat16)]},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _equal(x, y):
    return all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(tree_leaves(x), tree_leaves(y)))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    C.save(str(tmp_path), 7, tree, meta={"data_state": {"step": 3}})
    assert C.latest_step(str(tmp_path)) == 7
    like = tree_map(torch.zeros_like, tree)
    got, meta = C.restore(str(tmp_path), 7, like)
    assert meta["step"] == 7 and meta["data_state"]["step"] == 3
    assert _equal(got, tree)
    assert got["nested"]["c"][0].dtype == torch.bfloat16
    with np.load(tmp_path / "step_7" / "arrays.npz") as z:    # the reference's layout
        assert sorted(z.files) == ["a", "nested/b", "nested/c/0", "step"]
        assert z["nested/c/0"].dtype == np.float32              # bf16 widened


def test_keep_last_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        C.save(str(tmp_path), s, _tree(s), keep_last=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [4, 5]


def test_async_save(tmp_path):
    t = C.save_async(str(tmp_path), 11, _tree())
    t.join(timeout=30)
    assert C.latest_step(str(tmp_path)) == 11
    got, meta = C.restore(str(tmp_path), 11, _tree(1))
    assert meta["step"] == 11 and _equal(got, _tree())


def test_async_save_snapshots_before_returning(tmp_path):
    """A CPU tensor's .cpu() is the tensor itself: what the writer thread
    writes must be the values at the call, not what a later step writes
    into the same storage."""
    tree = _tree()
    want = tree_map(torch.clone, tree)
    t = C.save_async(str(tmp_path), 3, tree)
    for leaf in tree_leaves(tree):
        leaf.zero_()
    t.join(timeout=30)
    got, _ = C.restore(str(tmp_path), 3, tree_map(torch.zeros_like, want))
    assert _equal(got, want)


def test_atomicity_no_partial_dirs(tmp_path):
    C.save(str(tmp_path), 1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]


def test_overlapping_async_saves_same_step(tmp_path):
    """Overlapping save_async calls for one step each stage into their own
    tmp dir: every writer completes, the published step is complete, and
    no staging leftovers survive (a background-thread error fails the test:
    pyproject.toml promotes the thread-exception warning)."""
    big = {"w": torch.zeros((512, 512))}     # widen the race window
    for _ in range(4):
        threads = [C.save_async(str(tmp_path), 5, big) for _ in range(4)]
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    assert C.latest_step(str(tmp_path)) == 5
    got, meta = C.restore(str(tmp_path), 5, big)
    assert meta["step"] == 5 and not got["w"].any()
    leftovers = [d for d in os.listdir(tmp_path) if d.startswith(".")]
    assert not leftovers, leftovers


def test_wait_for_saves_joins_outstanding(tmp_path):
    for s in (1, 2, 3):
        C.save_async(str(tmp_path), s, _tree(s))
    C.wait_for_saves(timeout=30)
    assert C.latest_step(str(tmp_path)) == 3


def test_scans_tolerate_stray_names(tmp_path):
    """latest_step/_gc skip anything that is not a step_<int> dir: staging
    dirs, trash dirs from an interrupted publish, stray files."""
    C.save(str(tmp_path), 2, _tree())
    (tmp_path / "step_garbage").mkdir()
    (tmp_path / ".tmp_step_9_123_0").mkdir()
    (tmp_path / ".old_step_2_99_1").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert C.latest_step(str(tmp_path)) == 2
    C.save(str(tmp_path), 3, _tree(), keep_last=1)    # _gc runs over strays
    assert C.latest_step(str(tmp_path)) == 3
    assert C.latest_step(str(tmp_path / "missing")) is None

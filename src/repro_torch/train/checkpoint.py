"""Atomic, async checkpointing of torch param trees (port of
repro/train/checkpoint.py, with its layout and its concurrency fixes).

Layout:  <dir>/step_<N>/arrays.npz + meta.json   (tmp dir + atomic rename)

Each leaf is saved as a host numpy array keyed by its path in the tree
(dict keys and list indices joined by "/", repro_torch/tree.py). npz
cannot hold bfloat16, so bf16 leaves are widened to f32 (exactly) and
restore() casts each leaf back to the dtype, and moves it to the device,
of the matching leaf of the ``like`` tree.

Elastic restore (repro's ``shardings=``): a mesh run saves the whole tree,
its shards gathered to rank 0's host (launch/specs.TrainPlan.gather) and
written there, in the same format; a restore reads it whole and the
caller cuts this rank's shard (TrainPlan.shard) for whatever mesh
restores it, of any shape, or none. Each rank then holds the whole tree
in host memory until its shard is cut (ROADMAP A9 (h)).

Concurrency contract: any number of save()/save_async() calls may overlap,
including for the *same* step. Every writer stages into a tmp dir whose
name is unique per call (step, pid, and a process-wide counter), and a
step dir, once visible, is always a *complete* checkpoint: nothing is
deleted before its replacement is fully staged, so a writer that dies
mid-stage cannot destroy a published step. Re-saving an already-published
step swaps via a rename-aside, which opens a brief window where ``step_N``
is absent (a concurrent restore of exactly that step can hit
FileNotFoundError; ``latest_step`` callers just fall back to the previous
step) — first-time publication has no such window. Outstanding async
writers are tracked; ``wait_for_saves()`` joins them (train loops call it
before exit, tests call it before asserting on disk state).

save_async snapshots every leaf to host memory before its writer thread
starts, as a copy: on the CPU ``t.cpu()`` is the tensor itself, whose
storage a later step could change under the writer.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_unflatten_like

# process-wide unique suffix for staging dirs: two overlapping saves of the
# same step (same pid) must never share a tmp dir
_tmp_counter = itertools.count()
_inflight_lock = threading.Lock()
_inflight: list[threading.Thread] = []


def _flatten(tree) -> dict:
    out = {}
    for key, leaf in tree_leaves_with_path(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)               # exact; restore casts back
        out[key] = t.cpu().numpy().copy()         # a snapshot, never a view
    return out


def _unflatten_like(like, arrays: dict):
    leaves = []
    for key, leaf in tree_leaves_with_path(like):
        a = np.asarray(arrays[key]).reshape(tuple(leaf.shape))
        leaves.append(torch.from_numpy(a).to(dtype=leaf.dtype, device=leaf.device))
    return tree_unflatten_like(like, leaves)


def _step_of(name: str) -> int | None:
    """step_<N> -> N; anything else (tmp dirs, trash dirs, stray files,
    step_foo) -> None. Every directory scan goes through this so a stray
    name can never raise out of latest_step/_gc."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name[len("step_"):])
    except ValueError:
        return None


def _write_and_publish(ckpt_dir: str, step: int, arrays, meta, keep_last):
    os.makedirs(ckpt_dir, exist_ok=True)
    unique = f"{os.getpid()}_{next(_tmp_counter)}"
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{unique}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp)                           # unique per call: must not exist
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    # Publish: rename tmp -> final without ever deleting final first. If
    # final exists, move it aside under a unique trash name and retry; a
    # concurrent writer racing for the same step may steal the aside-move
    # (FileNotFoundError) or land its own rename first (final reappears) —
    # both loop back, and whichever rename lands last wins. Every dir that
    # is visible is complete; between the aside-move and the retried
    # rename, step_N is briefly absent (see the module docstring).
    while True:
        try:
            os.rename(tmp, final)
            break
        except OSError:
            trash = os.path.join(ckpt_dir, f".old_step_{step}_{unique}")
            try:
                os.rename(final, trash)
            except FileNotFoundError:
                continue                       # another writer moved it first
            shutil.rmtree(trash, ignore_errors=True)
    _gc(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree, *, meta: dict | None = None,
         keep_last: int = 3) -> str:
    return _write_and_publish(ckpt_dir, step, _flatten(tree), meta, keep_last)


def save_async(ckpt_dir: str, step: int, tree, *, meta=None, keep_last=3):
    """Snapshot to host memory synchronously, write in a thread.

    Returns the writer thread (already started). Threads are also tracked
    module-wide: ``wait_for_saves()`` joins everything outstanding.
    """
    arrays = _flatten(tree)                    # device->host copy happens here

    def work():
        _write_and_publish(ckpt_dir, step, arrays, meta, keep_last)

    t = threading.Thread(target=work, daemon=True)
    with _inflight_lock:
        _inflight.append(t)
    t.start()
    return t


def wait_for_saves(timeout: float | None = None):
    """Join all outstanding save_async writers (each gets `timeout`)."""
    with _inflight_lock:
        pending, _inflight[:] = _inflight[:], []
    for t in pending:
        t.join(timeout)
        if t.is_alive():                       # keep tracking unfinished ones
            with _inflight_lock:
                _inflight.append(t)


def latest_step(ckpt_dir: str) -> int | None:
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return None
    steps = [s for s in map(_step_of, names) if s is not None]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like``: each leaf in its dtype, on
    its device. -> (tree, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    tree = _unflatten_like(like, arrays)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta


_STALE_STAGING_SECS = 3600


def _gc(ckpt_dir: str, keep_last: int):
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return
    steps = sorted(s for s in map(_step_of, names) if s is not None)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    # sweep staging/trash dirs orphaned by a crashed writer; the age gate
    # keeps live writers' in-progress tmp dirs safe
    now = time.time()
    for name in names:
        if not name.startswith((".tmp_step_", ".old_step_")):
            continue
        path = os.path.join(ckpt_dir, name)
        try:
            stale = now - os.path.getmtime(path) > _STALE_STAGING_SECS
        except OSError:
            continue                           # concurrently removed
        if stale:
            shutil.rmtree(path, ignore_errors=True)

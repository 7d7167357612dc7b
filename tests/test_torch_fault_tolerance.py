"""The port's fault tolerance (repro_torch/train/fault_tolerance.py): the
five behaviours of tests/test_fault_tolerance.py, and a retry after a
failure injected in the middle of a real train step, which must leave the
params as one clean step does (the step is functional: a failed attempt
changes nothing)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402
from repro_torch.train.fault_tolerance import (StragglerWatchdog,  # noqa: E402
                                               TrainSupervisor, run_with_retries)
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)


def test_retry_recovers_from_transient():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    out = run_with_retries(fn, 1, max_retries=3, backoff=0.0, fail_at=lambda a: a < 2)
    assert out == 2
    assert len(calls) == 1  # two injected failures, then success


def test_retry_exhaustion_raises():
    with pytest.raises(RuntimeError):
        run_with_retries(lambda: 1, max_retries=2, backoff=0.0, fail_at=lambda a: True)


def test_straggler_watchdog():
    w = StragglerWatchdog(k_sigma=3.0, warmup_steps=3)
    for i in range(20):
        w.observe(1.0 + 0.001 * i)
    assert w.straggler_steps == 0
    assert w.observe(10.0)  # a 10x step is a straggler
    assert w.straggler_steps == 1


def test_supervisor_retries_and_checkpoints():
    ckpts = []

    def step(params, opt, batch):
        return params + 1, opt, {"loss": float(params)}

    sup = TrainSupervisor(step, checkpoint_fn=lambda st, i: ckpts.append((i, st[0])),
                          max_retries=2)
    # a transient failure injected at step 3, attempt 0
    (params, opt), hist = sup.run((0, 0), iter(range(100)), n_steps=6, ckpt_every=2,
                                  fail_at=lambda i, a: i == 3 and a == 0)
    assert params == 6
    assert len(hist) == 6 and all(h["step_s"] >= 0 for h in hist)
    assert [i for i, _ in ckpts] == [2, 4, 6]


def test_drain_stops_loop():
    sup = TrainSupervisor(lambda p, o, b: (p + 1, o, {"loss": 0.0}),
                          checkpoint_fn=lambda st, i: None)
    sup.drain.draining = True
    (params, _), hist = sup.run((0, 0), iter(range(10)), n_steps=10)
    assert params == 0 and hist == []


def test_retry_after_a_failure_mid_step_equals_one_clean_step(monkeypatch):
    """The first attempt runs the whole step (forward, backward, AdamW, the
    latent clip) and then fails; the retry must start from the same params
    and give exactly what one clean step gives."""
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32",
                                              param_dtype="float32")
    api = get_model(cfg)
    params = api.init(0, device="cpu", packed=False)
    opt = adamw_init(params)
    step = make_train_step(api, cfg, peak_lr=1e-2, warmup=1, total=10)
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticTokens(cfg.vocab, 16, 2)).items()}
    want, want_opt, _ = step(params, opt, batch)
    attempts = []

    def flaky(params, opt, b):
        out = step(params, opt, b)
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("failure after the update was computed")
        return out

    monkeypatch.setattr(ft.time, "sleep", lambda s: None)     # no retry backoff
    (got, got_opt), hist = TrainSupervisor(flaky, max_retries=2).run(
        (params, opt), iter([batch]), n_steps=1)
    assert len(attempts) == 2 and len(hist) == 1
    assert int(got_opt["step"]) == 1
    for a, b in zip(tree_leaves([got, got_opt["m"], got_opt["v"]]),
                    tree_leaves([want, want_opt["m"], want_opt["v"]])):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(params)))
    assert np.isfinite(hist[0]["loss"])

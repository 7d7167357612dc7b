"""The 1-bit data-parallel gradient sync (train/manual_dp.py) against
repro/train/manual_dp.py, and examples/onebit_dp.py.

* compress_decompress = repro's within 1e-6 of max-abs, its signs exact,
  sign(0) = +1; the error feedback makes the accumulated estimate converge
  to the true gradient (tests/test_compression.py's test, in torch).
* The wire: one int8 all_reduce of every sign and one f32 all_reduce of
  every leaf's scale.
* make_onebit_dp_step on one rank (a process group of one, in this
  process) against repro's on a 1-device mesh, and on 2 gloo ranks against
  repro's on 2 forced host devices (tests/conftest.py run_forced_devices),
  each for 3
  steps of a small least-squares model with distinct per-rank rows:
  params and each rank's error feedback within 1e-6.
* The example at 2 ranks and 3 steps on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import onebit_dp  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.train import manual_dp as M  # noqa: E402

torch.set_num_threads(2)

STEPS, ROWS, K, N, LR = 3, 6, 8, 4, 0.1


def _data(world: int) -> dict:
    """A least-squares problem: init w, b and STEPS global batches of
    world x ROWS rows."""
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((K, N)).astype(np.float32) * 0.5,
            "b": np.zeros((N,), np.float32),
            "x": rng.standard_normal((STEPS, world * ROWS, K)).astype(np.float32),
            "y": rng.standard_normal((STEPS, world * ROWS, N)).astype(np.float32)}


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = ((pred - batch["y"]) ** 2).mean()
    return loss, {"loss": loss}


def _update(params, grads, opt):
    return {k: params[k] - LR * grads[k] for k in params}, opt


def _port_run(mesh, data) -> dict:
    """3 steps of the port's 1-bit DP step -> params, this rank's err."""
    step = M.make_onebit_dp_step(_loss, _update, mesh)
    params = {k: torch.from_numpy(data[k]) for k in ("w", "b")}
    err, opt = M.init_error_feedback(params), {}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(data[k][i]) for k in ("x", "y")}
        params, opt, err, _ = step(params, opt, err, batch)
    return {**{k: v.numpy() for k, v in params.items()},
            **{f"err_{k}": v.numpy() for k, v in err.items()}}


REPRO_SCRIPT = """
import json, os
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.launch.mesh import set_mesh
from repro.train.manual_dp import init_error_feedback, make_onebit_dp_step

def loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"loss": loss}

def update(params, grads, opt):
    return jax.tree.map(lambda p, g: p - LR * g, params, grads), opt

out = {}
for world in (1, 2):
    d = dict(np.load(os.environ["DP_DATA"] + f"{world}.npz"))
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    step = jax.jit(make_onebit_dp_step(loss_fn, update, mesh))
    params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
    err, opt = init_error_feedback(params), {}
    with set_mesh(mesh):
        for i in range(int(d["steps"])):
            params, opt, err, _ = step(params, opt, err, {"x": jnp.asarray(d["x"][i]),
                                                          "y": jnp.asarray(d["y"][i])})
    # err is each device's own buffer (an unreplicated output under P()):
    # one list entry a device
    res = {k: np.asarray(v).tolist() for k, v in params.items()}
    res.update({f"err_{k}": [np.asarray(s.data).tolist()
                             for s in sorted(v.addressable_shards, key=lambda s: s.device.id)]
                for k, v in err.items()})
    out[world] = res
print("RESULT:" + json.dumps(out))
"""


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) <= tol * max(float(np.abs(want).max()), 1.0)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A process group of one rank in this process (gloo)."""
    import torch.distributed as dist
    init = "file://" + str(tmp_path_factory.mktemp("pg") / "rendezvous")
    dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(64,), (7, 33), (3, 4, 5)])
def test_compress_decompress_equals_repro(shape):
    import jax.numpy as jnp

    from repro.train.manual_dp import compress_decompress as jax_cd
    rng = np.random.default_rng(sum(shape))
    g = rng.standard_normal(shape).astype(np.float32)
    err = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    g.reshape(-1)[:3] = 0.0
    err.reshape(-1)[:3] = 0.0              # c = 0 at three places: sign +1
    ghat, new = M.compress_decompress(torch.from_numpy(g), torch.from_numpy(err))
    jghat, jnew = jax_cd(jnp.asarray(g), jnp.asarray(err))
    scale = float(np.abs(g + err).mean())
    assert np.array_equal(np.sign(ghat.numpy()), np.sign(np.asarray(jghat)))
    assert np.all(ghat.numpy().reshape(-1)[:3] > 0)
    assert _close(ghat.numpy(), np.asarray(jghat)) and _close(new.numpy(), np.asarray(jnew))
    assert np.allclose(np.abs(ghat.numpy()), scale, rtol=1e-6)


def test_error_feedback_unbiased_over_steps():
    """tests/test_compression.py:14-25 in torch: the accumulated compressed
    estimates converge to the true gradient."""
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)) * 0.1
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(200):
        ghat, err = M.compress_decompress(g, err)
        acc = acc + ghat
    rel = float(torch.linalg.norm(acc / 200 - g) / torch.linalg.norm(g))
    assert rel < 0.05, rel


def test_wire_is_int8_signs_and_f32_scales(group, monkeypatch):
    import torch.distributed as dist
    sent = []
    real = dist.all_reduce

    def record(t, *a, **kw):
        sent.append((t.dtype, t.numel()))
        return real(t, *a, **kw)
    monkeypatch.setattr(dist, "all_reduce", record)
    grads = {"a": torch.tensor([0.5, -0.2, 0.0]), "b": torch.zeros(2, 5, dtype=torch.bfloat16)}
    synced, err = M.onebit_psum_grads(grads, M.init_error_feedback(grads), group.get_group())
    assert sent == [(torch.int8, 13), (torch.float32, 2)]
    assert M.onebit_wire_bytes(grads) == 13 + 4 * 2
    # one rank: g_sync = scale * sign, sign(0) = +1
    scale = (0.5 + 0.2) / 3
    assert torch.allclose(synced["a"], torch.tensor([scale, -scale, scale]))
    assert torch.equal(synced["b"], torch.zeros(2, 5)) and err["b"].dtype == torch.float32


def _rank_run(rank, world, data):
    torch.set_num_threads(1)
    return _port_run(make_mesh((world,), ("data",)), data)


def test_onebit_step_equals_repro(group, run_forced_devices, tmp_path):
    """One rank (this process's group of one) and two gloo ranks against
    repro's step on a 1-device and a 2-device mesh, run in one subprocess
    with 2 forced host devices."""
    base = tmp_path / "dp"
    for world in (1, 2):
        np.savez(f"{base}{world}.npz", steps=STEPS, **_data(world))
    want = run_forced_devices(REPRO_SCRIPT.replace("LR", repr(LR)), n_devices=2,
                              env={"DP_DATA": str(base)})
    got = {"1": [_port_run(group, _data(1))],
           "2": spawn(_rank_run, 2, backend="gloo", args=(_data(2),), timeout=120)}
    for world, ranks in got.items():
        for r, out in enumerate(ranks):
            for k in ("w", "b"):
                assert _close(out[k], want[world][k]), (world, r, k)
                assert _close(out[f"err_{k}"], want[world][f"err_{k}"][r]), (world, r, k)
    assert not np.allclose(got["2"][0]["err_w"], got["2"][1]["err_w"])   # err stays local


def test_example_two_ranks_on_cpu(capsys):
    losses = onebit_dp.main(["--ranks", "2", "--steps", "3", "--device", "cpu"])
    assert sorted(losses) == sorted(onebit_dp.RUNS)
    assert all(len(v) == 3 and np.all(np.isfinite(v)) for v in losses.values())
    # the same params and batch before any update
    assert losses["fp32-psum"][0] == losses["1bit+EF"][0]
    out = capsys.readouterr().out
    assert "params=" in out and "fp32-psum  loss:" in out and "1bit+EF    loss:" in out

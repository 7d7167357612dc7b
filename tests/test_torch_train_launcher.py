"""The port's training launcher, deploy transform and binary_llm example, on
the CPU (``--device cpu``):

  * train 6 steps -> checkpoint -> resume 3 on the smoke config: the
    resumed run starts from the checkpointed params on the data stream's
    next batch with the optimizer's step count restored;
  * the serve launcher's --ckpt-dir serves the tokens of an engine built
    on the restored params;
  * deploy_params: the deployed forward equals the latent forward in int8
    and xnor mode, with repro's keys and shapes, and the deployed params
    are smaller;
  * binary_llm at a few steps: its parameter counts and deployed bytes,
    counted from the port's tensors, equal those of repro's tensors for the
    same configs (jax.eval_shape of repro's init and deploy), and relate to
    repro's analytic param_count / weight_bytes by the terms the analytic
    count leaves out or counts otherwise; the analytic counts it prints
    beside them (the port's analytic_cost) equal repro's;
  * the launcher keeps no reference to the state a step replaced.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.configs.base import PrecisionPolicy as JPolicy  # noqa: E402
from repro.distributed.analytic_cost import binary_param_count, weight_bytes  # noqa: E402
from repro.distributed.hlo_analysis import param_count  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.deploy import deploy_params as j_deploy_params  # noqa: E402
from repro_torch.configs import PrecisionPolicy, smoke_config  # noqa: E402
from repro_torch.core.binary_dense import pack_tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.examples import binary_llm  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.deploy import deploy_params  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

TRAIN = ["--arch", "stablelm-3b", "--smoke", "--batch", "4", "--seq", "32",
         "--device", "cpu"]


def test_train_checkpoint_resume_then_serve(tmp_path):
    ck = str(tmp_path / "ck")
    h1 = train_cli.main(TRAIN + ["--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3"])
    assert len(h1) == 6 and all(np.isfinite(h["loss"]) for h in h1)
    assert C.latest_step(ck) == 6
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    like = api.init(0, device="cpu", packed=False)
    state, meta = C.restore(ck, 6, {"params": like})
    assert meta["data_state"] == {"step": 6, "seed": 0}
    assert not any(torch.equal(a, b) for a, b in zip(tree_leaves(state["params"]),
                                                     tree_leaves(like)) if a.numel() > 64)

    h2 = train_cli.main(TRAIN + ["--steps", "3", "--ckpt-dir", ck, "--resume"])
    assert len(h2) == 3 and all(abs(h["loss"]) < 100 for h in h2)
    # the resumed first step: the checkpointed params on batch 6 of the stream
    data = SyntheticTokens(cfg.vocab, 32, 4, seed=0)
    data.restore({"step": 6, "seed": 0})
    loss, _ = api.loss(state["params"], {k: torch.from_numpy(v) for k, v in next(data).items()})
    assert h2[0]["loss"] == pytest.approx(float(loss), abs=1e-6)
    # the optimizer's step restored: step 6 of a 3-step schedule is at its floor
    assert h2[0]["lr"] == pytest.approx(0.1 * 3e-4, rel=1e-6)
    assert C.latest_step(ck) == 9
    opt_like = {"step": torch.zeros((), dtype=torch.int32)}
    _, meta9 = C.restore(ck, 9, {})
    assert meta9["data_state"]["step"] == 9
    assert int(C.restore(ck, 9, {"opt": opt_like})[0]["opt"]["step"]) == 9

    # the serve launcher on the latest checkpoint = an engine on its params
    out = serve_cli.main(["--smoke", "--device", "cpu", "--ckpt-dir", ck, "--requests", "3",
                          "--prompt-lens", "8,12", "--max-new", "4"])
    params = pack_tree(C.restore(ck, 9, {"params": like})[0]["params"])
    eng = ServeEngine(api, params, max_batch=8, max_len=12 + 4 + 8)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.add_request(rng.integers(0, cfg.vocab, int(rng.choice([8, 12]))), max_new=4)
    eng.run()
    assert len(out) == 3 and all(len(v) == 4 for v in out.values())
    assert out == dict(eng.results)


@pytest.mark.parametrize("mode", ["int8", "xnor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deployed_equals_latent_forward(mode, dtype):
    cfg = smoke_config("stablelm-3b").replace(
        compute_dtype=dtype, param_dtype=dtype,
        policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1, binary_mode=mode))
    api = get_model(cfg)
    params = api.init(0, device="cpu", packed=False)
    dparams = deploy_params(params, cfg)
    assert torch.equal(api.init_deployed(0, device="cpu")["blocks"][1]["ffn"]["bin_out"]
                       ["w_packed" if mode == "xnor" else "w_int8"],
                       dparams["blocks"][1]["ffn"]["bin_out"]
                       ["w_packed" if mode == "xnor" else "w_int8"])
    paths = [p for p, _ in tree_leaves_with_path(dparams)]
    assert not any("w_latent" in p for p in paths)
    q = dparams["blocks"][1]["ffn"]["bin_in"]
    if mode == "xnor":
        assert q["w_packed"].dtype == torch.int32 and q["w_packed"].shape == (cfg.d_ff, 2)
    else:                                           # repro's (N, K) +-1 int8
        assert q["w_int8"].dtype == torch.int8 and q["w_int8"].shape == (cfg.d_ff, cfg.d_model)
        assert set(q["w_int8"].unique().tolist()) == {-1, 1}

    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)))
    gold, _ = api.prefill(params, {"tokens": toks}, max_len=20)
    got, _ = api.prefill(dparams, {"tokens": toks}, max_len=20)
    # f32: the same integer dot, scaled in f32 either way; bf16: the latent
    # path rounds the dot to bf16 before the scale, as repro's does
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), gold.float().numpy(), rtol=tol, atol=tol)

    def nbytes(t):
        return sum(x.numel() * x.element_size() for x in tree_leaves(t))
    assert nbytes(dparams) < nbytes(params)


def _jcfg(cfg):
    """The port's ModelConfig as repro's (the same fields)."""
    return JModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                           if f.name not in ("policy", "attn_impl")},
                        policy=JPolicy(**dataclasses.asdict(cfg.policy)))


def test_binary_llm_counts_equal_repro(tmp_path, capsys):
    out = binary_llm.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert "[hybrid] params=" in capsys.readouterr().out
    for tag, binary in (("float", False), ("hybrid", True)):
        cfg = binary_llm.make_cfg(binary)
        jcfg = _jcfg(cfg)
        japi = j_get_model(jcfg)
        shapes = jax.eval_shape(japi.init, jax.random.PRNGKey(0))
        dshapes = jax.eval_shape(lambda p: j_deploy_params(p, jcfg), shapes)
        j_params = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        j_bytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                      for a in jax.tree.leaves(dshapes))
        assert out[tag]["params"] == j_params
        assert out[tag]["deployed_bytes"] == j_bytes
        # the analytic count leaves out the norms (and the binary denses'
        # scales) and counts each FFN as a three-matrix SwiGLU, where a
        # binary one holds two; it prices params as bf16, these are f32
        nb_blocks = sum(cfg.policy.block_is_binary(i, cfg.n_layers)
                        for i in range(cfg.n_layers))
        norms = (2 * cfg.n_layers + 1) * cfg.d_model
        extra = nb_blocks * (cfg.d_ff + cfg.d_model - cfg.d_model * cfg.d_ff)
        assert out[tag]["params"] == param_count(jcfg) + norms + extra
        nb = int(binary_param_count(jcfg))
        assert out[tag]["deployed_bytes"] == 4 * (out[tag]["params"] - nb) + nb
        assert weight_bytes(jcfg, deployed=True) == 2 * (param_count(jcfg) - nb) + nb
        # the analytic counts the example prints beside them: repro's
        assert out[tag]["analytic_params"] == param_count(jcfg)
        assert out[tag]["analytic_deployed_bytes"] == weight_bytes(jcfg, deployed=True)
        hist = out[tag]["history"]
        assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
        assert C.latest_step(str(tmp_path / tag)) == 3
    assert out["hybrid"]["deployed_bytes"] < out["float"]["deployed_bytes"]


def test_launcher_frees_the_state_each_step_replaces(monkeypatch):
    """The step is functional, so old and new params and moments overlap
    inside a step; the launcher must hold no reference of its own, or the
    first params and moments would stay alive for the whole run (23 GB at
    full width)."""
    import weakref
    make, refs, alive = train_cli.make_train_step, [], []

    def watched(*a, **kw):
        step = make(*a, **kw)

        def run(p, o, b):
            if not refs:
                refs.extend(weakref.ref(t) for t in (p["embed"]["table"],
                                                     o["m"]["embed"]["table"]))
            alive.append([r() is not None for r in refs])
            return step(p, o, b)
        return run

    monkeypatch.setattr(train_cli, "make_train_step", watched)
    train_cli.main(TRAIN + ["--steps", "3"])
    assert alive == [[True, True], [False, False], [False, False]]

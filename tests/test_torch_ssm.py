"""The recurrent blocks of the port against repro, in f32 at the smoke
configs' widths: Mamba2 (models/mamba2.py) and RWKV6's Finch block
(models/rwkv6.py), on inputs drawn from a seed with numpy and repro's own
params carried over.

  * ssd_chunked: y and the final state against repro's at chunks 16 and 64
    over 100 tokens (a ragged tail at both), from a zero and a given start
    state, within 1e-4 of their max-abs; and against the token-by-token
    recurrence (tests/test_ssm.py's reference);
  * the Mamba2 block, float and binary (``{"bin": ...}`` in_zx / out, int8
    mode): mamba_apply with its state, then mamba_decode of one more token,
    outputs and states within 1e-4 of their max-abs; the decode continues
    the prefill (the float block: the binary one's signs can flip on path
    noise, as a binary FFN's do);
  * RWKV6: _wkv_scan, time_mix, channel_mix (float and binary) and
    rwkv_block_apply over a sequence, then one token from its cache, within
    1e-4 of their max-abs.

The time-mix projections and c_r run in bf16 in both packages whatever
the config says (repro/models/rwkv6.py:107-110, :117 and :131 take
nn.dense_apply's default compute dtype); each package rounds their f32
sums to bf16 once, so on the same inputs they still agree to f32's noise
unless a sum sits on a rounding edge (time_mix here: bit for bit).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import mamba2 as j_mamba  # noqa: E402
from repro.models import rwkv6 as j_rwkv  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.binary_dense import pack_tree  # noqa: E402
from repro_torch.models import mamba2, rwkv6  # noqa: E402
from repro_torch.models.convert import mlp_params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _close(got, want, tol=TOL):
    """got (a tensor) within tol of want's max-abs."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _trees_close(got: dict, want: dict, tol=TOL):
    want = dict(tree_leaves_with_path(mlp_params_from_jax(jax.tree.map(np.asarray, want),
                                                          device="cpu")))
    for path, t in tree_leaves_with_path(got):
        _close(t, want.pop(path).numpy(), tol)
    assert not want


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _block(j_init, seed, **kw):
    """repro's block params (f32) and the port's copy, packed like its own."""
    jp = j_init(jax.random.PRNGKey(seed), **kw)
    return jp, pack_tree(mlp_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, length=100, h=3, p=8, ds=16):
    rng = np.random.default_rng(seed)
    xt = rng.standard_normal((b, length, h, p)).astype(np.float32)
    alpha_log = -np.logaddexp(rng.standard_normal((b, length, h)), 0).astype(np.float32)
    bm = (rng.standard_normal((b, length, ds)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, length, ds)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, ds)).astype(np.float32)
    return xt, alpha_log, bm, cm, h0


def _ssd_sequential(xt, alpha_log, bm, cm, h0):
    """tests/test_ssm.py's token-by-token recurrence, from h0."""
    a = np.exp(alpha_log)
    hs, ys = h0.copy(), np.zeros_like(xt)
    for t in range(xt.shape[1]):
        hs = a[:, t][..., None, None] * hs + np.einsum("bhp,bs->bhps", xt[:, t], bm[:, t])
        ys[:, t] = np.einsum("bs,bhps->bhp", cm[:, t], hs)
    return ys, hs


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("start", ["zero", "given"])
def test_ssd_chunked_matches_repro(chunk, start):
    xt, alpha_log, bm, cm, h0 = _ssd_inputs(chunk)
    h0 = h0 if start == "given" else None
    jy, jh = j_mamba.ssd_chunked(*map(jnp.asarray, (xt, alpha_log, bm, cm)), chunk=chunk,
                                 h0=None if h0 is None else jnp.asarray(h0))
    y, hfin = mamba2.ssd_chunked(*map(_t, (xt, alpha_log, bm, cm)), chunk=chunk,
                                 h0=None if h0 is None else _t(h0))
    assert tuple(y.shape) == xt.shape and tuple(hfin.shape) == (2, 3, 8, 16)
    _close(y, jy)
    _close(hfin, jh)
    sy, sh = _ssd_sequential(xt, alpha_log, bm, cm,
                             np.zeros((2, 3, 8, 16), np.float32) if h0 is None else h0)
    _close(y, sy)
    _close(hfin, sh)


def test_ssd_chunked_backward_is_finite():
    """The upper triangle is masked before exp: no inf * 0 in the backward,
    however large the decays."""
    xt, alpha_log, bm, cm, _ = _ssd_inputs(3, length=40)
    args = [_t(a).requires_grad_() for a in (xt, alpha_log * 30, bm, cm)]
    y, h = mamba2.ssd_chunked(*args, chunk=16)
    (y.square().sum() + h.square().sum()).backward()
    assert all(bool(torch.isfinite(a.grad).all()) for a in args)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_mamba_block_matches_repro(binary):
    jcfg = j_smoke("zamba2-2.7b").replace(**F32)
    cfg = smoke_config("zamba2-2.7b").replace(**F32)
    jp, p = _block(lambda k, **kw: j_mamba.mamba_init(k, jcfg, **kw), 0, binary=binary)
    assert ("bin" in p["in_zx"]) == binary
    if binary:
        assert p["out"]["bin"]["w_packed"].dtype == torch.int32
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 41, cfg.d_model)) * 0.3).astype(np.float32)
    jout, jst = j_mamba.mamba_apply(jp, jnp.asarray(x[:, :40]), jcfg, return_state=True)
    out, st = mamba2.mamba_apply(p, _t(x[:, :40]), cfg, return_state=True)
    _close(out, jout)
    _trees_close(st, jst)
    assert tuple(st["conv"].shape) == (2, cfg.d_conv - 1, 2 * cfg.d_model + 2 * cfg.d_state)
    jdec, jst2 = j_mamba.mamba_decode(jp, jnp.asarray(x[:, 40:]), jcfg, jst)
    dec, st2 = mamba2.mamba_decode(p, _t(x[:, 40:]), cfg, st)
    _close(dec, jdec)
    _trees_close(st2, jst2)
    if not binary:
        gold = mamba2.mamba_apply(p, _t(x), cfg)          # 41 tokens: two chunks of 32
        _close(dec[:, 0], gold[:, 40].numpy())


def test_mamba_init_cache_and_constants():
    cfg = smoke_config("zamba2-2.7b")
    g = torch.Generator().manual_seed(0)
    p = mamba2.mamba_init(cfg, binary=False, generator=g, device="cpu")
    jp = j_mamba.mamba_init(jax.random.PRNGKey(0), j_smoke("zamba2-2.7b"), binary=False)
    for name in ("a_log", "d_skip", "dt_bias", "conv_b"):
        np.testing.assert_allclose(p[name].numpy(), np.asarray(jp[name]), rtol=1e-6, atol=0)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_mamba.mamba_init_cache(j_smoke("zamba2-2.7b"), 3))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in mamba2.mamba_init_cache(cfg, 3, device="cpu").items()}
    assert got == want


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_cfgs():
    return j_smoke("rwkv6-3b").replace(**F32), smoke_config("rwkv6-3b").replace(**F32)


def test_wkv_scan_matches_repro():
    jcfg, cfg = _rwkv_cfgs()
    nh, hd = rwkv6.heads(cfg)
    rng = np.random.default_rng(2)
    b, length, d = 2, 19, cfg.d_model
    r, k, v = (rng.standard_normal((b, length, d)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, length, d)).astype(np.float32)
    u = (rng.standard_normal(d) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, nh, hd, hd)).astype(np.float32)
    jy, js = j_rwkv._wkv_scan(*map(jnp.asarray, (r, k, v, w, u)), nh, hd, jnp.asarray(s0))
    y, s = rwkv6._wkv_scan(*map(_t, (r, k, v, w, u)), nh, hd, _t(s0))
    _close(y, jy)
    _close(s, js)


def test_time_mix_matches_repro():
    jcfg, cfg = _rwkv_cfgs()
    jp, p = _block(lambda k, **kw: j_rwkv.rwkv_block_init(k, jcfg, **kw), 0, binary=False)
    nh, hd = rwkv6.heads(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    s0 = (rng.standard_normal((2, nh, hd, hd)) * 0.1).astype(np.float32)
    jout, (jx, js) = j_rwkv.time_mix(jp, *map(jnp.asarray, (x,)), jcfg, jnp.asarray(x_prev),
                                     jnp.asarray(s0))
    out, (lx, s) = rwkv6.time_mix(p, _t(x), cfg, _t(x_prev), _t(s0))
    assert out.dtype == torch.bfloat16        # nn.dense_apply's default, as repro's
    _close(out, jnp.asarray(jout, jnp.float32))
    _close(lx, jx)
    _close(s, js)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_channel_mix_matches_repro(binary):
    jcfg, cfg = _rwkv_cfgs()
    jp, p = _block(lambda k, **kw: j_rwkv.rwkv_block_init(k, jcfg, **kw), 1, binary=binary)
    assert ("bin" in p["c_k"]) == binary and "bin" not in p["c_r"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jout, jx = j_rwkv.channel_mix(jp, jnp.asarray(x), jcfg, jnp.asarray(x_prev))
    out, lx = rwkv6.channel_mix(p, _t(x), cfg, _t(x_prev))
    _close(out, jout)
    _close(lx, jx)


@pytest.mark.parametrize("binary", [False, True], ids=["float", "binary"])
def test_rwkv_block_sequence_then_token_matches_repro(binary):
    jcfg, cfg = _rwkv_cfgs()
    jp, p = _block(lambda k, **kw: j_rwkv.rwkv_block_init(k, jcfg, **kw), 2, binary=binary)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 17, cfg.d_model)) * 0.3).astype(np.float32)
    jy, jc = j_rwkv.rwkv_block_apply(jp, jnp.asarray(x[:, :16]), jcfg)
    y, c = rwkv6.rwkv_block_apply(p, _t(x[:, :16]), cfg)
    _close(y, jy)
    _trees_close(c, jc)
    jy1, jc1 = j_rwkv.rwkv_block_apply(jp, jnp.asarray(x[:, 16:]), jcfg, jc)
    y1, c1 = rwkv6.rwkv_block_apply(p, _t(x[:, 16:]), cfg, c)
    _close(y1, jy1)
    _trees_close(c1, jc1)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        j_rwkv.rwkv_init_cache_block(jcfg, 2))
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in rwkv6.rwkv_init_cache_block(cfg, 2, device="cpu").items()}
    assert got == want

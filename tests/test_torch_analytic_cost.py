"""The port's analytic cost model (distributed/analytic_cost.py,
hlo_analysis.param_count / model_flops) and cell_is_runnable against
repro's, on every ARCHS config x SHAPES cell and the policy and remat
variants tests/test_analytic_cost.py uses: every count equal exactly
(pure arithmetic, milliseconds a case); then repro's sanity checks on the
port's model, and its H100 constants."""

import dataclasses

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import ARCHS as J_ARCHS
from repro.configs import PrecisionPolicy as JPolicy
from repro.configs import cell_is_runnable as j_runnable
from repro.configs import get_config as j_config
from repro.distributed import analytic_cost as JAC
from repro.distributed import hlo_analysis as JH
from repro_torch.configs import ARCHS, SHAPES, PrecisionPolicy, cell_is_runnable, get_config
from repro_torch.distributed import analytic_cost as AC
from repro_torch.distributed import hlo_analysis as H

# (name, policy kwargs or None for the config's own): repro's test's
# variants (xnor over the config's edges, every dense float) and bf16
POLICIES = [("own", None),
            ("xnor", dict(binary_ffn=True, edge_blocks_float=3, binary_mode="xnor")),
            ("bf16", dict(binary_ffn=True, edge_blocks_float=2, binary_mode="bf16")),
            ("float", dict(binary_ffn=False))]
REMATS = ("none", "dots", "block", "full")


def _pair(arch, policy):
    cfg, jcfg = get_config(arch), j_config(arch)
    if policy is not None:
        cfg = cfg.replace(policy=PrecisionPolicy(**policy))
        jcfg = jcfg.replace(policy=JPolicy(**policy))
    return cfg, jcfg


def _buckets(sc):
    return (sc.flops_bf16, sc.flops_int8, sc.flops_xnor, sc.hbm_bytes)


def test_same_archs_shapes_and_configs():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in J_SHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), j_config(arch)
        fields = {f.name for f in dataclasses.fields(jcfg)}
        assert {f: getattr(cfg, f) for f in fields if f != "policy"} == \
            {f: getattr(jcfg, f) for f in fields if f != "policy"}, arch
        assert dataclasses.asdict(cfg.policy) == dataclasses.asdict(jcfg.policy)


@pytest.mark.parametrize("policy", POLICIES, ids=[p[0] for p in POLICIES])
@pytest.mark.parametrize("arch", ARCHS)
def test_costs_equal_repro_exactly(arch, policy):
    cfg, jcfg = _pair(arch, policy[1])
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert _buckets(AC.forward_cost(cfg, shape)) == \
            _buckets(JAC.forward_cost(jcfg, jshape)), name
        for remat in REMATS:
            got = AC.step_cost(cfg.replace(remat=remat), shape)
            want = JAC.step_cost(jcfg.replace(remat=remat), jshape)
            assert _buckets(got) == _buckets(want), (name, remat)
            assert got.flops_total == want.flops_total
        assert AC.hbm_bytes(cfg, shape) == JAC.hbm_bytes(jcfg, jshape), name
        assert AC.kv_cache_bytes(cfg, shape) == JAC.kv_cache_bytes(jcfg, jshape), name
        assert AC.activation_bytes(cfg, shape) == JAC.activation_bytes(jcfg, jshape), name
        assert H.model_flops(cfg, shape) == JH.model_flops(jcfg, jshape), name
    for deployed in (False, True):
        assert AC.weight_bytes(cfg, deployed=deployed) == \
            JAC.weight_bytes(jcfg, deployed=deployed)
    assert AC.binary_param_count(cfg) == JAC.binary_param_count(jcfg)
    for active in (False, True):
        assert H.param_count(cfg, active_only=active) == \
            JH.param_count(jcfg, active_only=active)


@pytest.mark.parametrize("arch", ARCHS)
def test_t_compute_with_repro_peaks_equals_repro(arch):
    # xnor fills all three buckets, int8 the MXU's
    for policy in (POLICIES[1][1], dict(binary_ffn=True, edge_blocks_float=2,
                                        binary_mode="int8")):
        cfg, jcfg = _pair(arch, policy)
        for name, shape in SHAPES.items():
            got, want = AC.step_cost(cfg, shape), JAC.step_cost(jcfg, J_SHAPES[name])
            for n in (1, 256, 512):
                assert got.t_compute(n, peak_bf16=197e12, peak_int8=394e12,
                                     peak_xnor=JAC.XNOR_PEAK) == want.t_compute(n)


def test_cell_is_runnable_equals_repro_on_all_40_cells():
    verdicts = []
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            got = cell_is_runnable(get_config(arch), shape)
            assert got == j_runnable(j_config(arch), J_SHAPES[name]), (arch, name)
            verdicts.append(got[0])
    assert len(verdicts) == 40 and sum(verdicts) == 32


def test_h100_constants():
    """An H100 SXM5 80GB HBM3 at 700 W, datasheet figures (dense)."""
    assert (H.PEAK_BF16, H.PEAK_INT8, H.HBM_BW) == (989e12, 1979e12, 3.35e12)
    assert (H.NVLINK_BW, H.NIC_BW) == (450e9, 50e9)
    assert AC.XNOR_PEAK == H.PEAK_INT8
    assert H.AXIS_BW == {"model": H.NVLINK_BW, "data": H.NIC_BW}
    # each axis over its own link
    assert H.t_collective({"model": 450e9, "data": 50e9}) == 2.0
    rl = H.Roofline(989e12, 3.35e12, 1e9, coll_by_axis={"model": 9e9})
    assert (rl.t_compute, rl.t_memory, rl.t_collective, rl.bottleneck) == \
        (1.0, 1.0, 0.02, "compute")


# --- repro's sanity checks (tests/test_analytic_cost.py), on the port ---

def test_train_flops_close_to_6nd():
    cfg = get_config("qwen3-8b")
    shape = SHAPES["train_4k"]
    sc = AC.step_cost(cfg, shape)
    d = shape.global_batch * shape.seq_len
    base = 6 * H.param_count(cfg) * d / 3.0 * AC.REMAT_FACTOR[cfg.remat]
    assert 0.8 * base < sc.flops_total < 1.6 * base


def test_decode_flops_tiny_vs_train():
    cfg = get_config("qwen3-8b")
    assert AC.step_cost(cfg, SHAPES["decode_32k"]).flops_total < \
        AC.step_cost(cfg, SHAPES["train_4k"]).flops_total / 100


def test_binary_buckets_populated():
    cfg = get_config("deepseek-v3-671b")
    sc = AC.step_cost(cfg, SHAPES["train_4k"])
    assert sc.flops_int8 > 0 and sc.flops_bf16 > 0
    xn = cfg.replace(policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=3,
                                            binary_mode="xnor"))
    assert AC.step_cost(xn, SHAPES["train_4k"]).flops_xnor == sc.flops_int8


def test_deployed_weight_bytes_modes():
    cfg = get_config("deepseek-v3-671b")
    bf = AC.weight_bytes(cfg.replace(policy=PrecisionPolicy(binary_ffn=False)), deployed=True)
    i8 = AC.weight_bytes(cfg, deployed=True)
    xn = AC.weight_bytes(cfg.replace(policy=PrecisionPolicy(
        binary_ffn=True, edge_blocks_float=3, binary_mode="xnor")), deployed=True)
    assert xn < i8 < bf
    assert bf > 1.3e12 and xn < 2.0e11


def test_remat_factor_ordering():
    cfg, sh = get_config("stablelm-3b"), SHAPES["train_4k"]
    f = {r: AC.step_cost(cfg.replace(remat=r), sh).flops_total for r in REMATS}
    assert f["none"] < f["dots"] < f["block"] == f["full"]


def test_kv_cache_bytes_sub_quadratic_archs_constant():
    cfg = get_config("rwkv6-3b")
    assert AC.kv_cache_bytes(cfg, SHAPES["long_500k"]) < \
        AC.kv_cache_bytes(cfg, SHAPES["decode_32k"])

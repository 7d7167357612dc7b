"""Analytical performance/energy model of the BEANNA FPGA accelerator.

The paper's hardware results (Tables I-III) come from a Zynq ZCU106
implementation we cannot synthesize here; this model reproduces them from
first principles + two fitted micro-parameters, and then serves as the
reference when comparing the TPU lowering's speedups against the paper's.

Peak throughput (validates the model's structure exactly):
  float : 16x16 MACs + 16 accumulator adds per cycle
          = (256*2 + 16) ops x 100 MHz  = 52.8  GOps/s   (paper: 52.8)
  binary: each PE does 16 binary MACs   = (4096*2 + 16) x 100 MHz
          = 820.8 GOps/s                                  (paper: 820)

Latency model: a layer (K -> N) at batch B is a block matmul over
ceil(K/Kb) x ceil(N/16) weight blocks (Kb = 16 float / 256 binary); each
block streams B activation rows through the array plus a per-block
overhead o_mode (weight DMA + pipeline fill/drain + control), the fitted
parameter. Energy = measured power x inference time (paper Table III
derives exactly this way: 2.135 W / 6928.08 inf/s = 0.3082 mJ).

A copy of repro/core/accelerator_model.py (pure Python), with table2
reading the port's hybrid_mlp; every number in it is the paper's FPGA's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

CLOCK_HZ = 100e6
ARRAY = 16
BIN_LANES = 16  # binary K-elements per PE per cycle

# paper Table I/III constants
PAPER = {
    "inf_s_float_b1": 138.42,
    "inf_s_float_b256": 6928.08,
    "inf_s_hybrid_b1": 409.13,
    "inf_s_hybrid_b256": 20337.60,
    "power_float_w": 2.135,
    "power_beanna_w": 2.150,
    "energy_float_mj": 0.3082,
    "energy_hybrid_mj": 0.1057,
    "mem_float_bytes": 5_820_416,
    "mem_hybrid_bytes": 1_888_256,
    "acc_float": 98.19,
    "acc_hybrid": 97.96,
}

LAYERS = [(784, 1024), (1024, 1024), (1024, 1024), (1024, 10)]
BINARY_LAYERS = (1, 2)


def peak_gops(mode: str) -> float:
    if mode == "float":
        return (ARRAY * ARRAY * 2 + ARRAY) * CLOCK_HZ / 1e9
    return (ARRAY * ARRAY * BIN_LANES * 2 + ARRAY) * CLOCK_HZ / 1e9


@dataclass
class FittedModel:
    o_float: float   # per-block overhead cycles, float mode
    o_binary: float  # per-block overhead cycles, binary mode

    def layer_cycles(self, k: int, n: int, batch: int, *, binary: bool
                     ) -> float:
        kb = ARRAY * (BIN_LANES if binary else 1)
        blocks = math.ceil(k / kb) * math.ceil(n / ARRAY)
        o = self.o_binary if binary else self.o_float
        return blocks * (batch + o)

    def inference_cycles(self, batch: int, *, hybrid: bool) -> float:
        total = 0.0
        for i, (k, n) in enumerate(LAYERS):
            binary = hybrid and i in BINARY_LAYERS
            total += self.layer_cycles(k, n, batch, binary=binary)
        return total

    def inferences_per_s(self, batch: int, *, hybrid: bool) -> float:
        return batch * CLOCK_HZ / self.inference_cycles(batch, hybrid=hybrid)

    def energy_per_inference_mj(self, batch: int, *, hybrid: bool) -> float:
        p = PAPER["power_beanna_w"] if hybrid else PAPER["power_float_w"]
        return p / self.inferences_per_s(batch, hybrid=hybrid) * 1e3


def fit() -> FittedModel:
    """Fit (o_float, o_binary) to the paper's four throughput numbers by
    least squares on log throughput (grid + refine)."""
    targets = [
        (1, False, PAPER["inf_s_float_b1"]),
        (256, False, PAPER["inf_s_float_b256"]),
        (1, True, PAPER["inf_s_hybrid_b1"]),
        (256, True, PAPER["inf_s_hybrid_b256"]),
    ]

    def err(of, ob):
        m = FittedModel(of, ob)
        e = 0.0
        for batch, hybrid, t in targets:
            pred = m.inferences_per_s(batch, hybrid=hybrid)
            e += (math.log(pred) - math.log(t)) ** 2
        return e

    best = (None, None, float("inf"))
    for of in range(20, 160):
        for ob in range(20, 400, 2):
            e = err(float(of), float(ob))
            if e < best[2]:
                best = (float(of), float(ob), e)
    return FittedModel(best[0], best[1])


def table1(model: FittedModel | None = None) -> dict:
    m = model or fit()
    return {
        "inf_s_float_b1": m.inferences_per_s(1, hybrid=False),
        "inf_s_float_b256": m.inferences_per_s(256, hybrid=False),
        "inf_s_hybrid_b1": m.inferences_per_s(1, hybrid=True),
        "inf_s_hybrid_b256": m.inferences_per_s(256, hybrid=True),
        "peak_gops_float": peak_gops("float"),
        "peak_gops_binary": peak_gops("binary"),
        "o_float": m.o_float,
        "o_binary": m.o_binary,
    }


def table2() -> dict:
    from repro_torch.core.hybrid_mlp import weight_memory_bytes
    return {
        "mem_float_bytes": weight_memory_bytes(hybrid=False),
        "mem_hybrid_bytes": weight_memory_bytes(hybrid=True),
    }


def table3(model: FittedModel | None = None) -> dict:
    m = model or fit()
    return {
        "energy_float_b256_mj": m.energy_per_inference_mj(256, hybrid=False),
        "energy_hybrid_b256_mj": m.energy_per_inference_mj(256, hybrid=True),
    }

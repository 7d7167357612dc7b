"""The port stands alone: importing every module of ``repro_torch``, and
everything ``chip_smoke.py`` imports, loads no ``jax*`` and no ``repro.*``
module; and an entry point asked for ``cuda`` on a machine without a card
raises instead of running on the CPU. Run in a fresh interpreter, since
this test process has already imported jax."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import importlib, importlib.util, json, pkgutil, sys
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
                or m == "repro")
raised = {}
if not torch.cuda.is_available():
    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model
    from repro_torch.launch import serve
    from repro_torch.core.hybrid_mlp import mlp_init
    from repro_torch.examples import quickstart
    for what, fn in [("init", lambda: get_model(smoke_config("stablelm-3b")).init(0)),
                     ("serve", lambda: serve.main(["--smoke", "--requests", "1"])),
                     ("mlp_init", lambda: mlp_init(0, hybrid=True)),
                     ("quickstart", lambda: quickstart.main([]))]:
        try:
            fn()
            raised[what] = None
        except RuntimeError as e:
            raised[what] = str(e)
print("RESULT:" + json.dumps({"modules": mods, "leaked": leaked, "raised": raised}))
"""


def test_port_imports_no_jax_and_refuses_missing_card():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT,
                           os.path.join(ROOT, "chip_smoke.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")][-1]
    out = json.loads(line[len("RESULT:"):])
    assert "repro_torch.serving.engine" in out["modules"]
    assert "repro_torch.kernels.flash_attention" in out["modules"]
    for mod in ("core.hybrid_mlp", "core.accelerator_model", "kernels.binary_matmul",
                "kernels.hybrid_dense", "kernels.bf16_matmul", "optim.bnn",
                "data.synthetic", "examples.quickstart", "kernels.kv_quant",
                "kernels.kv_decode", "serving.kvcache", "serving.prefix", "serving.spec",
                "serving.sampling", "serving.graphs", "serving.telemetry", "serving.bucket",
                "launch.server", "examples.serve_lm"):
        assert "repro_torch." + mod in out["modules"]
    assert out["leaked"] == []
    assert set(out["raised"]) == {"init", "serve", "mlp_init", "quickstart"}
    for what, msg in out["raised"].items():
        assert msg is not None and "no CUDA device" in msg, what

"""Hand-written CUDA kernels for Hopper, their plain torch versions and oracles
(port of repro.kernels).

``COUNTED`` lists every wrapper that counts its kernel's launches on its
``.launches`` attribute (one where it launches, nowhere else): the CUDA
graph runner (serving/graphs.py), chip_smoke.py and the card tests read
the counts through it."""

from repro_torch.kernels import bf16_matmul as _bf16
from repro_torch.kernels import binary_matmul as _xnor
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import hybrid_dense as _hybrid
from repro_torch.kernels import int8_matmul as _int8
from repro_torch.kernels import kv_decode as _kvd
from repro_torch.kernels import kv_quant as _kvq

COUNTED = (_int8.int8_matmul, _flash.flash_attention, _xnor.binary_matmul,
           _hybrid.hybrid_dense, _bf16.bf16_matmul,
           _kvq.kv_quant_int8, _kvq.kv_dequant_int8, _kvq.kv_quant_binary,
           _kvq.kv_dequant_binary, _kvd.kv_decode_int8, _kvd.kv_decode_binary)

"""Hand-written CUDA kernels of the port and their wrappers.

K1 (``flash_mqkv``, csrc/flash_mqkv.cu) is the Hopper counterpart of the
reference's Pallas ``flash_mqkv``; ``flash_attention`` and
``flash_attention_segments`` are the entry points models call.  K2
(``ring_flash_step``, csrc/ring_flash.cu) is the fused ring step: K1's
body plus the put of the KV chunk to the next ring rank.  The put kernels
K3 and K4 belong to the comm layer (comm/kernel_backend.py).  K5
(``rwkv6_wkv``, csrc/rwkv6_wkv.cu) is the chunked RWKV6 WKV scan;
``rwkv6_wkv_heads`` is its entry point in the model's [B, L, H, N]
layout, differentiable through K5b (csrc/rwkv6_wkv_bwd.cu), as
``flash_mqkv`` is through K1b (csrc/flash_mqkv_bwd.cu).  Importing this package builds nothing: a CUDA library is
compiled on the first launch on a CUDA tensor.
"""
from .ops import flash_attention, flash_attention_segments
from .ref import flash_attention_ref, rwkv6_wkv_ref
from .ring_flash import ring_flash_step
from .rwkv6_wkv import rwkv6_wkv, rwkv6_wkv_heads

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_segments",
           "ring_flash_step", "rwkv6_wkv", "rwkv6_wkv_heads", "rwkv6_wkv_ref"]

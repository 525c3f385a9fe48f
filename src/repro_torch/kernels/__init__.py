"""Hand-written CUDA kernels of the port and their [B, L, H, D] wrappers.

K1 (``flash_mqkv``, csrc/flash_mqkv.cu) is the Hopper counterpart of the
reference's Pallas ``flash_mqkv``; ``flash_attention`` and
``flash_attention_segments`` are the entry points models call.  Importing
this package builds nothing: the CUDA library is compiled on the first
launch on a CUDA tensor.
"""
from .ops import flash_attention, flash_attention_segments
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_segments"]

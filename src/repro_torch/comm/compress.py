"""On-wire compression for the inter-machine leg of the hierarchical
all-to-all (counterpart of ``src/repro/comm/compress.py``).

The slow leg of the hierarchical all-to-all (stream.py, ``hier_*``) can
quantise each bundle to an fp8 wire format with a per-tensor absmax
scale, ship (wire, scale) through the same put and dequantise on arrival:
half the inter-machine bytes of bf16, for one rounding per traversal.
The intra-machine leg is never compressed.

Error feedback (``ef_encode``): sampling sends the same activation family
every step, so the quantisation error is a bias, not noise.  Carrying the
residual — encode ``x + err`` and keep
``err' = (x + err) - decode(encode(x + err))`` for the next step — turns
it into a bounded moving residual.  The caller threads the buffers across
steps (``zero_feedback`` makes the first).

The codec is element-wise PyTorch, no kernel: ``x / scale`` in float32
cast to ``torch.float8_e4m3fn`` / ``torch.float8_e5m2`` rounds as the
reference's ``jnp`` cast does, so both packages put the same bytes on the
wire (``tests/test_torch_hier.py`` holds them bitwise).
"""
from __future__ import annotations

import torch

__all__ = ["WIRE_DTYPES", "has_wire_dtype", "quantize", "dequantize",
           "ef_encode", "zero_feedback"]

# wire dtypes the codec produces (names as the reference's)
WIRE_DTYPES = ("float8_e4m3fn", "float8_e5m2")


def _resolve(wire_dtype: str) -> torch.dtype:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; "
                         f"known: {WIRE_DTYPES}")
    dt = getattr(torch, wire_dtype, None)
    if dt is None:
        raise ValueError(
            f"wire dtype {wire_dtype!r} not available in this torch build")
    return dt


def has_wire_dtype(wire_dtype: str) -> bool:
    """True when this torch build can represent ``wire_dtype``."""
    try:
        _resolve(wire_dtype)
        return True
    except ValueError:
        return False


def _amax_scale(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    # absmax scaling to the wire format's finite range; the floor keeps an
    # all-zero payload (a padding chunk) exactly representable.  fmax is a
    # tensor on x's device: CUDA divides by a Python scalar as a product
    # with its reciprocal, one rounding away from the CPU's quotient
    amax = x.float().abs().max()
    fmax = torch.full((), torch.finfo(dt).max, dtype=torch.float32,
                      device=x.device)
    return torch.clamp_min(amax / fmax, 1e-30)


def quantize(x: torch.Tensor, wire_dtype: str
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode ``x`` for the wire: (payload in ``wire_dtype``, 0-d float32
    scale).  The scale rides the same put as the payload."""
    dt = _resolve(wire_dtype)
    scale = _amax_scale(x, dt)
    return (x.float() / scale).to(dt), scale


def dequantize(wire: torch.Tensor, scale: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Decode a wire payload back to the compute dtype."""
    return (wire.float() * scale).to(out_dtype)


def ef_encode(x: torch.Tensor, err: torch.Tensor, wire_dtype: str
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback encode: quantise ``x + err`` and return
    (wire, scale, err'), ``err'`` the float32 residual the caller carries
    to the next step."""
    dt = _resolve(wire_dtype)
    target = x.float() + err
    scale = _amax_scale(target, dt)
    wire = (target / scale).to(dt)
    return wire, scale, target - wire.float() * scale


def zero_feedback(x: torch.Tensor) -> torch.Tensor:
    """Initial (zero) error-feedback buffer for a payload like ``x``."""
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

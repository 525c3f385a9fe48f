"""Models of the port: the DiT and its building blocks."""
from .blocks import ParallelContext, resolve_device, torch_dtype
from .dit import dit_forward, init_dit, load_jax_params

__all__ = ["ParallelContext", "dit_forward", "init_dit", "load_jax_params",
           "resolve_device", "torch_dtype"]

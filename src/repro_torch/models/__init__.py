"""Models of the port: the DiT, the RWKV6 language model, their building
blocks and the registry that gives both one API."""
from .blocks import ParallelContext, resolve_device, torch_dtype
from .dit import dit_forward, init_dit, load_jax_params
from .lm import init_lm, init_lm_caches, lm_forward, load_jax_lm_params
from .registry import ModelBundle, get_model

__all__ = ["ModelBundle", "ParallelContext", "dit_forward", "get_model",
           "init_dit", "init_lm", "init_lm_caches", "lm_forward",
           "load_jax_lm_params", "load_jax_params", "resolve_device",
           "torch_dtype"]

"""Models of the port: the DiTs, the language models, the whisper
encoder-decoder, their building blocks and the registry that gives them
one API."""
from .blocks import ParallelContext, resolve_device, torch_dtype
from .dit import dit_forward, init_dit, load_jax_params
from .lm import init_lm, init_lm_caches, lm_forward, load_jax_lm_params
from .registry import ModelBundle, get_model
from .whisper import (decode_forward, encode, init_whisper,
                      init_whisper_caches, load_jax_whisper_params)

__all__ = ["ModelBundle", "ParallelContext", "decode_forward", "dit_forward",
           "encode", "get_model", "init_dit", "init_lm", "init_lm_caches",
           "init_whisper", "init_whisper_caches", "lm_forward",
           "load_jax_lm_params", "load_jax_params",
           "load_jax_whisper_params", "resolve_device", "torch_dtype"]

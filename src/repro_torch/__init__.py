"""StreamFusion DiT serving in PyTorch for one NVIDIA Hopper GPU.

The PyTorch/CUDA counterpart of the JAX package ``repro``: the same module
names and file layout, so each module's counterpart is easy to find.  It
imports torch and never jax, and nothing of ``repro``.  Framework-free
modules (configs, planner, comm model, calibration, metrics, the request
scheduler) are copies of the originals, pinned to them by equality tests.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.  CUDA sources under ``csrc/`` are compiled with ``nvcc`` on first
use (kernels/_build.py), never at import.
"""

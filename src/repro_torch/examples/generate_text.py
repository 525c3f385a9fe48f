"""Serve an LM with batched requests through the AR engine: continuous
batching over a KV cache sharded on the sequence over the mesh's SP axes.

A reduced qwen2-1.5b in float32 on the mesh (pod 2, data 2, model 2) of
virtual ranks; 4 batch slots, 6 prompts of 8 new tokens each.  The KV
caches take the model's dtype (ROADMAP F5):

    PYTHONPATH=src python -m repro_torch.examples.generate_text [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_reduced
from ..core import SPConfig
from ..launch.mesh import make_mesh
from ..models import get_model, torch_dtype
from ..serving import ARRequest, ARServer

PROMPTS = {
    1: [3, 1, 4, 1, 5],
    2: [2, 7, 1, 8],
    3: [9, 9, 9],
    4: [11],
    5: [5, 4, 3, 2, 1],
    6: [42, 42],
}
NEW_TOKENS = 8


def model_config():
    return dataclasses.replace(get_reduced("qwen2-1.5b"), dtype="float32")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = model_config()
    # decode shards the KV cache over (pod, model); 4 batch slots over data
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), args.device)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    params = get_model(cfg).init(cfg, gen, mesh.device)
    sp = SPConfig(strategy="swift", sp_axes=("pod", "model"),
                  batch_axes=("data",))
    srv = ARServer(params, cfg, sp, batch_slots=4, max_len=64, mesh=mesh,
                   cache_dtype=torch_dtype(cfg.dtype))
    for rid, p in PROMPTS.items():
        srv.submit(ARRequest(rid=rid, prompt=torch.tensor(p, dtype=torch.int32),
                             max_new_tokens=NEW_TOKENS))
    results = srv.serve()
    for rid in sorted(results):
        print(f"request {rid}: prompt={PROMPTS[rid]} -> {results[rid]}")
    ways = mesh.shape["pod"] * mesh.shape["model"]
    print(f"\nserved {len(results)} requests; KV cache sequence-sharded over "
          f"(pod × model) = {ways} ways")
    return {"tokens": results}


if __name__ == "__main__":
    main()

"""End-to-end driver: train a ~95M-parameter qwen2-family model on
synthetic data through the port's Trainer, at SP degree 1 on one device
(attention through K1, its gradient through K1b on the card), and report
whether the loss fell:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \
        [--device cpu] [--ckpt experiments/ckpt/train_lm_torch]
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import get_config
from ..configs.shapes import InputShape
from ..core import SPConfig
from ..train import AdamWConfig, Trainer


def model_config():
    """~95M parameters: 12 layers, d 768, ff 2304, vocab 16k, float32."""
    return dataclasses.replace(
        get_config("qwen2-1.5b"),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2304,
        vocab=16384, dtype="float32", sharding_overrides=(),
    )


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt", default=None,
                    help="save the trained parameters here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = model_config()
    n_params = cfg.params_dense_estimate()
    print(f"model: {n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model}")
    shape = InputShape("train_demo", args.seq, args.batch, "training")
    tr = Trainer(cfg, None, SPConfig(strategy="full"), shape,
                 opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=20,
                                     total_steps=args.steps),
                 ckpt_path=args.ckpt, device=args.device)
    _, history = tr.run(args.steps, log_every=args.log_every)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'OK: decreased' if last < first else 'WARN: did not decrease'})")
    return {"history": history, "step_seconds": tr.step_seconds}


if __name__ == "__main__":
    main()

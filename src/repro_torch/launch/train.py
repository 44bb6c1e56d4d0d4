"""Training launcher: trains a reduced (smoke) config on the synthetic
token stream, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20 --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, Trainer, save_checkpoint


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args()

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device (pass --device cpu "
                           "to train on the CPU)")
    cfg = get_config(args.arch, smoke=True)
    model = build_model(cfg, device=device, exact_moe=True,
                        generator=torch.Generator(device).manual_seed(0))
    trainer = Trainer(model,
                      AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10,
                                  total_steps=args.steps),
                      batch_size=args.batch_size, seq_len=args.seq_len)
    params, opt = trainer.init()
    params, opt, losses = trainer.run(params, opt, args.steps, log_every=20)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt, args.steps)
        print(f"checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()

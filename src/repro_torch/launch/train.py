"""Training launcher, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The counterpart of ``repro/launch/train.py``, with its flags plus
``--device`` (``cpu`` runs the same loop on the CPU). ``--reduced`` runs
the config's tiny same-family version; without it the full config trains
on one card (StarCoder2-3B: fp32 weights, grads and the two AdamW moments
take about 51 GB, and each checkpoint writes the params and both moments,
about 38 GB). Run again on a directory whose checkpoint has reached
``--steps``, it trains no step and says so (the reference's launcher
raises ``IndexError`` there: ROADMAP.md queue 3, fault 9).
"""
from __future__ import annotations

import argparse
import logging

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeSpec("cli_train", "train", args.seq, args.batch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       grad_compression=args.grad_compression)
    trainer = Trainer(cfg, shape, tcfg, device=args.device)
    trainer.run()
    losses = [s["loss"] for s in trainer.stats]
    if not losses:  # resumed at --steps: the reference's line raises IndexError here
        print(f"done: 0 steps, the checkpoint in {args.ckpt_dir} is at step {trainer.step}, "
              f"stragglers=0")
        return
    print(f"done: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"stragglers={len(trainer.straggler_events)}")


if __name__ == "__main__":
    main()

"""Training driver (port of ``repro.launch.train``), with checkpoint/restart
fault tolerance end to end:

  python -m repro_torch.launch.train --arch tiny-toy --steps 30 --device cpu
  python -m repro_torch.launch.train --arch tiny-toy --steps 30 \\
      --inject-failure 12 --device cpu
    (crashes at step 12; re-running the same command restores and finishes)

The JAX driver's flags and lines, plus ``--device``: the run is on
``cuda`` unless it names another, and raises when there is no card.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config, scale_down
from repro_torch.models import model as model_lib
from repro_torch.training.data import DataConfig, make_stream
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import DriverConfig, TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-toy")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-failure", type=int, default=None)
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = scale_down(cfg)
    tc = TrainConfig(remat=args.remat, grad_accum=args.grad_accum,
                     opt=AdamWConfig(lr=args.lr, total_steps=args.steps,
                                     warmup_steps=max(args.steps // 10, 1)))
    dc = DriverConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      inject_failure_at=args.inject_failure)
    trainer = Trainer(cfg, tc, dc, device=args.device)
    stream = make_stream(DataConfig(batch=args.batch, seq_len=args.seq,
                                    vocab_size=cfg.vocab_size,
                                    path=args.data))
    # skip batches already consumed before a restart (deterministic order)
    for _ in range(trainer.start_step):
        next(stream)
    out = trainer.fit(stream)
    for row in out["history"]:
        print(f"step {row['step']:5d}  loss {row['loss']:.4f}  "
              f"gnorm {row['grad_norm']:.3f}  {row['sec']*1e3:.0f} ms")
    print(f"done at step {out['final_step']} "
          f"({model_lib.num_params(cfg)/1e6:.1f}M params)")


if __name__ == "__main__":
    main()

"""Training launcher of the port.

    python -m repro_torch.launch.train --arch smollm-135m [--steps N] [--smoke-model]
        [--batch B] [--seq S] [--ckpt-dir D] [--device cpu]

Random weights from seed 0, ``TokenPipeline`` batches of ``--batch`` x
``--seq`` tokens (the ``--shape`` cell's by default), the configuration's
optimizer under ``cosine_with_warmup(3e-4, 100, steps)``, and the
``Trainer``'s checkpoints every ``max(steps // 5, 10)`` steps in
``--ckpt-dir``, resuming from the newest there.  Runs on ``cuda`` unless
``--device`` names another device; without CUDA and without ``--device``
it refuses.  ``--mesh`` takes ``host`` (one device) only: the production
and elastic meshes come with the launch tooling (ROADMAP queue item 5c).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import get_optimizer
from repro_torch.optim.schedule import cosine_with_warmup
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--mesh", default="host", choices=["host", "prod", "auto"])
    ap.add_argument("--smoke-model", action="store_true")
    ap.add_argument("--batch", type=int, default=0, help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--ckpt-dir", default="checkpoints/launch")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        ap.error(f"--mesh {args.mesh}: the production and elastic meshes are not ported "
                 "yet (ROADMAP queue item 5c, the launch tooling); use --mesh host")
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke_model else get_config(args.arch)
    shape = SHAPES[args.shape]
    b = args.batch or shape.global_batch
    s = args.seq or shape.seq_len
    print(f"mesh: host ({dev})  arch: {cfg.name}  batch={b} seq={s}")

    model = Model(cfg, device=dev, seed=0)
    opt = get_optimizer(cfg.optimizer)
    step_fn = make_train_step(model, opt, cosine_with_warmup(3e-4, 100, args.steps))
    pipeline = TokenPipeline(DataConfig(seq_len=s, global_batch=b, vocab_size=cfg.vocab_size))
    state = init_train_state(model, opt)
    trainer = Trainer(step_fn, pipeline, TrainerConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 5, 10), ckpt_dir=args.ckpt_dir))
    _, report = trainer.run(state)
    print(f"finished: {len(report.losses)} steps, "
          f"final loss {report.losses[-1]:.4f}" if report.losses else "finished: 0 steps")
    return report


if __name__ == "__main__":
    main()

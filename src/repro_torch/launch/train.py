"""Training launcher of the port.

    python -m repro_torch.launch.train --arch smollm-135m [--steps N] [--smoke-model]
        [--batch B] [--seq S] [--ckpt-dir D] [--device cpu]

Random weights from seed 0, ``TokenPipeline`` batches of ``--batch`` x
``--seq`` tokens (the ``--shape`` cell's by default), the configuration's
optimizer under ``cosine_with_warmup(3e-4, 100, steps)``, and the
``Trainer``'s checkpoints every ``max(steps // 5, 10)`` steps in
``--ckpt-dir``, resuming from the newest there.  Runs on ``cuda`` unless
``--device`` names another device; without CUDA and without ``--device``
it refuses.

Mesh selection:
  host  — one device (``--device``, or the card);
  prod  — the production (16, 16) mesh: it needs 256 devices, and with fewer
          the launcher exits naming the count (check the layout without
          them with ``python -m repro_torch.launch.dryrun``);
  auto  — the elastic plan for the local card count
          (``plan_mesh(torch.cuda.device_count()).build()``; with
          ``--device``, one island on it), active while
          the model trains (its MoE layers run their expert islands on it);
          on one card one island.  The step itself runs on the model's
          device: data parallelism across cards within a step is not part
          of the port (the JAX launcher gets it from GSPMD).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import context as dctx
from repro_torch.distributed.elastic import plan_mesh
from repro_torch.launch.mesh import executable, make_production_mesh
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

    mesh = None
    if args.mesh == "prod":
        try:
            mesh = executable(make_production_mesh())
        except RuntimeError as e:
            ap.exit(2, f"--mesh prod: {e}\n")
    elif args.mesh == "auto" and args.device is not None:
        mesh = plan_mesh(1).build([args.device])
    elif args.mesh == "auto":
        mesh = plan_mesh(torch.cuda.device_count() if torch.cuda.is_available() else 0).build()
    dev = resolve_device(args.device) if mesh is None else mesh.devices[0]
    cfg = get_smoke_config(args.arch) if args.smoke_model else get_config(args.arch)
    shape = SHAPES[args.shape]
    b = args.batch or shape.global_batch
    s = args.seq or shape.seq_len
    where = f"host ({dev})" if mesh is None else f"{mesh.shape} on {dev}"
    print(f"mesh: {where}  arch: {cfg.name}  batch={b} seq={s}")
    with dctx.use_mesh(mesh):
        return _train(cfg, dev, b, s, args)


def _train(cfg, dev, b: int, s: int, args):
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

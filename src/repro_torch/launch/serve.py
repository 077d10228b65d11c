"""Serving launcher: retrieval-augmented batched decoding on the card.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --full-size-model [--quantized-datastore]

``--arch`` takes every decoder-only architecture of the zoo (dense, MoE,
MLA, RWKV, the Mamba hybrid, the vision stub without patches); the engine
prefills tokens only, as the JAX package's does, so whisper-tiny (an
encoder-decoder that needs frames) is refused here and runs through
``Model.prefill(tokens, frames=...)`` and ``Model.decode_step``.
Random weights from seed 0 (the published checkpoint is not in the
repository), a flat datastore of 8,192 keys drawn on the device from
``embedding_datastore``'s recipe, and ``--requests`` prompts of 8 tokens,
as the JAX package's launcher.  Runs on ``cuda`` unless ``--device`` names
another device; without CUDA and without ``--device`` it refuses.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RetrievalConfig
from repro_torch.data.synthetic import embedding_datastore_on
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.retrieval import build_flat_datastore


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--smoke-model", action="store_true", default=True)
    ap.add_argument("--full-size-model", dest="smoke_model", action="store_false")
    ap.add_argument("--no-retrieval", action="store_true")
    ap.add_argument("--quantized-datastore", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke_model else get_config(args.arch)
    if cfg.family == "encdec":
        ap.error(f"{args.arch} is an encoder-decoder: the engine prefills tokens only; "
                 "run it through Model.prefill(tokens, frames=...) and Model.decode_step")
    if not args.no_retrieval:
        cfg = cfg.replace(retrieval=RetrievalConfig(
            enabled=True, k=8, lam=0.25, datastore_size=8192,
            quantized=args.quantized_datastore))
    model = Model(cfg, device=dev, seed=0)

    ds = None
    if not args.no_retrieval:
        keys, values = embedding_datastore_on(dev, 8192, cfg.d_model)
        ds = build_flat_datastore(keys, values % cfg.vocab_size,
                                  quantized=args.quantized_datastore, device=dev)

    engine = ServeEngine(model, num_slots=args.slots, max_len=args.max_len, datastore=ds)
    g = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=g.integers(0, cfg.vocab_size, size=(8,)).astype(np.int32),
            max_new_tokens=args.new_tokens))
    finished = engine.run()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out_tokens) for r in finished)
    lat = [r.latency_s for r in finished]
    print(f"{len(finished)} requests, {tok} tokens, {dt:.1f}s on {dev} "
          f"({tok / dt:.1f} tok/s incl. first-call set-up), "
          f"p50 latency {np.median(lat):.2f}s, "
          f"retrieval={'off' if args.no_retrieval else ('int8' if args.quantized_datastore else 'f32')}")


if __name__ == "__main__":
    main()

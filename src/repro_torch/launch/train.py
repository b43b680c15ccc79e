"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains a config end to end with the fault-tolerant ``Trainer`` on one device:
fp32 masters from ``--seed`` (the compute dtype the config's, weights cast
at use), restart from the newest complete checkpoint with ``--resume``,
synthetic batches (``make_batch(kind="train")``, one seed per step) or
token shards (``--data-dir``).  It runs on the card unless ``--device cpu``
is given::

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 8 --batch 4 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --layers 2 --steps 8 --batch 4 --seq 512

``--layers N`` keeps the first N layers at the config's full width, for a
model whose training state exceeds the card: fp32 masters, gradients and
AdamW moments take 16 bytes a parameter, ~490 GB for qwen3-moe-30b-a3b's
48 layers and ~30 GB for 2 of them.

The reference's multi-device flags (``--production-mesh``, ``--multi-pod``,
``--distributed``) belong to the port's distributed part, which is not
written yet: they are refused, not ignored.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.data.sharded import TokenShardDataset
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import get_model
from repro_torch.train.loop import TrainConfig, Trainer

DISTRIBUTED_FLAGS = ("production_mesh", "multi_pod", "distributed")


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' runs the plain CPU path")
    ap.add_argument("--layers", type=int, default=None, help="keep the first N layers (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-dir", default=None, help="token shards (else synthetic)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production-mesh", action="store_true", help="refused: no meshes in the port yet")
    ap.add_argument("--multi-pod", action="store_true", help="refused: no meshes in the port yet")
    ap.add_argument("--distributed", action="store_true", help="refused: no multi-host init in the port yet")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    for flag in DISTRIBUTED_FLAGS:
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} needs the port's distributed part (meshes, shardings, "
                     "multi-host init), which is not written yet")
    dev = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    model = get_model(cfg)
    print(f"arch={cfg.name} params={model.n_params / 1e6:.1f}M active={model.n_active_params / 1e6:.1f}M "
          f"device={dev}")
    tcfg = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(1, args.steps // 10),
        total_steps=args.steps,
        microbatches=args.microbatches,
        remat=args.remat,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    params = model.init(args.seed, dev, dtype=torch.float32)  # fp32 masters
    trainer = Trainer(model, tcfg, params)
    if args.resume and trainer.try_resume():
        print(f"resumed from step {trainer.step}")

    if args.data_dir:
        ds = TokenShardDataset(args.data_dir, seq_len=args.seq, global_batch=args.batch,
                               codebooks=cfg.n_codebooks if cfg.frontend == "audio_codec" else 0)

        def batches():
            step = trainer.step
            while True:
                b = {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(step).items()}
                if cfg.frontend == "vit":
                    b["patch_embeds"] = torch.zeros((args.batch, cfg.n_patches, cfg.vit_dim),
                                                    dtype=getattr(torch, cfg.dtype), device=dev)
                yield b
                step += 1
    else:
        def batches():
            step = trainer.step
            while True:
                yield make_batch(cfg, batch=args.batch, seq=args.seq, kind="train", seed=args.seed + step,
                                 device=dev)
                step += 1

    metrics = trainer.run(batches(), args.steps)
    out = {k: float(v) for k, v in metrics.items()}
    print(out)
    if trainer.retries:
        print(f"retries: {trainer.retries}")
    return out


if __name__ == "__main__":
    main()

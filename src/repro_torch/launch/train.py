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

``--distributed`` trains data-parallel, one process a rank under
``torchrun`` (RANK, LOCAL_RANK, WORLD_SIZE and the rendezvous address from
its environment): NCCL with rank r on card LOCAL_RANK, Gloo with
``--device cpu``, over ``make_local_mesh(data=world, model=1)`` as the
reference's launcher trains over every local device.  ``--batch`` is the
global batch (each rank computes its rows of it); the AdamW moments are
ZeRO-1 blocks (``distributed.data_parallel``); rank 0 alone prints and
writes checkpoints, which hold whole leaves, so a job resumes on any number
of ranks::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train --distributed --arch internlm2-1.8b --steps 8 --batch 4 --seq 512
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train --distributed --arch internlm2-1.8b --smoke --device cpu --steps 4

``--production-mesh`` and ``--multi-pod`` train over the reference's
production meshes (``make_production_mesh``: (16, 16) ("data", "model"), or
(2, 16, 16) with "pod"), one process a rank under torchrun: the weights
TP-sharded over "model" (``distributed.tp_layout``, each rank drawing its
shards piece by piece), the batch over ("pod", "data"), the moments ZeRO-1
blocks of the shards.  A job of another size than the mesh's 256 / 512
ranks exits naming both counts.
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.data.sharded import TokenShardDataset
from repro_torch.data.synthetic import make_batch
from repro_torch.kernels import _build
from repro_torch.distributed.tp_layout import TPLayout
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.registry import get_model
from repro_torch.train.loop import TrainConfig, Trainer

TP_MESH_FLAGS = ("production_mesh", "multi_pod")
RUN = "torchrun --nproc-per-node N -m repro_torch.launch.train --distributed ..."


def init_distributed(device: str | None) -> torch.device:
    """Join the process group torchrun describes: NCCL with this rank on
    card LOCAL_RANK (set before any CUDA work), Gloo with ``--device cpu``.
    -> this rank's device.  Without torchrun's environment, or with fewer
    cards than ranks, it exits with a message naming the fix."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(f"--distributed runs one process a rank under torchrun, which sets RANK and WORLD_SIZE: "
                         f"{RUN} (add --device cpu for Gloo on the CPU)")
    world, local = int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", "0"))
    if cpu:
        dev = torch.device("cpu")
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= cards:
            raise SystemExit(f"--distributed with {world} ranks needs a card a rank; rank {local} of this host finds "
                             f"{cards} card(s). Start as many ranks a host as it has cards: {RUN} (or add --device "
                             f"cpu for Gloo on the CPU)")
        torch.cuda.set_device(local)  # before any CUDA work: every launch goes to this rank's card
        dev = torch.device("cuda", local)
    dist.init_process_group("gloo" if cpu else "nccl", timeout=datetime.timedelta(seconds=600))
    return dev


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
    ap.add_argument("--production-mesh", action="store_true", help="(16, 16) ('data', 'model'): 256 ranks")
    ap.add_argument("--multi-pod", action="store_true", help="(2, 16, 16) ('pod', 'data', 'model'): 512 ranks")
    ap.add_argument("--distributed", action="store_true", help="data-parallel, one process a rank under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    flag = next((f for f in TP_MESH_FLAGS if getattr(args, f)), None)
    if flag is not None:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world != mesh.size:  # as Mesh.group refuses it, before any process group is made
            raise SystemExit(f"--{flag.replace('_', '-')}: {mesh!r} needs {mesh.size} ranks; this job runs {world}. "
                             f"Start one process a rank under torchrun, as for {RUN}, with --{flag.replace('_', '-')} "
                             f"in place of --distributed")
        dev = init_distributed(args.device)
    elif not args.distributed:
        return train(args, resolve_device(args.device))
    else:
        dev = init_distributed(args.device)
        mesh = make_local_mesh(data=dist.get_world_size(), model=1, device=dev)
    try:
        return train(args, dev, mesh)
    finally:
        dist.destroy_process_group()


def train(args, dev: torch.device, mesh=None) -> dict:
    """Train as ``args`` say on ``dev``; with a mesh, as one rank of it.
    -> the last step's metrics."""
    leader = mesh is None or dist.get_rank() == 0
    if mesh is not None and dev.type == "cuda":
        if leader:
            print(f"kernel build: {_build.build_all():.1f} s")
        dist.barrier()  # the other ranks load what rank 0 built
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.scaled(n_layers=args.layers)
    model = get_model(cfg)
    if leader:
        print(f"arch={cfg.name} params={model.n_params / 1e6:.1f}M active={model.n_active_params / 1e6:.1f}M "
              f"device={dev}" + ("" if mesh is None else f" data-parallel mesh: {mesh.shape['data']}x1 ('data', 'model')"
                                 if mesh.shape.get("model", 1) == 1 else f" mesh: {mesh!r}"))
    tcfg = TrainConfig(
        peak_lr=args.lr,
        warmup_steps=max(1, args.steps // 10),
        total_steps=args.steps,
        microbatches=args.microbatches,
        remat=args.remat,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    if mesh is not None and mesh.shape.get("model", 1) > 1:  # this rank's shards of the fp32 masters
        params = TPLayout(cfg, mesh).init_shards(model, args.seed, dev)
    else:
        params = model.init(args.seed, dev, dtype=torch.float32)  # fp32 masters, alike on every rank
    trainer = Trainer(model, tcfg, params, mesh)
    if args.resume and trainer.try_resume() and leader:
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
    if leader:
        print(out)
    if trainer.retries:
        print(f"retries: {trainer.retries}")
    return out


if __name__ == "__main__":
    main()

"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --smoke --device cpu --steps 6 --batch 8 --seq 128 [--ckpt-dir d/]

``--smoke`` selects the reduced config. Runs on the GPU unless ``--device
cpu`` is given; without a CUDA device and without ``--device cpu`` it
raises rather than fall back. ``--mesh single|multi`` trains the sharded
step (``train_loop.train(dist=)``) on the production mesh
(``launch/mesh.py``: 256 or 512 ranks), one process per rank started by
``torchrun`` (the group starts from its ``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``/``MASTER_PORT``, as the reference starts
``jax.distributed`` from ``JAX_COORDINATOR``; NCCL on the card, gloo with
``--device cpu``); a group of another size exits naming the ranks the
mesh needs; the context is the reference's ``DistContext(mesh=mesh)``,
so sequence parallelism is on (its default). A nonzero ``--devices``
(the reference's forced host device count) exits: ranks come from
``torchrun``.
With ``--ckpt-dir`` the run checkpoints every ``max(steps // 5, 10)``
steps and a second call resumes at the newest intact checkpoint. The
``audio`` and ``vlm`` families exit before any weight is built: their
forward needs an input (encoder frames, patch embeddings) that the token
sources (``data/pipeline.py``) do not make; the reference fails on the
missing key at its first step.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.launch.serve import resolve_device

MULTI_DEVICE = ("is multi-device: start one process per rank with torchrun "
                "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), or use "
                "--mesh none")
# the input each family's forward needs beyond tokens
EXTRA_INPUT = {"audio": "frames", "vlm": "patch_embeds"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--s-max", type=float, default=None)
    ap.add_argument("--step-size", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--no-guard", action="store_true",
                    help="disable the anomaly guard (device-side skip "
                         "+ host-side spike/rewind policy)")
    ap.add_argument("--data", default=None, help="memmap token file")
    ap.add_argument("--mesh", choices=["none", "single", "multi"],
                    default="none")
    ap.add_argument("--devices", type=int, default=0,
                    help="forced device count (multi-device only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (no fallback: cuda "
                         "without a GPU raises)")
    return ap


def main(argv=None):
    """Train on ``argv`` (default: the command line); returns (final
    state, history)."""
    args = build_parser().parse_args(argv)
    if args.devices:
        raise SystemExit(f"--devices {args.devices} {MULTI_DEVICE}")
    if args.mesh == "none":
        return _train(args, None)
    import os

    import torch.distributed as tdist
    if "WORLD_SIZE" not in os.environ and not tdist.is_initialized():
        raise SystemExit(f"--mesh {args.mesh} {MULTI_DEVICE}")
    resolve_device(args.device)
    started = not tdist.is_initialized()
    if started:
        tdist.init_process_group(
            "nccl" if args.device == "cuda" else "gloo", init_method="env://")
    try:
        from repro_torch.distributed.context import DistContext
        from repro_torch.launch.mesh import make_production_mesh
        if args.device == "cuda":
            import torch
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multi")
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}") from None
        return _train(args, DistContext(mesh))
    finally:
        if started:
            tdist.destroy_process_group()


def _train(args, dist):
    """Build the config, the source and the schedules from ``args`` and
    train (``dist`` None: one device)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_source
    from repro_torch.optim import adamw
    from repro_torch.training import train_loop

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in EXTRA_INPUT:
        raise SystemExit(
            f"{cfg.name} ({cfg.family!r}) trains on batches with "
            f"{EXTRA_INPUT[cfg.family]!r}, which the token sources "
            "(SyntheticLM, MemmapTokens) do not make")
    device = resolve_device(args.device)
    overrides = {}
    if args.s_max is not None:
        overrides["s_max"] = args.s_max
    if args.step_size is not None:
        overrides["step_size"] = args.step_size
    if overrides or cfg.blast.enabled:
        cfg = dataclasses.replace(cfg, blast=dataclasses.replace(
            cfg.blast, total_steps=args.steps, **overrides))

    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    source = make_source(cfg, shape, path=args.data)
    opt = adamw.AdamWConfig(peak_lr=args.lr, total_steps=args.steps,
                            warmup_steps=max(args.steps // 20, 5))
    loop = train_loop.TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 5, 10),
        guard=None if args.no_guard else train_loop.GuardConfig())
    state, history = train_loop.train(cfg, opt, source, loop,
                                      device=device, dist=dist)
    logged = [h for h in history if "loss" in h]
    if logged:
        print(f"done: final loss {logged[-1]['loss']:.4f}, "
              f"sparsity {logged[-1]['sparsity']:.3f}")
    else:             # resumed at --steps: nothing left to train
        print(f"done: nothing to train past step {state.step}")
    return state, history


if __name__ == "__main__":
    main()

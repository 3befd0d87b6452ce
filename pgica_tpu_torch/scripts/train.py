"""Two-stage training CLI of the port (the counterpart of scripts/train.py).

Usage:
    python -m pgica_tpu_torch.scripts.train --config configs/default.yaml --stage 1
    python -m pgica_tpu_torch.scripts.train --config configs/default.yaml --stage all --output-dir outputs
    python -m pgica_tpu_torch.scripts.train --config configs/smoke.yaml --device cpu --dry-run
    python -m pgica_tpu_torch.scripts.train --config configs/default.yaml \\
        --resume checkpoints/checkpoint_stage1_epoch3

On several cards, one process a card:
    torchrun --nproc_per_node=N -m pgica_tpu_torch.scripts.train --config configs/default.yaml

The flags are the JAX CLI's, with ``--platform`` replaced by ``--device``
(``cuda``, the default, or ``cpu``). Under ``torchrun`` (``WORLD_SIZE`` set)
or in a caller that has initialized ``torch.distributed`` already, the run
is parallel over the config's ``mesh``: data-parallel over its batch axes
(``mesh.zero1`` / ``mesh.zero3`` pick ZeRO; without them ``mesh.fsdp`` > 1
also cuts the parameters and Adam moments over ``fsdp`` at rest),
tensor-parallel over ``mesh.model`` and context-parallel (stage 2) over
``mesh.seq``; each rank
trains on the card of its ``LOCAL_RANK``, and rank 0 alone logs and writes.
A tensor- or context-parallel run on the CPU (``--device cpu``) takes gloo
ranks: ``torchrun --nproc_per_node=2 -m pgica_tpu_torch.scripts.train
--config <a config with mesh.model: 2> --device cpu``. A single process is
the one-device path. Missing dataset paths fall back to in-memory dummy
data, so a smoke run needs no dataset. ``main(argv)``
returns the exit code; ``run(argv)`` returns the trainer (None for a dry
run), for callers in the same process.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Preference-guided captioning training (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--stage", type=str, default="all", choices=["1", "2", "all"])
    p.add_argument("--resume", type=str, default=None, help="checkpoint path to resume from")
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--dry-run", action="store_true", help="validate config/model/data then exit")
    p.add_argument("--log-level", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains (cuda needs a card)")
    p.add_argument("--max-steps", type=int, default=None, help="debug: cap steps per epoch")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="trace steps 3-8 of each stage with torch.profiler into this dir")
    return p.parse_args(argv)


def run(argv: Optional[List[str]] = None):
    """Parse ``argv``, build everything from the config, train; the trainer (None for --dry-run)."""
    args = parse_args(argv)
    import torch

    from pgica_tpu_torch.core.device import rank_device
    from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import (
        create_loaders_with_fallback,
        create_mesh,
        create_model,
        create_processors,
        create_tokenizer,
        set_seed,
        setup_logging,
    )

    config = Config(args.config)
    if args.output_dir:
        config.set("paths.output_dir", args.output_dir)
        config.set("paths.checkpoint_dir", str(Path(args.output_dir) / "checkpoints"))
    if args.log_level:
        config.set("logging.level", args.log_level)
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = create_mesh(config, device)
    if not mesh.distributed and mesh.num_devices == 1 and not torch.distributed.is_initialized():
        mesh = None  # one process: the one-device path
    if mesh is None or mesh.rank == 0:
        setup_logging(config.get("paths.log_dir", "./logs"), config.get("logging.level", "INFO"))
    else:
        setup_logging(None, "WARNING")
    logger = logging.getLogger("train")
    if mesh is not None:
        logger.info("Mesh %s over %d rank(s) (batch axes data parallel, model tensor parallel, seq context "
                    "parallel), this rank %d, process group backend %s", mesh.shape, mesh.num_devices, mesh.rank,
                    torch.distributed.get_backend())
    set_seed(config.get("training.seed", 42))

    tokenizer = create_tokenizer(config)
    image_processor, text_processor = create_processors(config, tokenizer)
    logger.info("Building model (%s + %s) on %s...", config.get("model.vision_model"),
                config.get("model.text_model"), device)
    model = create_model(config, tokenizer, device=device)
    counts = model.num_parameters()
    logger.info("Model: %.1fM total / %.1fM trainable parameters", counts["total"] / 1e6, counts["trainable"] / 1e6)

    need_stage1 = args.stage in ("1", "all")
    need_stage2 = args.stage in ("2", "all") and config.get("training.stage2.num_epochs", 0) > 0
    train_loader = val_loader = pref_train = pref_val = None
    if need_stage1:
        train_loader, val_loader, _ = create_loaders_with_fallback(config, image_processor, text_processor,
                                                                   kind="conceptual")
    if need_stage2:
        pref_train, pref_val, _ = create_loaders_with_fallback(config, image_processor, text_processor,
                                                               kind="ultrafeedback")
    if args.dry_run:
        logger.info("Dry run OK: config valid, model built, loaders ready (stage1 batches=%s, stage2 batches=%s)",
                    len(train_loader) if train_loader else 0, len(pref_train) if pref_train else 0)
        return None

    trainer = PreferenceGuidedTrainer(
        model, config, train_loader=train_loader, val_loader=val_loader, preference_train_loader=pref_train,
        preference_val_loader=pref_val, mesh=mesh, output_dir=config.get("paths.output_dir", "./outputs"),
        profile_dir=args.profile_dir, max_steps_per_epoch=args.max_steps,
    )
    if args.resume:
        trainer.load_checkpoint(args.resume)
    if args.stage == "1":
        trainer.results = {"stage1": trainer.train_stage1()}
    elif args.stage == "2":
        trainer.results = {"stage2": trainer.train_stage2()}
    else:
        trainer.results = trainer.train()
    trainer.checkpoints.wait()
    out_dir = Path(config.get("paths.output_dir", "./outputs"))
    if trainer.is_writer:
        config.save(out_dir / "config_snapshot.yaml")
    logger.info("Training complete: %s", {k: v.get("best_val_loss") if isinstance(v, dict) else v
                                          for k, v in trainer.results.items()})
    return trainer


def main(argv: Optional[List[str]] = None) -> int:
    import torch.distributed as dist

    started = dist.is_initialized()
    run(argv)
    if dist.is_initialized() and not started:  # the group this process started (torchrun's environment)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

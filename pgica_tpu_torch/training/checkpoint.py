"""Checkpoints with the JAX package's names and payload (port of pgica_tpu/training/checkpoint.py).

Names: ``checkpoint_stage{S}_epoch{E}`` per epoch, ``best_model_stage{S}``
per stage, the rotating mid-epoch ``autosave_stage{S}``, and
``stage2_reference``. Each is a directory holding ``state.pt`` (one
``torch.save`` of the parameters by name, the optimizer state and the meta:
epoch, stage, global step, step in epoch, validation loss and the resolved
config) and a ``meta.json`` sidecar for people and tools. A save writes into
``<name>.tmp`` and renames it into place, so a reader never sees half a
checkpoint. The JAX package writes Orbax checkpoints; reading those is out
of scope. ``async`` saves (the autosave) copy the tensors to host memory at
once, the parameters being updated in place by the next step, and write
them on a thread; ``wait`` joins it, and every save or restore waits first.
Each save's bytes and seconds are kept in ``saves``. A checkpoint of LoRA
training holds the frozen base under ``params``, the factors under ``lora``
(``models/lora.py:lora_to_tree``) and the normalized config as
``meta.lora_config``; :func:`effective_params` merges them. A ZeRO run
saves its gathered parameters and, under ``opt_state["zero"]``, the Adam
moments gathered over the ranks (parallel/zero1.py:ZeroState.state_dict);
a tensor-parallel run saves its parameters and moments gathered over
``model`` (parallel/sharding.py), laid out as one process's; only rank 0's
manager writes.
"""

from __future__ import annotations

import json
import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import torch

from pgica_tpu_torch.training.optim import OptState

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _host(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


Named = Mapping[str, torch.Tensor]


def opt_state_dict(state: OptState, whole: Optional[Callable[[Named], Named]] = None) -> Dict[str, Any]:
    """The optimizer state on the host: AdamW's moments and count, MultiSteps' accumulator, by name;
    ``whole`` maps each of them to whole tensors (a tensor-parallel state's gather over ``model``)."""
    whole = whole or dict

    def named(tensors):
        return _host(whole(dict(zip(state.names, tensors))))

    return {
        "names": list(state.names),
        "count": int(state.count),
        "mini_step": int(state.mini_step),
        "mu": named(state.mu),
        "nu": named(state.nu),
        "acc": None if state.acc is None else named(state.acc),
    }


@torch.no_grad()
def load_opt_state(state: OptState, saved: Mapping[str, Any], local: Optional[Callable[[Named], Named]] = None) -> None:
    """Copy a saved optimizer state into ``state`` in place; raises if the trained leaves differ. ``local``
    cuts the saved whole tensors to this rank's blocks (tensor parallelism)."""
    if list(saved["names"]) != list(state.names):
        raise ValueError("the checkpoint's optimizer trains other parameters")
    if local is not None:
        saved = dict(saved, **{k: None if saved[k] is None else local(saved[k]) for k in ("mu", "nu", "acc")})
    for name, p in zip(state.names, state.params):
        if saved["mu"][name].shape != p.shape:
            raise ValueError(f"optimizer state shape changed for {name}")
    for key in ("mu", "nu"):
        for name, t in zip(state.names, getattr(state, key)):
            t.copy_(saved[key][name])
    state.count = int(saved["count"])
    state.mini_step = int(saved["mini_step"])
    state.acc = None if saved["acc"] is None else [
        saved["acc"][n].to(p.device, copy=True) for n, p in zip(state.names, state.params)]


def effective_params(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inference-ready parameters of a restored payload: a LoRA payload's base merged with its factors
    (JAX checkpoint.py:33-46), so every consumer (the CLIs, ``load_best_model_at_end``) sees plain
    parameters."""
    params, tree = payload["params"], payload.get("lora")
    if not tree:
        return params
    from pgica_tpu_torch.models.lora import apply_lora, lora_from_tree

    cfg = (payload.get("meta") or {}).get("lora_config") or {}
    return apply_lora(params, lora_from_tree(tree), alpha=float(cfg.get("alpha", 32.0)), rank=int(cfg.get("rank", 16)))


class CheckpointManager:
    """Per-epoch, per-stage-best and autosave checkpoints under one directory."""

    def __init__(self, checkpoint_dir, writer: bool = True):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.writer = writer  # False on every rank but 0 of a mesh: saves write nothing
        if writer:
            self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self.saves: List[Dict[str, Any]] = []  # name, bytes, seconds (to the file's rename), blocking_s

    def _path(self, name: str) -> Path:
        return (self.checkpoint_dir / name).resolve()

    def save(
        self,
        name: str,
        params: Mapping[str, torch.Tensor],
        opt_state=None,
        *,
        epoch: int = 0,
        stage: int = 1,
        global_step: int = 0,
        val_loss: Optional[float] = None,
        config: Optional[Dict] = None,
        step_in_epoch: int = 0,
        use_async: bool = False,
        lora: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
        lora_config: Optional[Dict] = None,
    ) -> Path:
        """Write ``params`` (name -> tensor) and, if given, the optimizer state (an ``OptState``, or a
        ZeRO state's gathered ``state_dict()``) and the LoRA factors (a ``lora_to_tree`` dict) with their
        config. A manager that is not the writer returns the path and writes nothing."""
        self.wait()
        t0 = time.perf_counter()
        path = self._path(name)
        if not self.writer:
            return path
        meta = {
            "epoch": epoch,
            "stage": stage,
            "global_step": global_step,
            "step_in_epoch": int(step_in_epoch),
            "val_loss": None if val_loss is None else float(val_loss),
            "config": config,
        }
        if lora_config is not None:
            meta["lora_config"] = {k: list(v) if isinstance(v, tuple) else v for k, v in lora_config.items()}
        payload = {"params": _host(params), "meta": meta}
        if opt_state is not None:
            payload["opt_state"] = opt_state if isinstance(opt_state, dict) else opt_state_dict(opt_state)
        if lora is not None:
            payload["lora"] = {path: _host(ab) for path, ab in lora.items()}
        record = {"name": name, "stage": stage, "global_step": global_step}

        def write():
            try:
                tmp = path.with_name(path.name + ".tmp")
                shutil.rmtree(tmp, ignore_errors=True)
                tmp.mkdir(parents=True)
                torch.save(payload, tmp / STATE_FILE)
                (tmp / "meta.json").write_text(json.dumps(meta, indent=2))
                shutil.rmtree(path, ignore_errors=True)
                tmp.rename(path)
                record["bytes"] = sum(f.stat().st_size for f in path.iterdir())
                record["seconds"] = time.perf_counter() - t0
            except Exception as e:  # re-raised by wait()
                self._error = e

        if use_async:
            self._thread = threading.Thread(target=write, name=f"checkpoint {name}", daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()
        record["blocking_s"] = time.perf_counter() - t0
        self.saves.append(record)
        logger.info("Saved checkpoint %s (stage %d epoch %d step %d)", path, stage, epoch, global_step)
        return path

    def save_epoch(self, stage: int, epoch: int, **kw) -> Path:
        return self.save(f"checkpoint_stage{stage}_epoch{epoch}", stage=stage, epoch=epoch, **kw)

    def save_best(self, stage: int, **kw) -> Path:
        return self.save(f"best_model_stage{stage}", stage=stage, **kw)

    def save_autosave(self, stage: int, **kw) -> Path:
        """Rotating mid-epoch checkpoint (``autosave_stage{S}``), written on a thread."""
        return self.save(f"autosave_stage{stage}", stage=stage, use_async=True, **kw)

    def wait(self) -> None:
        """Block until an in-flight async save has finished; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def restore(self, name_or_path) -> Dict[str, Any]:
        """``params``, ``opt_state`` (if saved) and ``meta`` of a checkpoint, on the host."""
        self.wait()
        path = Path(name_or_path)
        if not path.exists():
            path = self._path(str(name_or_path))
        if not (path / STATE_FILE).exists():
            raise FileNotFoundError(f"Checkpoint not found: {name_or_path}")
        return torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)

    def prune_epochs(self, stage: int, keep: int) -> None:
        """Delete all but the newest ``keep`` per-epoch checkpoints of a stage (best and autosave stay)."""
        self.wait()
        cands = sorted(self.checkpoint_dir.glob(f"checkpoint_stage{stage}_epoch*"),
                       key=lambda p: int(p.name.rsplit("epoch", 1)[1].split(".")[0]))
        for path in cands[: max(0, len(cands) - keep)]:
            shutil.rmtree(path, ignore_errors=True)
            logger.info("Pruned old checkpoint %s", path)

    def latest(self, stage: Optional[int] = None) -> Optional[Path]:
        pattern = f"checkpoint_stage{stage or '*'}_epoch*"
        candidates = sorted((p for p in self.checkpoint_dir.glob(pattern) if not p.name.endswith(".tmp")),
                            key=lambda p: (p.stat().st_mtime, p.name))
        return candidates[-1] if candidates else None

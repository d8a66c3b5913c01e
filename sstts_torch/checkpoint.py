"""Checkpoint / resume: the port of `sstts/checkpoint.py` (20-144) with
`torch.save` in place of orbax.

A checkpoint is one file per step under `workdir/<training.checkpoint_dir>`
holding the parameters, the batch-norm running statistics, the optimizer
state, the step, the EMA parameters (or None) and the whole config.  The
directory keeps the config fingerprint in `config.json` and refuses to mix
checkpoints of another config.  Restoring adapts the EMA tree both ways, as
the JAX package does: an EMA run resuming a checkpoint without one seeds it
from the restored parameters; a run without EMA keeps a stored EMA tree
available (for `inference.use_ema`).  Saves are synchronous and atomic
(written to a temporary file, then renamed).

A state on a mesh (its model's `mesh`) saves whole tensors: the
tensor-parallel shards of the parameters, the EMA and the Adam moments are
gathered over the model group, every rank of data row 0 taking part, and
rank 0 writes.  Restoring slices them again for the restoring rank, so a
checkpoint moves between layouts, one device among them, as the
reference's does (`sstts/config.py:274-280`).
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from sstts_torch.config import (
    ArchitectureConfig,
    Config,
    DatasetConfig,
    EvaluationConfig,
    InferenceConfig,
    TrainingConfig,
)
from sstts_torch.parallel.mesh import gather_tensor, shard_tensor

_FILE = re.compile(r"^step_(\d+)\.pt$")
_SECTIONS = {
    "dataset": DatasetConfig,
    "arch": ArchitectureConfig,
    "training": TrainingConfig,
    "evaluation": EvaluationConfig,
    "inference": InferenceConfig,
}


def config_from_dict(d: Mapping[str, Any]) -> Config:
    """The inverse of `dataclasses.asdict(Config)` (lists back to tuples)."""
    def section(cls, fields):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})

    return Config(**{name: section(cls, d[name]) for name, cls in _SECTIONS.items()})


def _cpu(tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def _checkpoint_files(directory: Path) -> Dict[int, Path]:
    if not directory.is_dir():
        return {}
    return {
        int(m.group(1)): p
        for p in directory.iterdir()
        if (m := _FILE.match(p.name))
    }


class CheckpointManager:
    def __init__(self, cfg: Config, workdir: str | Path):
        self.cfg = cfg
        self.dir = Path(workdir).absolute() / cfg.training.checkpoint_dir
        self.dir.mkdir(parents=True, exist_ok=True)
        fp_path = self.dir / "config.json"
        fingerprint = cfg.fingerprint()
        if fp_path.exists():
            if fp_path.read_text() != fingerprint:
                raise ValueError(
                    f"checkpoint dir {self.dir} was created with a different "
                    "config; refusing to mix. Delete it or change checkpoint_dir."
                )
        else:
            fp_path.write_text(fingerprint)

    def latest_step(self) -> Optional[int]:
        steps = _checkpoint_files(self.dir)
        return max(steps) if steps else None

    def save(self, step: int, state) -> None:
        """Write the state at `step`; keep the newest `keep_checkpoints`.
        On a mesh every rank calls it (module docstring)."""
        model = state.model
        mesh = model.mesh
        if mesh is not None and mesh.data_index != 0:
            return
        names = [n for n, _ in model.named_parameters()]

        def whole(tensors):
            return _cpu({n: gather_tensor(n, v, mesh) for n, v in tensors.items()})

        opt = state.optimizer.state_dict()
        opt["state"] = {
            i: {k: gather_tensor(names[i], v, mesh) if v.dim() else v for k, v in st.items()}
            for i, st in opt["state"].items()
        }
        payload = {
            "step": int(step),
            "params": whole(dict(model.named_parameters())),
            "batch_stats": _cpu(dict(model.named_buffers())),
            "opt_state": opt,
            "ema_params": None if state.ema_params is None else whole(state.ema_params),
            "config": dataclasses.asdict(self.cfg),
        }
        if mesh is not None and mesh.rank != 0:
            return
        path = self.dir / f"step_{int(step)}.pt"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        files = _checkpoint_files(self.dir)
        for old in sorted(files)[: max(0, len(files) - self.cfg.training.keep_checkpoints)]:
            files[old].unlink()

    def load(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The stored payload at `step` (None: the newest), on the CPU, or
        None when the directory holds no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.dir / f"step_{step}.pt", map_location="cpu", weights_only=True)

    def restore_latest(self, state) -> Optional[int]:
        """Load the newest checkpoint into `state` (in place) and return its
        step, or None when there is none."""
        payload = self.load()
        if payload is None:
            return None
        model = state.model
        mesh = model.mesh

        def local(tensors):
            return {n: shard_tensor(n, v, mesh) for n, v in tensors.items()}

        model.load_state_dict({**local(payload["params"]), **payload["batch_stats"]}, strict=True)
        names = [n for n, _ in model.named_parameters()]
        opt = payload["opt_state"]
        opt["state"] = {
            i: {k: shard_tensor(names[i], v, mesh) if v.dim() else v for k, v in st.items()}
            for i, st in opt["state"].items()
        }
        state.optimizer.load_state_dict(opt)
        state.step = payload["step"]
        dev = next(model.parameters()).device
        stored = payload["ema_params"]
        if stored is not None:
            state.ema_params = {k: v.to(dev) for k, v in local(stored).items()}
        elif state.ema_params is not None:
            state.ema_params = {n: p.detach().clone() for n, p in model.named_parameters()}
        return state.step


def load_params(workdir: str | Path, cfg: Optional[Config] = None) -> Tuple[Config, Dict[str, torch.Tensor]]:
    """(config, state_dict) for serving from the newest checkpoint under
    `workdir`: the stored config unless `cfg` is given (it must share the
    stored fingerprint), and the EMA parameters when
    `cfg.inference.use_ema`.  Raises FileNotFoundError without one."""
    ckpt_dir = Path(workdir) / (cfg or Config()).training.checkpoint_dir
    files = _checkpoint_files(ckpt_dir)
    if not files:
        raise FileNotFoundError(f"no checkpoint under {workdir}")
    payload = torch.load(files[max(files)], map_location="cpu", weights_only=True)
    stored = config_from_dict(payload["config"])
    if cfg is None:
        cfg = stored
    elif cfg.fingerprint() != stored.fingerprint():
        raise ValueError(
            f"checkpoint under {workdir} was written with a different config"
        )
    params = payload["params"]
    if cfg.inference.use_ema:
        if payload["ema_params"] is None:
            raise ValueError(
                f"inference.use_ema: checkpoint under {workdir} stores no "
                "ema_params (train with training.ema_decay > 0)"
            )
        params = payload["ema_params"]
    return cfg, {**params, **payload["batch_stats"]}

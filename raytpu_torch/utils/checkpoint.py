"""Checkpoint and resume for optimization loops, with ``torch.save``.

Counterpart of ``raytpu/utils/checkpoint.py`` (orbax there).  A checkpoint
is a directory holding one ``state.pt``: a dict of tensors, numbers and
nested dicts and lists, such as ``{"params": {...}, "opt_state":
optimizer.state_dict(), "step": 7}``.  A ``torch.optim`` optimizer keeps
its own state, so resuming a ``grad.diff_render.make_train_step`` loop
needs its ``state_dict()`` saved beside the parameters and loaded back
with ``load_state_dict``.

Writes are atomic: the state goes into a temporary directory beside the
target, which then takes the target's name (``os.replace``), so a reader
finds the old checkpoint or the new one, never a torn file.  Loads use
``weights_only=True``: only tensors and plain containers are unpickled.
``CheckpointManager`` keeps ``root/step_N`` directories, as raytpu's does.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def save(path: str, state: Any) -> None:
    """Save ``state`` into the directory ``path``, replacing what was there."""
    p = Path(path).resolve()
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{p.name}.tmp-", dir=p.parent))
    try:
        torch.save(state, tmp / STATE_FILE)
        if p.exists():  # a directory is replaced only by renaming onto an empty one
            old = Path(tempfile.mkdtemp(prefix=f".{p.name}.old-", dir=p.parent))
            os.replace(p, old / p.name)
            os.replace(tmp, p)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def restore(path: str, like: Optional[Any] = None) -> Any:
    """The state saved under ``path``.  Without ``like`` every tensor lies on
    the CPU.  With ``like`` (a state of the same structure) the keys, list
    lengths and every tensor's shape and dtype must match, and each tensor
    moves to the device of its counterpart in ``like``; an empty dict in
    ``like`` (the state of an optimizer that has not stepped) takes the
    saved dict as it is."""
    state = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
    return state if like is None else _like(state, like, "")


def _like(saved, like, where: str):
    if isinstance(like, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint{where}: a dict was expected, found {type(saved).__name__}")
        if not like:
            return saved
        if set(saved) != set(like):
            raise ValueError(f"checkpoint{where}: keys {sorted(map(str, saved))} differ from "
                             f"{sorted(map(str, like))}")
        return {k: _like(saved[k], like[k], f"{where}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint{where}: a sequence of {len(like)} was expected")
        return type(like)(_like(s, x, f"{where}[{i}]") for i, (s, x) in enumerate(zip(saved, like)))
    if isinstance(like, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"checkpoint{where}: a tensor was expected, found {type(saved).__name__}")
        if saved.shape != like.shape or saved.dtype != like.dtype:
            raise ValueError(f"checkpoint{where}: {tuple(saved.shape)} {saved.dtype} saved, "
                             f"{tuple(like.shape)} {like.dtype} expected")
        return saved.to(like.device)
    return saved


def latest_step(root: str) -> Optional[int]:
    """The newest ``step_N`` under ``root``, or None."""
    r = Path(root)
    if not r.is_dir():
        return None
    steps = [int(d.name[5:]) for d in r.iterdir() if d.name.startswith("step_") and d.name[5:].isdigit()]
    return max(steps) if steps else None


class CheckpointManager:
    """``save_step(step, state)`` writes ``root/step_N`` and keeps the last
    ``keep`` of them; ``restore_latest(like)`` returns ``(step, state)``, or
    ``(None, None)`` where there is none."""

    def __init__(self, root: str, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)

    def save_step(self, step: int, state: Any) -> None:
        save(str(self.root / f"step_{step}"), state)
        steps = sorted(int(d.name[5:]) for d in self.root.iterdir()
                       if d.name.startswith("step_") and d.name[5:].isdigit())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    def restore_latest(self, like: Optional[Any] = None):
        step = latest_step(str(self.root))
        if step is None:
            return None, None
        return step, restore(str(self.root / f"step_{step}"), like)

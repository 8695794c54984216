"""Train-state checkpoints and exported weights (port of efficientat_tpu/utils/checkpointing.py).

The reference writes only the latest model ``state_dict`` per epoch and
deletes the previous file; optimizer and epoch state are lost and there is
no resume (ex_audioset.py:216-220). Here, as in the JAX package, the whole
train state is kept, the latest ``keep`` epochs of it, and ``--resume``
continues from the newest:

- ``save_checkpoint`` writes ``<dir>/epoch_<NNNNNN>.pt`` with ``torch.save``
  (model, optimizer, scheduler, step, epoch, the step's generator states),
  through a temporary file and a rename, then deletes all but the newest
  ``keep``;
- ``export_weights`` writes the model's ``state_dict`` alone, with the
  upstream key names, which ``models.convert.load_pretrained`` and the
  ``Tagger`` load with ``strict=True``.

Files are read back with ``weights_only=True``: no code runs on load.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _epochs(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
                  if m)


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch:06d}.pt")


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any], epoch: int,
                    keep: int = 1) -> str:
    """Write ``state`` as the checkpoint of ``epoch``; keep the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({**state, "epoch": epoch}, tmp)
    os.replace(tmp, path)
    for old in _epochs(ckpt_dir)[:-max(keep, 1)]:
        os.remove(_path(ckpt_dir, old))
    return path


def restore_checkpoint(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    """The newest checkpoint's state (on the CPU), or None if there is none."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return None
    return torch.load(_path(ckpt_dir, epochs[-1]), map_location="cpu",
                      weights_only=True)


def export_weights(path: str, model: torch.nn.Module) -> None:
    """Write the model's ``state_dict`` (upstream key names, CPU tensors)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)

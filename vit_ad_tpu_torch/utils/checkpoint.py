"""Checkpoints of the port's runs (port of `vit_ad_tpu/utils/checkpoint.py`:
`save_params` :119, `load_tree` :138, `load_params` :153).

A checkpoint is one `torch.save` file of a state dict, in the reference
layout that `cli.score --pth` reads. It is written atomically: the bytes go
to a temporary file in the same directory, which `os.replace` then puts in
place, so a crash mid-save leaves the previous file or none, never a torn
one (the JAX `find_checkpoint` skips orbax's tmp artifacts for the same
reason). The run directory's `config.json` lists the checkpoint files by name,
so a leftover temporary file is never read.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import torch

TMP_PREFIX = ".tmp-"


def save_params(directory: str, name: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write `state_dict` (moved to the CPU) as `directory/name`; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    fd, tmp = tempfile.mkstemp(prefix=TMP_PREFIX + name, dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def load_tree(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint, on the CPU (tensors only: no pickled
    code is run)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into `module` strictly; returns the module."""
    module.load_state_dict(load_tree(path), strict=True)
    return module

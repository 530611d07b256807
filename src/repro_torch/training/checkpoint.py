"""Checkpoint / restart (the counterpart of ``repro.training.checkpoint``).

Arrays are saved whole as one ``.npz`` plus a JSON manifest, keyed by tree
paths in the reference's layout (``params/<path>``, ``opt/<path>``), so the
layout on disk does not depend on the ring size: restoring under another
ring is load + copy to the new devices. bf16 leaves are stored as their
``uint16`` bit view (see ``models.module.params_to_numpy``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.models.module import _flatten, _unflatten, params_to_numpy


def save_checkpoint(directory: str, *, params, opt_state=None, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    payload = {f"params/{k}": v for k, v in _flatten(params_to_numpy(params))}
    if opt_state is not None:
        payload.update({f"opt/{k}": v
                        for k, v in _flatten(params_to_numpy(opt_state))})
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on crash
    manifest = {
        "step": step,
        "file": os.path.basename(path),
        "time": time.time(),
        "extra": extra or {},
    }
    mtmp = os.path.join(directory, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The step of the newest checkpoint in ``directory`` (None without a
    manifest)."""
    mpath = os.path.join(directory, "manifest.json")
    if not os.path.exists(mpath):
        return None
    with open(mpath) as f:
        return int(json.load(f)["step"])


def load_checkpoint(directory: str) -> Tuple[Any, Any, int, Dict]:
    """Returns (params, opt_state, step, extra) as numpy trees; carry them
    onto a device with ``models.module.params_from_reference``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    params_flat, opt_flat = {}, {}
    with np.load(os.path.join(directory, manifest["file"])) as data:
        for key in data.files:
            if key.startswith("params/"):
                params_flat[key[len("params/"):]] = data[key]
            elif key.startswith("opt/"):
                opt_flat[key[len("opt/"):]] = data[key]
    params = _unflatten(params_flat)
    opt_state = _unflatten(opt_flat) if opt_flat else None
    return params, opt_state, int(manifest["step"]), manifest.get("extra", {})

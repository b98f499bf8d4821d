"""Checkpoint / resume for long evaluations.

Counterpart of ``plf_tpu/utils/checkpoint.py``, NumPy and JSON only.  A
long tree search or many-traversal job snapshots its state (arrays,
which may be tensors on the card, and JSON-serialisable metadata such as
the current tree as newick and its counters) and resumes after
preemption.

Format: a single .npz (portable, no framework lock-in) with a manifest.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_exists"]

_MANIFEST_KEY = "__manifest__"


def save_checkpoint(path: str, arrays: Dict[str, "np.ndarray"],
                    meta: Optional[dict] = None) -> None:
    """Atomically write arrays + JSON-serialisable metadata."""
    host = {}
    for k, v in arrays.items():
        if k == _MANIFEST_KEY:
            raise ValueError(f"reserved key: {k}")
        host[k] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                   else np.asarray(v))
    manifest = json.dumps(meta or {})
    tmp = path + ".tmp"
    np.savez(tmp, **host, **{_MANIFEST_KEY: np.frombuffer(
        manifest.encode(), dtype=np.uint8)})
    # np.savez appends .npz to the name it opens
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Load arrays + metadata; arrays come back as NumPy (device-put as
    needed by the caller)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != _MANIFEST_KEY}
        meta = {}
        if _MANIFEST_KEY in z.files:
            meta = json.loads(bytes(z[_MANIFEST_KEY]).decode())
    return arrays, meta


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path)

"""Persistence for batch calibrations and the surrogate's state (the JAX
package's ``utils/checkpoint.py``).

  * ``save_batch_calibration`` / ``load_batch_calibration``: the JAX
    package's npz layout (one array per ``BatchCalibration`` field, plus
    ``surface_ids``) and its ``.meta.json`` side file, so either package
    loads the other's files;
  * ``save_surrogate_state`` / ``load_surrogate_state``: the port's
    counterpart of the JAX package's orbax pair, ``torch.save`` of the
    module's state_dict (``state_dict.pt``) beside ``scalers.npz`` with
    the JAX package's keys (``f_mean``, ``f_scale``, ``t_mean``,
    ``t_scale``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..surrogate.ffn import SurrogateFFN
from ..surrogate.scalers import StandardScaler
from ..surrogate.train import TrainedSurrogate

STATE_FILE = "state_dict.pt"
SCALERS_FILE = "scalers.npz"


def save_batch_calibration(path: str, out, surface_ids=None,
                           metadata: Optional[dict] = None) -> None:
    """Persist a BatchCalibration (or any NamedTuple of tensors or arrays)
    to a compressed npz (``.npz`` appended if missing)."""
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in out._asdict().items()}
    if surface_ids is not None:
        arrays["surface_ids"] = np.asarray(surface_ids)
    np.savez_compressed(path, **arrays)
    if metadata:
        with open(str(path) + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def load_batch_calibration(path: str) -> dict:
    """Load a saved batch calibration as a dict of numpy arrays."""
    p = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def save_surrogate_state(ckpt_dir: str, surrogate: TrainedSurrogate) -> None:
    """The surrogate's state_dict and scalers under ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in
             surrogate.model.state_dict().items()}
    torch.save(state, os.path.join(ckpt_dir, STATE_FILE))
    np.savez(os.path.join(ckpt_dir, SCALERS_FILE),
             f_mean=surrogate.feature_scaler.mean_,
             f_scale=surrogate.feature_scaler.scale_,
             t_mean=surrogate.target_scaler.mean_,
             t_scale=surrogate.target_scaler.scale_)


def load_surrogate_state(ckpt_dir: str) -> TrainedSurrogate:
    """Restore a ``TrainedSurrogate`` (on the CPU) saved by
    ``save_surrogate_state``."""
    model = SurrogateFFN()
    model.load_state_dict(torch.load(os.path.join(ckpt_dir, STATE_FILE),
                                     map_location="cpu", weights_only=True))
    with np.load(os.path.join(ckpt_dir, SCALERS_FILE)) as z:
        fs = StandardScaler(z["f_mean"], z["f_scale"])
        ts = StandardScaler(z["t_mean"], z["t_scale"])
    return TrainedSurrogate(model, fs, ts)

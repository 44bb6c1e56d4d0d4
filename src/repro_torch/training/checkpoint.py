"""npz checkpoints in the JAX package's format: leaves under
``'/'``-joined key paths (``params/<a/b/c>``, ``opt/step``, ``opt/m/...``,
``opt/v/...``) and ``meta/step``; floating leaves are stored fp32. A
checkpoint written by either package loads in the other."""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.bridge import params_to_numpy
from repro_torch.training.tree import flatten, unflatten


def save_checkpoint(path: str, params: Dict, opt_state: Optional[Dict] = None,
                    step: int = 0) -> None:
    """Write ``params`` (and ``opt_state``) and ``step`` to ``path``
    (``np.savez``, which appends ``.npz`` when it is missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = {f"params/{k}": v
            for k, v in flatten(params_to_numpy(params)).items()}
    if opt_state is not None:
        blob.update({f"opt/{k}": v
                     for k, v in flatten(params_to_numpy(opt_state)).items()})
    blob["meta/step"] = np.asarray(step)
    np.savez(path, **blob)


def load_checkpoint(path: str, params_template: Dict,
                    opt_template: Optional[Dict] = None
                    ) -> Tuple[Dict, Optional[Dict], int]:
    """Restore ``(params, opt_state, step)`` into the structure of the
    templates: each leaf as stored (dtype and bits), on its template
    leaf's device."""
    with np.load(path) as z:
        def restore(template, prefix):
            return unflatten({
                k: torch.from_numpy(z[f"{prefix}/{k}"]).to(leaf.device)
                for k, leaf in flatten(template).items()})

        params = restore(params_template, "params")
        opt = restore(opt_template, "opt") if opt_template is not None \
            else None
        step = int(z["meta/step"])
    return params, opt, step

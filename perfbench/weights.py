"""Seeded weights of a dense decoder, made on the device in a few calls.

One tensor a leaf, stacked over the layers in the layout the port reads
(``x @ W`` with ``[in, out]`` matrices, a leading layer axis), drawn with
one ``torch.Generator`` on the device in the type the model is served in.
The program and the plain reference are handed these same tensors.

Scales: the embedding at 1, so the residual stream starts at unit size;
every matrix at ``fan_in ** -0.5``; the head at ``LOGIT_STD · d ** -0.5``,
so the logits have a standard deviation of about ``LOGIT_STD`` at any
width; the norm weights, stored in fp32 and applied as ``1 + w``, at
``NORM_STD`` so that they are not the identity.
"""
from __future__ import annotations

from typing import Dict

import torch

LOGIT_STD = 4.0
NORM_STD = 0.1


def make_params(dims: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The parameter tree of ``dims`` (see :func:`harness.model_dims`)
    drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    d, n, f = dims["d"], dims["n_layers"], dims["d_ff"]
    h, kvh, hd, v = dims["h"], dims["kvh"], dims["hd"], dims["vocab"]

    def mat(shape, std):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(std)

    def norm(shape):
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return t.mul_(NORM_STD)

    return {
        "embed": mat((v, d), 1.0),
        "final_norm": norm((d,)),
        "head": mat((d, v), LOGIT_STD * d ** -0.5),
        "layers": {
            "ln1": norm((n, d)),
            "ln2": norm((n, d)),
            "attn": {"wq": mat((n, d, h * hd), d ** -0.5),
                     "wk": mat((n, d, kvh * hd), d ** -0.5),
                     "wv": mat((n, d, kvh * hd), d ** -0.5),
                     "wo": mat((n, h * hd, d), (h * hd) ** -0.5)},
            "mlp": {"w_gate": mat((n, d, f), d ** -0.5),
                    "w_up": mat((n, d, f), d ** -0.5),
                    "w_down": mat((n, f, d), f ** -0.5)},
        },
    }

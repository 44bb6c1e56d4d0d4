"""A model family that the tests plant in a copy of the benchmark: the
dense decoder with a per-head RMSNorm on q and k before RoPE (Qwen3's
attention; the registry's ``qwen3-32b``). It is new files only, a module
and its reference, which is what the family contract
(``perfbench/families/dense.py``) asks of a family."""
import dataclasses
from typing import Dict

import torch

import counts
import harness
import weights

reference = "qk_norm_reference.py"

SMOKE = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
             head_dim=64, intermediate_size=512, vocab_size=512)


def dims(config: Dict) -> Dict:
    """The dense sizes; the norms add no size."""
    return harness.model_dims(config)


def port_config(config: Dict, dims: Dict):
    """The dense port config with qk-norm on."""
    return dataclasses.replace(harness.port_config(config, dims),
                               qk_norm=True)


def make_params(dims: Dict, seed: int, device, dtype) -> Dict:
    """The dense tree, then ``q_norm`` and ``k_norm`` ``[layers, hd]``
    (fp32 offsets from 1, as the other norms, at four times their spread
    so that the norm decides tokens) from a second stream of the seed."""
    params = weights.make_params(dims, seed, device, dtype)
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2 ** 63)
    attn = params["layers"]["attn"]
    for key in ("q_norm", "k_norm"):
        attn[key] = torch.randn((dims["n_layers"], dims["hd"]),
                                generator=gen, device=device,
                                dtype=torch.float32).mul_(4 * weights.NORM_STD)
    return params


def model_flops(dims: Dict, *, tokens: int, attn_pairs: int,
                head_rows: int) -> int:
    """The dense count: the norms are no matrix product."""
    return counts.model_flops(
        dims["n_layers"], dims["d"], dims["h"], dims["kvh"], dims["hd"],
        dims["d_ff"], dims["vocab"], tokens=tokens, attn_pairs=attn_pairs,
        head_rows=head_rows)


def smoke(config: Dict) -> Dict:
    """``config`` at the widths of :data:`SMOKE`."""
    return dict(config, **SMOKE)

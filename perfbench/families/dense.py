"""The dense decoder family: Qwen2 / Llama layers (RMSNorm, grouped-query
attention with RoPE, SwiGLU), the family of a configuration that names
none. It wraps the harness's own pieces, which read exactly what they
read before families existed.

A model family is one module ``perfbench/families/<family>.py``, named by
the optional ``"family"`` key of a configuration file (``"dense"`` where
the key is missing). The harness reaches the model only through these
names of it:

- ``dims(config) -> dict``: the sizes that the family's other functions,
  the traffic (``vocab``) and the per-layer readers (``n_layers``,
  ``page``, and for GQA attention ``h``, ``kvh``, ``hd``) read.
- ``port_config(config, dims) -> ModelConfig``: the port's config of the
  registry's ``arch`` with the file's sizes, the cut ones included.
- ``make_params(dims, seed, device, dtype) -> dict``: the parameter tree
  in the layout the port's ``DecoderModel`` reads, drawn from the seed on
  the device.
- ``reference``: the file of the family's plain reference, relative to
  this folder. It holds ``served_logits(params, dims, seqs, starts,
  quant=None)``, a float32 forward in plain ``torch`` with TF32 off
  (``quant="fp8"`` is the control), and imports nothing but ``torch``,
  ``numpy`` and the standard library.
- ``model_flops(dims, *, tokens, attn_pairs, head_rows) -> int``: the
  model operations of a forward, which ``step_mfu`` divides by.
- ``smoke(config) -> config``: the configuration at the CPU widths that
  the benchmark's tests run.
"""
from typing import Dict

import counts
import harness
import weights

reference = "../reference.py"

SMOKE = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
             head_dim=64, intermediate_size=512, vocab_size=512)


def dims(config: Dict) -> Dict:
    """:func:`harness.model_dims`."""
    return harness.model_dims(config)


def port_config(config: Dict, dims: Dict):
    """:func:`harness.port_config`."""
    return harness.port_config(config, dims)


def make_params(dims: Dict, seed: int, device, dtype) -> Dict:
    """:func:`weights.make_params`."""
    return weights.make_params(dims, seed, device, dtype)


def model_flops(dims: Dict, *, tokens: int, attn_pairs: int,
                head_rows: int) -> int:
    """:func:`counts.model_flops` of the dense layers of ``dims``."""
    return counts.model_flops(
        dims["n_layers"], dims["d"], dims["h"], dims["kvh"], dims["hd"],
        dims["d_ff"], dims["vocab"], tokens=tokens, attn_pairs=attn_pairs,
        head_rows=head_rows)


def smoke(config: Dict) -> Dict:
    """``config`` at the widths of :data:`SMOKE`."""
    return dict(config, **SMOKE)

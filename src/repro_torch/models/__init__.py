"""Model side of the port: layers, RoPE, attention (GQA and MLA), MoE,
the decoder's parameters and the bridge from the JAX parameter
pytree."""
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import DecoderModel, init_params

__all__ = ["DecoderModel", "init_params", "params_from_numpy"]

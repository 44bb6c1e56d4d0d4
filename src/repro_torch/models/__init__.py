"""Model side of the port: layers, RoPE, attention (GQA, MLA, encoder and
cross), MoE, SSM, the decoder's and the encoder-decoder's parameters, and
the bridge from the JAX parameter pytree."""
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import DecoderModel, init_params

__all__ = ["DecoderModel", "EncDecModel", "build_model", "init_params",
           "params_from_numpy"]

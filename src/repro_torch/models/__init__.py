"""Model zoo of the port: config-driven decoder in plain PyTorch."""
from .bridge import params_from_numpy
from .config import LayerGroup, ModelConfig
from .transformer import (decode_step, decode_step_ragged, forward,
                          in_place_leaves, init_cache, init_params, lm_loss,
                          prefill)

__all__ = ["LayerGroup", "ModelConfig", "decode_step", "decode_step_ragged",
           "forward", "in_place_leaves", "init_cache", "init_params",
           "lm_loss", "params_from_numpy", "prefill"]

"""The port's towers; ``build_tower`` picks one from a model config."""

from __future__ import annotations

from haconvdr_torch.config import DeepseekV2Config, ModelConfig
from haconvdr_torch.device import DeviceLike


def build_tower(params, cfg: ModelConfig, device: DeviceLike = None, int8: bool = False):
    """The query tower ``cfg`` names on ``device``: a ``DeepseekV2Encoder``
    (``from_params``) for a ``DeepseekV2Config``, else an ``AnceEncoder``
    (``from_jax_params``).  ``int8`` quantizes the ANCE tower
    (``quantize_encoder_params``); the DeepSeek-V2 tower has no int8 route."""
    if isinstance(cfg, DeepseekV2Config):
        if int8:
            raise ValueError("the DeepSeek-V2 tower has no int8 route")
        from haconvdr_torch.models.deepseek_v2 import DeepseekV2Encoder

        return DeepseekV2Encoder.from_params(params, cfg, device)
    from haconvdr_torch.models.encoder import AnceEncoder, quantize_encoder_params

    if int8:
        params = quantize_encoder_params(params)
    return AnceEncoder.from_jax_params(params, cfg, device)

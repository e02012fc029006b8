from .bridge import from_jax_params, jax_tree_to_state_dict, load_jax_params
from .clip_text import TextConfig, TextTransformer, encode_text
from .lavila import (
    Lavila,
    LavilaConfig,
    encode_image,
    lavila_forward,
    timesformer_base_config,
    timesformer_large_config,
    timesformer_tiny_config,
)
from .obj_decoder import (
    DecoderConfig,
    DecoderOutput,
    ObjDecoder,
    decoder_forward,
    obj_proj,
    txt_proj,
    vid_proj,
)
from .quant import QuantLinear, cast_floats, quantize_lavila_params
from .spacetime_vit import SpaceTimeConfig, SpaceTimeViT, spacetime_forward

__all__ = [
    "from_jax_params",
    "jax_tree_to_state_dict",
    "load_jax_params",
    "TextConfig",
    "TextTransformer",
    "encode_text",
    "Lavila",
    "LavilaConfig",
    "encode_image",
    "lavila_forward",
    "timesformer_base_config",
    "timesformer_large_config",
    "timesformer_tiny_config",
    "DecoderConfig",
    "DecoderOutput",
    "ObjDecoder",
    "decoder_forward",
    "obj_proj",
    "txt_proj",
    "vid_proj",
    "QuantLinear",
    "cast_floats",
    "quantize_lavila_params",
    "SpaceTimeConfig",
    "SpaceTimeViT",
    "spacetime_forward",
]

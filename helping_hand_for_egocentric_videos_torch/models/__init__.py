from .bridge import from_jax_params, jax_tree_to_state_dict, load_jax_params
from .clip_image import (
    ClipResNetConfig,
    ClipVitConfig,
    clip_image_tower_from_state_dict,
    clip_resnet_encode,
    clip_vit_encode,
    init_clip_resnet_params,
    init_clip_vit_params,
)
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
from .zoo import available_models, clip_preprocess, load_clip

__all__ = [
    "from_jax_params",
    "jax_tree_to_state_dict",
    "load_jax_params",
    "ClipResNetConfig",
    "ClipVitConfig",
    "clip_image_tower_from_state_dict",
    "clip_resnet_encode",
    "clip_vit_encode",
    "init_clip_resnet_params",
    "init_clip_vit_params",
    "available_models",
    "clip_preprocess",
    "load_clip",
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

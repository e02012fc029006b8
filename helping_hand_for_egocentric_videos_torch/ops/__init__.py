from .act_quant import layer_norm_int8, layer_norm_int8_ref, quick_gelu_int8, quick_gelu_int8_ref
from .divided_attention import (
    divided_patch_attention,
    divided_patch_attention_ref,
    merge_cls_partials,
    needs_head_grid,
    time_attention_headgrid_ref,
)
from .preprocess import resize_normalize, shortside_centercrop_normalize, shortside_dims, spatial_crops

__all__ = [
    "layer_norm_int8",
    "layer_norm_int8_ref",
    "quick_gelu_int8",
    "quick_gelu_int8_ref",
    "divided_patch_attention",
    "divided_patch_attention_ref",
    "merge_cls_partials",
    "needs_head_grid",
    "time_attention_headgrid_ref",
    "resize_normalize",
    "shortside_centercrop_normalize",
    "shortside_dims",
    "spatial_crops",
]

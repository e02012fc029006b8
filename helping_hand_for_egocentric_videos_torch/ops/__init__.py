from .divided_attention import (
    divided_patch_attention,
    divided_patch_attention_ref,
    merge_cls_partials,
)
from .preprocess import resize_normalize, shortside_centercrop_normalize, shortside_dims

__all__ = [
    "divided_patch_attention",
    "divided_patch_attention_ref",
    "merge_cls_partials",
    "resize_normalize",
    "shortside_centercrop_normalize",
    "shortside_dims",
]

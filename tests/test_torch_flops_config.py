"""The port's copies of ``core/config.py`` and ``utils/flops.py`` against
the JAX package's originals: the same names and defaults for every config
field the port keeps, the same FLOP counts for the same model shapes."""

import dataclasses

import pytest

from helping_hand_for_egocentric_videos_tpu.core import config as jcfg
from helping_hand_for_egocentric_videos_tpu.models import lavila as jlavila
from helping_hand_for_egocentric_videos_tpu.models.obj_decoder import DecoderConfig as JaxDecoderConfig
from helping_hand_for_egocentric_videos_tpu.utils import flops as jflops
from helping_hand_for_egocentric_videos_torch.core import config as tcfg
from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, lavila
from helping_hand_for_egocentric_videos_torch.utils import flops as tflops

OVERRIDES = {"data.num_frames": 128, "model.backbone": "timesformer_base", "model.num_queries": 6,
             "model.pred_traj": False}


@pytest.mark.parametrize("overrides", [{}, OVERRIDES], ids=["defaults", "overrides"])
def test_experiment_config_equals_jax(overrides):
    """Each field of the port's config is a field of JAX's with the same
    default; set as ``build_eval_model`` sets them, both read the same."""
    got = tcfg.ExperimentConfig()
    want = jcfg.apply_overrides(jcfg.ExperimentConfig(), [f"{k}={v}" for k, v in overrides.items()])
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(got, section), name, val)
    for section, fields in dataclasses.asdict(got).items():
        if not isinstance(fields, dict):  # a top-level field (name, output_dir)
            assert fields == getattr(want, section), section
            continue
        assert fields == {k: v for k, v in dataclasses.asdict(getattr(want, section)).items() if k in fields}


@pytest.mark.parametrize("backbone", ["timesformer_large", "timesformer_base", "timesformer_tiny"])
@pytest.mark.parametrize("frames", [4, 16, 128])
def test_flop_counters_equal_jax(backbone, frames):
    def configs(mod, dec_cls):
        lcfg = getattr(mod, f"{backbone}_config")(num_frames=4)
        dcfg = dec_cls(num_queries=13, feature_dim=lcfg.visual.width, text_width=lcfg.text.width,
                       num_frames=frames, patches_per_frame=lcfg.visual.patches_per_frame)
        return lcfg, dcfg

    (tl, td), (jl, jd) = configs(lavila, DecoderConfig), configs(jlavila, JaxDecoderConfig)
    assert tflops.eval_fwd_flops_per_clip(tl, td, frames=frames) == jflops.eval_fwd_flops_per_clip(
        jl, jd, frames=frames)
    assert tflops.vision_fwd_flops(tl.visual, frames) == jflops.vision_fwd_flops(jl.visual, frames)
    assert tflops.text_fwd_flops(tl.text) == jflops.text_fwd_flops(jl.text)
    assert tflops.decoder_fwd_flops(td) == jflops.decoder_fwd_flops(jd)
    assert tflops.train_step_flops_per_clip(tl, td) == jflops.train_step_flops_per_clip(jl, jd)


@pytest.mark.parametrize("overrides", [{}, {"data.input_res": 160, "parallel.backbone_dtype": "float32",
                                            "optim.lr": 1e-4, "model.num_queries": 6}],
                         ids=["defaults", "overrides"])
def test_build_train_config_equals_jax(overrides):
    """``build_train_config`` reads the same fields as JAX's into the same
    TrainConfig (the backbone type as a torch dtype)."""
    import jax.numpy as jnp
    import torch

    from helping_hand_for_egocentric_videos_tpu.train.pretrain import build_train_config as jbuild
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_train_config as tbuild

    got_cfg = tcfg.ExperimentConfig()
    for key, val in overrides.items():
        section, name = key.split(".")
        setattr(getattr(got_cfg, section), name, val)
    want = dataclasses.asdict(jbuild(jcfg.apply_overrides(jcfg.ExperimentConfig(),
                                                          [f"{k}={v}" for k, v in overrides.items()])))
    got = dataclasses.asdict(tbuild(got_cfg))
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    assert got.pop("backbone_dtype") == dtypes[want.pop("backbone_dtype")]
    assert got == want

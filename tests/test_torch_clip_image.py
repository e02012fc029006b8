"""The port's CLIP image towers and model zoo against the JAX package, in f32.

- ``clip_vit_encode`` (projected, raw and the patch map) and
  ``clip_resnet_encode`` on towers from JAX's initialisers, carried into
  the port's modules by ``models/bridge.py`` (BatchNorm statistics drawn
  away from 0 / 1 so the inference-mode fold shows), within 1e-4;
- ``convert_openai_vit_tower`` / ``convert_openai_resnet_tower`` on
  synthetic OpenAI-layout state dicts (``openai_clip_sd``, numpy, seeded):
  the port's modules hold exactly the JAX converters' (bridged) weights,
  and encode within 1e-4; ``clip_image_tower_from_state_dict`` sniffs the
  same kind and config;
- ``clip_preprocess`` (antialiased bicubic) within 1e-4 of JAX's;
- ``resolve`` through the JAX test's cases, and ``load_clip`` on small
  synthetic checkpoint files of both kinds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.models import clip_image as jci
from helping_hand_for_egocentric_videos_tpu.models import clip_text as jct
from helping_hand_for_egocentric_videos_tpu.models import zoo as jzoo
from helping_hand_for_egocentric_videos_torch.models import clip_image as tci
from helping_hand_for_egocentric_videos_torch.models import clip_text as tct
from helping_hand_for_egocentric_videos_torch.models import zoo as tzoo
from helping_hand_for_egocentric_videos_torch.models.bridge import clip_vit_from_jax, load_jax_params

ATOL = 1e-4
VIT = dict(input_resolution=56, patch_size=14, width=128, layers=2, heads=2, output_dim=32)
RN = dict(layers=(1, 2, 1, 1), output_dim=32, heads=4, input_resolution=64, width=8)


def _cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _images(rng, b, res):
    return rng.normal(size=(b, res, res, 3)).astype(np.float32)


def _bn_stats(tree, rng):
    """Draw every BatchNorm's affine and running statistics away from the
    identity (in place, on a numpy tree)."""
    if isinstance(tree, dict):
        if "mean" in tree:
            c = len(tree["mean"])
            tree.update(g=1 + 0.1 * rng.normal(size=c), b=0.1 * rng.normal(size=c),
                        mean=0.1 * rng.normal(size=c), var=rng.uniform(0.5, 1.5, size=c))
            for k in ("g", "b", "mean", "var"):
                tree[k] = tree[k].astype(np.float32)
            return
        for v in tree.values():
            _bn_stats(v, rng)
    elif isinstance(tree, list):
        for v in tree:
            _bn_stats(v, rng)


def clip_resnet_from_jax(tree, cfg):
    return load_jax_params(tci.ClipResNet(cfg), tree)


def _np_tree(tree):
    return jax.tree.map(lambda a: a if isinstance(a, int) else np.asarray(a), tree)


# ------------------------------------------------- synthetic OpenAI state dicts


def openai_clip_sd(rng, kind="vit", *, vit=VIT, rn=RN, text_width=64, text_layers=2, vocab=64, context=16,
                   embed_dim=32):
    """A full OpenAI CLIP state dict (the reference's ``CLIP`` key layout,
    openai_model.py:275-418) of seeded random numpy values: a ViT or a
    ModifiedResNet visual tower and the text tower."""
    sd = {}

    def r(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def ln(name, d):
        sd[f"{name}.weight"] = 1 + r(d, scale=0.1)
        sd[f"{name}.bias"] = r(d, scale=0.1)

    def resblock(name, d):
        ln(f"{name}.ln_1", d)
        ln(f"{name}.ln_2", d)
        sd[f"{name}.attn.in_proj_weight"] = r(3 * d, d, scale=d**-0.5)
        sd[f"{name}.attn.in_proj_bias"] = r(3 * d)
        sd[f"{name}.attn.out_proj.weight"] = r(d, d, scale=d**-0.5)
        sd[f"{name}.attn.out_proj.bias"] = r(d)
        sd[f"{name}.mlp.c_fc.weight"] = r(4 * d, d, scale=d**-0.5)
        sd[f"{name}.mlp.c_fc.bias"] = r(4 * d)
        sd[f"{name}.mlp.c_proj.weight"] = r(d, 4 * d, scale=(4 * d) ** -0.5)
        sd[f"{name}.mlp.c_proj.bias"] = r(d)

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = r(cout, cin, k, k, scale=(2.0 / (cin * k * k)) ** 0.5)

    def bn(name, c):
        ln(name, c)
        sd[f"{name}.running_mean"] = r(c, scale=0.1)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)

    if kind == "vit":
        w, p, grid = vit["width"], vit["patch_size"], vit["input_resolution"] // vit["patch_size"]
        sd["visual.conv1.weight"] = r(w, 3, p, p, scale=(3 * p * p) ** -0.5)
        sd["visual.class_embedding"] = r(w, scale=w**-0.5)
        sd["visual.positional_embedding"] = r(grid**2 + 1, w, scale=w**-0.5)
        ln("visual.ln_pre", w)
        for i in range(vit["layers"]):
            resblock(f"visual.transformer.resblocks.{i}", w)
        ln("visual.ln_post", w)
        sd["visual.proj"] = r(w, vit["output_dim"], scale=w**-0.5)
    else:
        w = rn["width"]
        conv("visual.conv1", w // 2, 3, 3)
        bn("visual.bn1", w // 2)
        conv("visual.conv2", w // 2, w // 2, 3)
        bn("visual.bn2", w // 2)
        conv("visual.conv3", w, w // 2, 3)
        bn("visual.bn3", w)
        cin = w
        for li, (blocks, planes) in enumerate(zip(rn["layers"], (w, 2 * w, 4 * w, 8 * w)), start=1):
            for bi in range(blocks):
                name = f"visual.layer{li}.{bi}"
                conv(f"{name}.conv1", planes, cin, 1)
                bn(f"{name}.bn1", planes)
                conv(f"{name}.conv2", planes, planes, 3)
                bn(f"{name}.bn2", planes)
                conv(f"{name}.conv3", 4 * planes, planes, 1)
                bn(f"{name}.bn3", 4 * planes)
                if bi == 0:  # stride 2 past layer1, or a width change
                    conv(f"{name}.downsample.0", 4 * planes, cin, 1)
                    bn(f"{name}.downsample.1", 4 * planes)
                cin = 4 * planes
        e = 32 * w
        sd["visual.attnpool.positional_embedding"] = r((rn["input_resolution"] // 32) ** 2 + 1, e, scale=e**-0.5)
        for name in ("q", "k", "v"):
            sd[f"visual.attnpool.{name}_proj.weight"] = r(e, e, scale=e**-0.5)
            sd[f"visual.attnpool.{name}_proj.bias"] = r(e)
        sd["visual.attnpool.c_proj.weight"] = r(rn["output_dim"], e, scale=e**-0.5)
        sd["visual.attnpool.c_proj.bias"] = r(rn["output_dim"])
    sd["token_embedding.weight"] = r(vocab, text_width, scale=0.02)
    sd["positional_embedding"] = r(context, text_width, scale=0.01)
    for i in range(text_layers):
        resblock(f"transformer.resblocks.{i}", text_width)
    ln("ln_final", text_width)
    sd["text_projection"] = r(text_width, embed_dim, scale=text_width**-0.5)
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return sd


# ------------------------------------------------------------ the towers


@pytest.mark.parametrize("mode", ["projected", "raw", "patch_map"])
def test_vit_tower_from_jax_init_matches_jax(rng, mode):
    jcfg = jci.ClipVitConfig(**VIT)
    params = _np_tree(jci.init_clip_vit_params(jax.random.PRNGKey(1), jcfg))
    cfg = _cfg(tci.ClipVitConfig, jcfg)
    tower = clip_vit_from_jax(params, cfg)
    imgs = _images(rng, 2, VIT["input_resolution"])
    kw = {"projected": {}, "raw": {"apply_project": False}, "patch_map": {"cls_at_last": False}}[mode]
    want = np.asarray(jci.clip_vit_encode(params, jcfg, jnp.asarray(imgs), **kw))
    with torch.inference_mode():
        got = tci.clip_vit_encode(tower, cfg, torch.from_numpy(imgs), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resnet_tower_from_jax_init_matches_jax(rng):
    """The anti-aliased strided bottlenecks, the downsample branches and
    the attention pool, with BatchNorm statistics away from the identity."""
    jcfg = jci.ClipResNetConfig(**RN)
    params = _np_tree(jci.init_clip_resnet_params(jax.random.PRNGKey(2), jcfg))
    _bn_stats(params, rng)
    cfg = _cfg(tci.ClipResNetConfig, jcfg)
    tower = clip_resnet_from_jax(params, cfg)
    imgs = _images(rng, 2, RN["input_resolution"])
    want = np.asarray(jci.clip_resnet_encode(params, jcfg, jnp.asarray(imgs)))
    with torch.inference_mode():
        got = tci.clip_resnet_encode(tower, cfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, RN["output_dim"]) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_port_inits_have_the_jax_layout():
    """The port's initialisers build the trees the bridge loads (every
    key and shape), so either package's tower fills the other's."""
    jv = _np_tree(jci.init_clip_vit_params(jax.random.PRNGKey(0), jci.ClipVitConfig(**VIT)))
    tv = tci.init_clip_vit_params(tci.ClipVitConfig(**VIT), generator=torch.Generator().manual_seed(0))
    want = clip_vit_from_jax(jv, tci.ClipVitConfig(**VIT)).state_dict()
    assert {k: v.shape for k, v in tv.state_dict().items()} == {k: v.shape for k, v in want.items()}
    jr = _np_tree(jci.init_clip_resnet_params(jax.random.PRNGKey(0), jci.ClipResNetConfig(**RN)))
    tr = tci.init_clip_resnet_params(tci.ClipResNetConfig(**RN), generator=torch.Generator().manual_seed(0))
    want = clip_resnet_from_jax(jr, tci.ClipResNetConfig(**RN)).state_dict()
    assert {k: v.shape for k, v in tr.state_dict().items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_converters_equal_jax_and_encode_alike(rng, kind):
    sd = openai_clip_sd(np.random.default_rng(11), "vit" if kind == "vit" else "rn")
    jconv = {"vit": jci.convert_openai_vit_tower, "resnet": jci.convert_openai_resnet_tower}[kind]
    tconv = {"vit": tci.convert_openai_vit_tower, "resnet": tci.convert_openai_resnet_tower}[kind]
    jcfg, jparams = jconv(sd)
    jparams = _np_tree(jparams)
    cfg, tower = tconv({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    bridged = (clip_vit_from_jax if kind == "vit" else clip_resnet_from_jax)(jparams, cfg)
    _same(tower.state_dict(), bridged.state_dict())
    assert not any(p.is_meta for p in tower.parameters())

    imgs = _images(rng, 2, cfg.input_resolution)
    jenc = {"vit": jci.clip_vit_encode, "resnet": jci.clip_resnet_encode}[kind]
    tenc = {"vit": tci.clip_vit_encode, "resnet": tci.clip_resnet_encode}[kind]
    want = np.asarray(jenc(jparams, jcfg, jnp.asarray(imgs)))
    with torch.inference_mode():
        got = tenc(tower, cfg, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_tower_sniffing_matches_jax(kind):
    sd = openai_clip_sd(np.random.default_rng(12), kind)
    jkind, jcfg, _, jenc = jci.clip_image_tower_from_state_dict(sd)
    tkind, tcfg, tower, tenc = tci.clip_image_tower_from_state_dict(sd)
    assert tkind == jkind == {"vit": "vit", "rn": "resnet"}[kind]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tenc.__name__ == jenc.__name__
    assert isinstance(tower, {"vit": tci.ClipVisionTransformer, "rn": tci.ClipResNet}[kind])
    assert tci.count_resblocks(sd) == jci.count_resblocks(sd) == 2
    if kind == "vit":
        assert tci.count_resblocks(sd, "visual.transformer.resblocks") == VIT["layers"]


# ------------------------------------------------------------------ the zoo


@pytest.mark.parametrize("shape, n_px", [((2, 48, 80), 16), ((1, 32, 48), 224), ((1, 256, 342), 224),
                                         ((2, 300, 400), 224)])
def test_clip_preprocess_matches_jax(shape, n_px):
    imgs = np.random.default_rng(sum(shape)).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    want = np.asarray(jzoo.clip_preprocess(jnp.asarray(imgs), n_px=n_px))
    got = tzoo.clip_preprocess(torch.from_numpy(imgs), n_px=n_px)
    assert got.dtype == torch.float32 and got.shape == want.shape == (shape[0], n_px, n_px, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_array_equal(tzoo.clip_preprocess(imgs, n_px=n_px).numpy(), got.numpy())


def test_zoo_resolve_cases_match_jax(tmp_path, monkeypatch):
    """tests/test_weights.py::test_zoo_resolve_sha_verification's cases,
    through both packages: explicit paths pass through; a named model is
    found in a cache directory and SHA256-checked; a missing file names
    the published URL."""
    monkeypatch.delenv("HH_CLIP_CACHE", raising=False)
    assert tzoo.available_models() == jzoo.available_models() and "ViT-L/14" in tzoo.available_models()
    assert tzoo.CLIP_MEAN == jzoo.CLIP_MEAN and tzoo.CLIP_STD == jzoo.CLIP_STD
    f = tmp_path / "anything.pt"
    f.write_bytes(b"x")
    cache = tmp_path / "cache"
    cache.mkdir()
    (cache / "ViT-B-32.pt").write_bytes(b"not the real weights")
    for zoo in (jzoo, tzoo):
        assert zoo.resolve(str(f)) == str(f)
        with pytest.raises(RuntimeError, match="SHA256"):
            zoo.resolve("ViT-B/32", cache_dir=str(cache))
        assert zoo.resolve("ViT-B/32", cache_dir=str(cache), verify=False).endswith("ViT-B-32.pt")
        with pytest.raises(FileNotFoundError, match="openaipublic"):
            zoo.resolve("RN50", cache_dir=str(tmp_path / "empty"))
        with pytest.raises(FileNotFoundError, match="neither"):
            zoo.resolve("NoSuchModel", cache_dir=str(cache))
    # a file whose SHA256 is the published one is accepted by name
    good = tmp_path / "good"
    good.mkdir()
    (good / "RN50.pt").write_bytes(b"weights")
    digest = tzoo._sha256(str(good / "RN50.pt"))
    monkeypatch.setitem(tzoo._MODELS, "RN50", f"https://host/{digest}/RN50.pt")
    monkeypatch.setitem(jzoo._MODELS, "RN50", f"https://host/{digest}/RN50.pt")
    monkeypatch.setenv("HH_CLIP_CACHE", str(good))
    assert tzoo.resolve("RN50") == jzoo.resolve("RN50") == str(good / "RN50.pt")


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_load_clip_matches_jax(rng, tmp_path, kind):
    sd = openai_clip_sd(np.random.default_rng(13), kind)
    path = tmp_path / f"tiny_{kind}.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    jz, tz = jzoo.load_clip(str(path)), tzoo.load_clip(str(path))
    assert tz.keys() == jz.keys()
    assert tz["kind"] == jz["kind"]
    assert dataclasses.asdict(tz["visual_cfg"]) == dataclasses.asdict(jz["visual_cfg"])
    assert dataclasses.asdict(tz["text_cfg"]) == dataclasses.asdict(jz["text_cfg"])
    np.testing.assert_allclose(float(tz["logit_scale"]), float(jz["logit_scale"]), rtol=1e-7)

    res = tz["visual_cfg"].input_resolution
    imgs = _images(rng, 2, res)
    want = np.asarray(jz["encode_image"](_np_tree(jz["visual_params"]), jz["visual_cfg"], jnp.asarray(imgs)))
    with torch.inference_mode():
        got = tz["encode_image"](tz["visual_params"], tz["visual_cfg"], torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

    tok = np.zeros((2, 16), np.int32)
    tok[:, 0] = 1
    tok[0, 1:4] = [5, 9, 63]
    tok[1, 1:3] = [8, 63]
    want_t, _ = jct.encode_text(_np_tree(jz["text_params"]), jz["text_cfg"], jnp.asarray(tok))
    with torch.inference_mode():
        got_t, _ = tct.encode_text(tz["text_params"], tz["text_cfg"], torch.from_numpy(tok).long())
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL)

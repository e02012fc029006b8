"""The port's pretraining step against the JAX package's, in f32 on the CPU.

The inputs are ``tests/test_train_step.py::tiny_setup`` (a 2-block
backbone, a 2-layer decoder), with some captions padded; the JAX
parameters come over through ``models/bridge.py``. With dropout off:

- one step's total loss and every metric within atol 1e-5 (``grad_norm``,
  about 367, within rtol 1e-6), and every decoder gradient within atol
  1e-5 x max(1, the leaf's largest |gradient|): the tiny model's gradients
  reach 41, where one f32 step is 4e-6;
- the parameters after 3 steps under each schedule, and after a clipped
  step: atol 1e-6 where the JAX gradient is resolved (its magnitude
  exceeds 1e-6 and 1e4 times its difference from the port's, at every
  step), and 2 * lr * steps elsewhere: Adam scales a gradient that is
  rounding noise to +-lr a step, and at these magnitudes the rounding
  noise of a sum of large terms reaches 1e-4;
- the uint8 video path's metrics within atol 1e-5.

And the optimizer's groups by name, the frozen ``class_embed`` /
``vid_proj``, the schedule's LR at every step against optax's, the
``ValueError``s, the loss falling over 8 steps, dropout, the backbone
left without gradients, and ``augment=True`` refused. A ``cuda`` case
runs one step of a kernel-friendly tiny config through both attention
routes on the card; JAX comes in only through a fixture, so this file
runs there with ``python -m pytest --noconftest -m cuda
tests/test_torch_train_step.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    Lavila,
    LavilaConfig,
    ObjDecoder,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.models.bridge import from_jax_params, jax_tree_to_state_dict
from helping_hand_for_egocentric_videos_torch.train import (
    TrainConfig,
    TrainState,
    make_optimizer,
    make_train_step,
)
from helping_hand_for_egocentric_videos_torch.train.step import learning_rate

ATOL = 1e-5
PAD_ROWS = (3, 7, 8)  # captions that are empty strings: [SOT, EOT, 0, ...]


def _fields(cls, obj, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**{k: v for k, v in dataclasses.asdict(obj).items() if k in names}, **over})


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import optax
    from test_train_step import tiny_setup

    from helping_hand_for_egocentric_videos_tpu.train import step as jstep

    return types.SimpleNamespace(jax=jax, jnp=jnp, optax=optax, tiny_setup=tiny_setup, step=jstep)


@pytest.fixture(scope="module")
def setup(jx):
    """Both packages' configs, parameters and the batch (numpy)."""
    jl, jd, jt, backbone, decoder, batch, noun_dict = jx.tiny_setup()
    batch = {k: np.array(v) for k, v in batch.items()}
    batch["tokens"][list(PAD_ROWS), 1:] = 0
    batch["tokens"][list(PAD_ROWS), 1] = 63
    # the port's own attention route: the kernel wrapper, its plain version on the CPU
    lcfg = LavilaConfig(visual=_fields(SpaceTimeConfig, jl.visual, attention_backend="kernel"),
                        text=_fields(TextConfig, jl.text),
                        embed_dim=jl.embed_dim)
    dcfg = DecoderConfig(**dataclasses.asdict(jd))
    tcfg = _fields(TrainConfig, jt, backbone_dtype=torch.float32)
    return types.SimpleNamespace(jl=jl, jd=jd, jt=jt, jbackbone=backbone, jdecoder=decoder, batch=batch,
                                 noun_dict=np.array(noun_dict), lcfg=lcfg, dcfg=dcfg, tcfg=tcfg)


def _port(s, **over):
    """A fresh port (backbone, state, step) on the CPU from the JAX weights."""
    tcfg = dataclasses.replace(s.tcfg, **over)
    backbone, decoder = from_jax_params(s.jbackbone, s.jdecoder, s.lcfg, s.dcfg)
    return backbone, TrainState.create(decoder, tcfg, device="cpu"), make_train_step(s.dcfg, s.lcfg, tcfg)


def _jax_run(jx, s, steps, batch=None, **over):
    """``steps`` JAX steps -> (metrics of each step, final params tree)."""
    jnp = jx.jnp
    tcfg = dataclasses.replace(s.jt, **over)
    opt = jx.step.make_optimizer(tcfg)
    state = jx.step.TrainState(s.jdecoder, opt.init(s.jdecoder), jnp.zeros((), jnp.int32))
    step = jx.jax.jit(jx.step.make_train_step(s.jd, s.jl, tcfg, opt, debug_grads=True))
    batch = {k: jnp.asarray(v) for k, v in (batch or s.batch).items()}
    out = []
    for _ in range(steps):
        state, m = step(state, s.jbackbone, batch, jnp.asarray(s.noun_dict), None)
        out.append(m)
    return out, state.params


def _port_run(s, steps, batch=None, **over):
    backbone, state, step = _port(s, **over)
    out = []
    for _ in range(steps):
        state, m = step(state, backbone, batch or s.batch, s.noun_dict)
        out.append({**m, "grads": {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                                   for n, p in state.decoder.named_parameters()}})
    return out, state, backbone


def _jax_grads(m):
    return jax_tree_to_state_dict(m["grads"])


METRICS = ("total_loss", "nce_loss", "box_loss", "word_loss", "top1_video_to_text", "top1_text_to_video")


def _assert_metrics_close(tm, jm):
    """Every metric within atol 1e-5; ``grad_norm`` (about 367 here, where
    one f32 step is 3e-5) within rtol 1e-6."""
    for k in METRICS:
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=ATOL), k
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)


def test_one_step_loss_metrics_and_gradients_match_jax(jx, setup):
    (jm,), _ = _jax_run(jx, setup, 1)
    (tm,), _, _ = _port_run(setup, 1)
    _assert_metrics_close(tm, jm)
    want = _jax_grads(jm)
    assert set(tm["grads"]) == set(want)
    for name, g in tm["grads"].items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * max(1.0, float(np.abs(w).max())), err_msg=name)


def _assert_params_close(decoder, jparams, jms, tms, lr, steps):
    """The parameters after ``steps`` updates, by the rule of the module
    docstring; at least half of them must fall under the tight bound."""
    want = jax_tree_to_state_dict(jparams)
    jgrads = [_jax_grads(m) for m in jms]
    n_tight = n_all = 0
    for name, p in decoder.named_parameters():
        gj = np.stack([g[name].numpy() for g in jgrads])
        gt = np.stack([m["grads"][name].numpy() for m in tms])
        resolved = ((np.abs(gj) > 1e-6) & (np.abs(gj) > 1e4 * np.abs(gj - gt))).all(axis=0)
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert (err <= np.where(resolved, 1e-6, 2 * lr * steps)).all(), (name, float(err.max()))
        n_tight += int(resolved.sum())
        n_all += err.size
    assert n_tight >= n_all / 2, (n_tight, n_all)


@pytest.mark.parametrize("schedule", [
    {"schedule": "constant"},
    {"schedule": "warmup_cosine", "warmup_steps": 2, "total_steps": 4},
], ids=["constant", "warmup_cosine"])
def test_params_after_three_steps_match_jax(jx, setup, schedule):
    jms, jparams = _jax_run(jx, setup, 3, **schedule)
    tms, state, _ = _port_run(setup, 3, **schedule)
    for jm, tm in zip(jms, tms):
        assert float(tm["total_loss"]) == pytest.approx(float(jm["total_loss"]), abs=ATOL)
    _assert_params_close(state.decoder, jparams, jms, tms, setup.tcfg.lr, 3)
    assert state.step == 3


def test_clip_grad_update_matches_jax(jx, setup):
    """A clip well under the gradient's norm, so the clip acts."""
    (jm,), jparams = _jax_run(jx, setup, 1, clip_grad=0.05)
    (tm,), state, _ = _port_run(setup, 1, clip_grad=0.05)
    assert float(jm["grad_norm"]) > 0.05
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    (raw,), _, _ = _port_run(setup, 1)  # .grad holds the clipped gradient; the rule reads the raw one
    _assert_params_close(state.decoder, jparams, [jm], [raw], setup.tcfg.lr, 1)
    norm = torch.sqrt(sum((p.grad ** 2).sum() for g in state.optimizer.param_groups for p in g["params"]))
    assert float(norm) == pytest.approx(0.05, rel=1e-5)


def test_uint8_video_path_matches_jax(jx, setup):
    """uint8 clips of 36x36 resized on the device to input_res = 28."""
    rng = np.random.default_rng(3)
    batch = dict(setup.batch, video=rng.integers(0, 256, size=(4, 2, 36, 36, 3), dtype=np.uint8))
    (jm,), _ = _jax_run(jx, setup, 1, batch=batch, input_res=28)
    (tm,), _, _ = _port_run(setup, 1, batch=batch, input_res=28)
    _assert_metrics_close(tm, jm)


def test_optimizer_groups_by_name(setup):
    decoder = ObjDecoder(setup.dcfg, generator=torch.Generator().manual_seed(0))
    opt, _ = make_optimizer(setup.tcfg, decoder)
    groups = {g["group"]: (g["names"], g["weight_decay"]) for g in opt.param_groups}
    decay, no_decay = set(groups["decay"][0]), set(groups["no_decay"][0])
    assert groups["decay"][1] == setup.tcfg.wd and groups["no_decay"][1] == 0.0
    for attn in ("self_attn", "cross_attn"):
        for w in ("wq", "wk", "wv"):
            assert f"layers.0.{attn}.{w}.bias" in decay and f"layers.1.{attn}.{w}.weight" in decay
        assert f"layers.0.{attn}.wo.bias" in no_decay and f"layers.0.{attn}.wo.weight" in decay
    for name in ("layers.0.linear1.bias", "layers.1.norm2.bias", "pre_norm.bias", "bbox_mlp.2.bias",
                 "txt_proj.bias", "obj_proj.0.bias", "frame_proj.bias"):
        assert name in no_decay, name
    for name in ("query_embed", "pos_embed", "proj.weight", "pre_norm.weight", "frame_index"):
        assert name in decay, name
    names = {n for n, _ in decoder.named_parameters()}
    frozen = {n for n in names if n.split(".")[0] in ("class_embed", "vid_proj")}
    assert frozen == {"class_embed.weight", "class_embed.bias", "vid_proj.weight", "vid_proj.bias"}
    assert decay | no_decay == names - frozen and not decay & no_decay


def test_frozen_heads_and_backbone_untouched(setup):
    backbone, state, step = _port(setup)
    before = {k: v.clone() for k, v in state.decoder.state_dict().items() if k.split(".")[0] in
              ("class_embed", "vid_proj")}
    bb_before = {k: v.clone() for k, v in backbone.state_dict().items()}
    for _ in range(2):
        state, _ = step(state, backbone, setup.batch, setup.noun_dict)
    after = state.decoder.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert all(torch.equal(v, backbone.state_dict()[k]) for k, v in bb_before.items())
    assert all(p.grad is None for p in backbone.parameters())


def test_warmup_cosine_lr_matches_optax_every_step(jx):
    cfg = TrainConfig(lr=1e-3, schedule="warmup_cosine", warmup_steps=3, total_steps=10)
    want = jx.optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 10)
    for count in range(cfg.total_steps + 3):
        assert learning_rate(cfg, count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), count
    zero_warm = TrainConfig(lr=1e-3, schedule="warmup_cosine", warmup_steps=0, total_steps=5)
    want = jx.optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 5)
    assert [learning_rate(zero_warm, c) for c in range(7)] == pytest.approx([float(want(c)) for c in range(7)],
                                                                            rel=1e-6, abs=1e-12)


def test_schedule_sets_each_update_lr(setup):
    """The step gives update k the schedule's LR at count k."""
    backbone, state, step = _port(setup, schedule="warmup_cosine", warmup_steps=2, total_steps=5)
    for k in range(3):
        state, _ = step(state, backbone, setup.batch, setup.noun_dict)
        assert all(g["lr"] == learning_rate(dataclasses.replace(setup.tcfg, schedule="warmup_cosine",
                                                                warmup_steps=2, total_steps=5), k)
                   for g in state.optimizer.param_groups)


def test_misconfigured_schedules_raise():
    decoder = ObjDecoder(DecoderConfig(d_model=16, nhead=2, num_layers=1, dim_feedforward=16, num_classes=2,
                                       feature_dim=16, text_width=16, embed_dim=8, patches_per_frame=4))
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(TrainConfig(schedule="warmup_cosine"), decoder)
    with pytest.raises(ValueError, match="unknown schedule"):
        make_optimizer(TrainConfig(schedule="nope"), decoder)


def test_loss_falls_over_eight_steps(setup):
    backbone, state, step = _port(setup)
    losses = []
    for _ in range(8):
        state, m = step(state, backbone, setup.batch, setup.noun_dict)
        losses.append(float(m["total_loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert state.step == 8


def test_dropout_draws_from_the_generator(setup):
    losses = []
    for seed in (1, 2, 1):
        backbone, state, step = _port(setup)
        _, m = step(state, backbone, setup.batch, setup.noun_dict, torch.Generator().manual_seed(seed))
        losses.append(float(m["total_loss"]))
    assert losses[0] != losses[1] and losses[0] == losses[2]
    backbone, state, step = _port(setup)
    _, m = step(state, backbone, setup.batch, setup.noun_dict)
    assert float(m["total_loss"]) not in losses  # no generator: no dropout


def test_augment_is_not_ported_yet(setup):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(setup.dcfg, setup.lcfg, dataclasses.replace(setup.tcfg, augment=True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(python -m pytest --noconftest -m cuda tests/test_torch_train_step.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_step_kernel_route_matches_plain_route(cuda_device):
    """A kernel-friendly tiny config (N = 64 patches, dh = 64): one f32 step
    through K1/K2 and one through the plain attention, from the same
    weights and batch: loss within rtol 1e-4, every decoder gradient above
    rounding noise (norm > 1e-6 x the gradient norm) within cosine 0.999,
    and each kernel launched once a block."""
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    t, depth = 4, 2
    lcfg = LavilaConfig(visual=SpaceTimeConfig(img_size=112, patch_size=14, width=128, depth=depth, heads=2,
                                               num_frames=t),
                        text=TextConfig(vocab_size=64, context_length=12, width=32, heads=4, layers=2,
                                        embed_dim=16), embed_dim=16)
    dcfg = DecoderConfig(d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_classes=8, feature_dim=128,
                         text_width=32, embed_dim=16, num_frames=t, patches_per_frame=64)
    tcfg = TrainConfig(backbone_dtype=torch.float32, lr=1e-3, input_res=112)
    gen = torch.Generator().manual_seed(0)
    backbone, decoder = Lavila(lcfg, generator=gen), ObjDecoder(dcfg, generator=gen)
    with torch.no_grad():
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(0)
    tokens = np.zeros((20, 12), np.int64)
    tokens[:, 0], tokens[:, 1:4], tokens[:, 4] = 62, rng.integers(1, 60, size=(20, 3)), 63
    boxes = (rng.random((4, t, 4, 4)) * 80).astype(np.float32)
    boxes[..., 2:] += 30
    batch = {"video": rng.integers(0, 256, size=(4, t, 112, 112, 3), dtype=np.uint8), "tokens": tokens,
             "noun_vec": (rng.random((4, 20)) < 0.3).astype(np.float32),
             "verb_vec": (rng.random((4, 10)) < 0.3).astype(np.float32), "boxes": boxes,
             "nouns": rng.integers(0, 30, size=(4, 4))}
    batch = {k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()}
    noun_dict = torch.as_tensor(rng.normal(size=(30, 32)).astype(np.float32), device=cuda_device)

    runs = {}
    for backend in ("kernel", "reference"):
        cfg = dataclasses.replace(lcfg, visual=dataclasses.replace(lcfg.visual, attention_backend=backend))
        state = TrainState.create(ObjDecoder(dcfg), tcfg, device=cuda_device)
        state.decoder.load_state_dict(decoder.state_dict())
        da.divided_patch_attention.launches_space = da.divided_patch_attention.launches_time = 0
        _, m = make_train_step(dcfg, cfg, tcfg)(state, backbone.to(cuda_device), batch, noun_dict)
        torch.cuda.synchronize()
        runs[backend] = (m, {n: p.grad for n, p in state.decoder.named_parameters() if p.grad is not None},
                         (da.divided_patch_attention.launches_space, da.divided_patch_attention.launches_time))
    (mk, gk, nk), (mr, gr, nr) = runs["kernel"], runs["reference"]
    assert nk == (depth, depth) and nr == (0, 0)
    assert float(mk["total_loss"]) == pytest.approx(float(mr["total_loss"]), rel=1e-4)
    assert set(gk) == set(gr)
    floor = 1e-6 * float(mr["grad_norm"])  # the key biases' gradients: 0 but for rounding
    for name, g in gk.items():
        if float(gr[name].norm()) > floor:
            assert float(torch.nn.functional.cosine_similarity(g.flatten(), gr[name].flatten(), dim=0)) >= 0.999, name

"""Data parallel over ``torch.distributed``: two ranks equal one process.

The JAX package's contract (``tests/test_sharding_equivalence.py``): a
step over W devices on a global batch equals the one-device step on that
batch. Here two ``gloo`` processes on the CPU, started from ``torchrun``'s
variables through ``parallel.init_from_env``, each run the port's step on
their half of ``tests/test_train_step.py::tiny_setup(n_videos=8)``
(bridged weights, some captions padded), with the train-time augmentation
off and on (uint8 clips of 40x56 cropped to 28, the boxes scaled into the
28 x 28 frame; the draws made for the global batch from one seeded
generator on every rank). Against the
one-process port step on the whole batch:

- each loss term and metric within 1e-5 x max(1, |x|);
- every decoder gradient within 1e-5 x max(1, grad_norm);
- every parameter after the update within 2.1 x lr (Adam's first update
  is +-lr a weight, so a gradient that is rounding noise may flip its
  sign; the gradients above are the tight check).

The one-process port step is itself held against the JAX step by
``tests/test_torch_train_step.py``; here the augmentation-off case is
also checked against JAX's step directly (its loss terms within 1e-5).
Also: a batch that does not split over the ranks raises, and a ``cuda``
case runs the step through ``nccl`` as one rank on the card.
"""

import dataclasses
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    Lavila,
    LavilaConfig,
    ObjDecoder,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.parallel import DataParallel, init_from_env
from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, make_train_step

WORLD = 2
CASES = ("augment_off", "augment_on")
METRICS = ("total_loss", "nce_loss", "box_loss", "word_loss", "top1_video_to_text", "top1_text_to_video",
           "grad_norm")
PAD_ROWS = (3, 7, 8, 33)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fields(cls, obj, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**{k: v for k, v in dataclasses.asdict(obj).items() if k in names}, **over})


def _tcfg(base: TrainConfig, case: str) -> TrainConfig:
    if case == "augment_on":
        return dataclasses.replace(base, augment=True, input_res=28, color_jitter=(0.2, 0.2, 0.1))
    return base


def _run(payload, case: str, dist=None):
    """One step of the port on ``payload``'s weights and batch (this rank's
    rows with ``dist``) -> (metrics, gradients, parameters) as numpy."""
    tcfg = _tcfg(payload["tcfg"], case)
    backbone = Lavila(payload["lcfg"])
    backbone.load_state_dict(payload["backbone"])
    decoder = ObjDecoder(payload["dcfg"])
    decoder.load_state_dict(payload["decoder"])
    batch = dict(payload["batch"])
    if case == "augment_on":  # uint8 clips, boxes in the 28 x 28 frame the augmentation crops
        batch.update(video=payload["video_u8"], boxes=batch["boxes"] * 0.2)
    if dist is not None:
        batch = {k: v[dist.rows(v.shape[0])] for k, v in batch.items()}
    state = TrainState.create(decoder, tcfg, device="cpu")
    step = make_train_step(payload["dcfg"], payload["lcfg"], tcfg, dist=dist)
    state, m = step(state, backbone, batch, payload["noun_dict"], aug_generator=torch.Generator().manual_seed(11))
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.clone() for n, p in state.decoder.named_parameters() if p.grad is not None},
            {n: p.detach().clone() for n, p in state.decoder.named_parameters()})


def _rank_main(rank: int, port: int, path: str):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    dp = init_from_env("cpu")
    assert (dp.rank, dp.world, dp.device.type) == (rank, WORLD, "cpu")
    payload = torch.load(path, weights_only=False)
    out = {case: _run(payload, case, dp) for case in CASES}
    torch.save(out, f"{path}.rank{rank}")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_train_step import tiny_setup

    from helping_hand_for_egocentric_videos_tpu.train import step as jstep

    return types.SimpleNamespace(jax=jax, jnp=jnp, tiny_setup=tiny_setup, step=jstep)


@pytest.fixture(scope="module")
def runs(jx, tmp_path_factory):
    """The bridged tiny setup, its one-process runs, and both ranks' runs."""
    from helping_hand_for_egocentric_videos_torch.models.bridge import from_jax_params

    jl, jd, jt, jbackbone, jdecoder, jbatch, jnoun = jx.tiny_setup(n_videos=8)
    batch = {k: np.array(v) for k, v in jbatch.items()}
    batch["tokens"][list(PAD_ROWS), 1:] = 0
    batch["tokens"][list(PAD_ROWS), 1] = 63
    lcfg = LavilaConfig(visual=_fields(SpaceTimeConfig, jl.visual, attention_backend="kernel"),
                        text=_fields(TextConfig, jl.text), embed_dim=jl.embed_dim)
    dcfg = DecoderConfig(**dataclasses.asdict(jd))
    tcfg = _fields(TrainConfig, jt, backbone_dtype=torch.float32)
    backbone, decoder = from_jax_params(jbackbone, jdecoder, lcfg, dcfg)
    rng = np.random.default_rng(9)
    payload = {
        "lcfg": lcfg, "dcfg": dcfg, "tcfg": tcfg, "backbone": backbone.state_dict(),
        "decoder": decoder.state_dict(), "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "video_u8": torch.from_numpy(rng.integers(0, 256, size=(8, 2, 40, 56, 3), dtype=np.uint8)),
        "noun_dict": torch.from_numpy(np.array(jnoun)),
    }
    path = str(tmp_path_factory.mktemp("dist") / "payload.pt")
    torch.save(payload, path)
    mp.start_processes(_rank_main, args=(_free_port(), path), nprocs=WORLD, start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(WORLD)]
    one = {case: _run(payload, case) for case in CASES}
    return types.SimpleNamespace(one=one, ranks=ranks, lr=tcfg.lr, jax=(jx, jl, jd, jt, jbackbone, jdecoder,
                                                                          batch, jnoun))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_loss_terms_and_metrics_equal_one_process(runs, case, rank):
    want, got = runs.one[case][0], runs.ranks[rank][case][0]
    for k in METRICS:
        assert abs(got[k] - want[k]) <= 1e-5 * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert want["box_loss"] > 0 and want["word_loss"] > 0  # every term is exercised


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_gradients_equal_one_process(runs, case, rank):
    want, got = runs.one[case][1], runs.ranks[rank][case][1]
    assert set(got) == set(want)
    tol = 1e-5 * max(1.0, runs.one[case][0]["grad_norm"])
    for name, g in want.items():
        assert float((got[name] - g).abs().max()) <= tol, name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rank", range(WORLD))
def test_parameters_after_the_update_equal_one_process(runs, case, rank):
    want, got = runs.one[case][2], runs.ranks[rank][case][2]
    for name, p in want.items():
        assert float((got[name] - p).abs().max()) <= 2.1 * runs.lr, name


def test_one_process_step_equals_the_jax_step(runs):
    """The reference point of the comparisons: the port's one-process step
    on the whole batch against JAX's, augmentation off."""
    jx, jl, jd, jt, jbackbone, jdecoder, batch, jnoun = runs.jax
    jnp = jx.jnp
    opt = jx.step.make_optimizer(jt)
    state = jx.step.TrainState(jdecoder, opt.init(jdecoder), jnp.zeros((), jnp.int32))
    step = jx.jax.jit(jx.step.make_train_step(jd, jl, jt, opt))
    _, m = step(state, jbackbone, {k: jnp.asarray(v) for k, v in batch.items()}, jnoun, None)
    for k in METRICS:
        assert abs(runs.one["augment_off"][0][k] - float(m[k])) <= 1e-5 * max(1.0, abs(float(m[k]))), k


def test_rows_of_a_batch_that_does_not_split_raise():
    dp = DataParallel(rank=1, world=3, device=torch.device("cpu"))
    assert dp.rows(9) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        dp.rows(8)


def test_init_from_env_without_rank_is_one_process(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert init_from_env("cpu") is None


@pytest.mark.cuda
def test_cuda_single_rank_nccl_step_equals_the_plain_step():
    """One ``nccl`` rank on the card (RANK=0, WORLD_SIZE=1): the step
    through the all-gather / all-reduce code equals the step without
    ``dist`` on the same batch (loss within rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_dist.py)")
    dev = torch.device("cuda")
    lcfg = LavilaConfig(visual=SpaceTimeConfig(img_size=112, patch_size=14, width=128, depth=2, heads=2,
                                               num_frames=4),
                        text=TextConfig(vocab_size=64, context_length=12, width=32, heads=4, layers=2,
                                        embed_dim=16), embed_dim=16)
    dcfg = DecoderConfig(d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_classes=8, feature_dim=128,
                         text_width=32, embed_dim=16, num_frames=4, patches_per_frame=64)
    tcfg = TrainConfig(backbone_dtype=torch.float32, lr=1e-3, input_res=112)
    gen = torch.Generator().manual_seed(0)
    backbone, decoder = Lavila(lcfg, generator=gen).to(dev), ObjDecoder(dcfg, generator=gen)
    rng = np.random.default_rng(0)
    tokens = np.zeros((20, 12), np.int64)
    tokens[:, 0], tokens[:, 1:4], tokens[:, 4] = 62, rng.integers(1, 60, size=(20, 3)), 63
    boxes = (rng.random((4, 4, 4, 4)) * 80).astype(np.float32)
    boxes[..., 2:] += 30
    batch = {"video": rng.integers(0, 256, size=(4, 4, 112, 112, 3), dtype=np.uint8), "tokens": tokens,
             "noun_vec": (rng.random((4, 20)) < 0.3).astype(np.float32),
             "verb_vec": (rng.random((4, 10)) < 0.3).astype(np.float32), "boxes": boxes,
             "nouns": rng.integers(0, 30, size=(4, 4))}
    noun_dict = torch.as_tensor(rng.normal(size=(30, 32)).astype(np.float32), device=dev)
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(_free_port()))
    try:
        dp = init_from_env("cuda")
        losses = []
        for d in (None, dp):
            state = TrainState.create(ObjDecoder(dcfg), tcfg, device=dev)
            state.decoder.load_state_dict(decoder.state_dict())
            _, m = make_train_step(dcfg, lcfg, tcfg, dist=d)(state, backbone, batch, noun_dict)
            losses.append(float(m["total_loss"]))
        torch.distributed.destroy_process_group()
    finally:
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)

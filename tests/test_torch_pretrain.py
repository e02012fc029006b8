"""The port's pretraining loop, checkpoints, config and CLI on the CPU.

``train.pretrain.pretrain`` against the JAX package's, on the synthetic
EgoClip fixture of ``tests/test_harness.py`` (copied here, so that the
file imports no JAX at its top: npy chunks, 8 train rows, 4 EgoMCQ items)
with its tiny models (``test_harness.tiny_models``) bridged
into the port, the decoder's dropout at 0.0 in both (the random streams
cannot match), f32 backbones, one loader thread (the dataset's seeded
negative draws then come in order): the same ``total_loss`` logged at
every flushed step (rtol 1e-5) and the same EgoMCQ accuracies.

Also: resume continues the step counter from the latest checkpoint;
``best/`` is written when the Inter-video accuracy improves; the
checkpoint round trip and the save-behind write; ``apply_overrides`` and
the JSON round trip against JAX's config; the CLI's flags against JAX's
and ``cli.train.main --device cpu`` end to end on the tiny backbone; the
int8 backbone through the loop; the profile trace; the refusals (a
``model_parallel`` that does not divide the world, a
``parallel.num_devices`` that is not the world's); and the loop with
``model_parallel=2`` on two ``gloo`` ranks, its backbone split between
them, against the one-process loop (the logged losses within rtol 1e-5,
the same EgoMCQ accuracies). A ``cuda`` case runs the loop on the card
with the host-sync check on.
"""

import dataclasses
import json
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from helping_hand_for_egocentric_videos_torch.core.checkpoint import (
    PendingSave,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from helping_hand_for_egocentric_videos_torch.core.config import ExperimentConfig, apply_overrides
from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    LavilaConfig,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.models.bridge import from_jax_params
from helping_hand_for_egocentric_videos_torch.train import pretrain as tpre

RES = 28


def _fields(cls, obj, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**{k: v for k, v in dataclasses.asdict(obj).items() if k in names}, **over})


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from test_harness import tiny_models

    from helping_hand_for_egocentric_videos_tpu.core import config as jcfg
    from helping_hand_for_egocentric_videos_tpu.train import pretrain as jpre

    return types.SimpleNamespace(jax=jax, tiny_models=tiny_models, cfg=jcfg, pre=jpre)


def _models(jx, dropout=0.0):
    """JAX's tiny models with the decoder's ``dropout``, and the same bridged
    into the port."""
    jl, jb, jd, jdec = jx.tiny_models()
    jd = dataclasses.replace(jd, dropout=dropout)
    lcfg = LavilaConfig(visual=_fields(SpaceTimeConfig, jl.visual, attention_backend="kernel"),
                        text=_fields(TextConfig, jl.text), embed_dim=jl.embed_dim)
    dcfg = DecoderConfig(**dataclasses.asdict(jd))
    backbone, decoder = from_jax_params(jb, jdec, lcfg, dcfg)
    return (jl, jb, jd, jdec), (lcfg, backbone, dcfg, decoder)


def _configure(cfg, meta, data, out, name, **optim):
    cfg.name, cfg.output_dir = name, out
    cfg.data.meta_dir, cfg.data.data_dir = meta, data
    cfg.data.batch_size, cfg.data.num_frames, cfg.data.input_res, cfg.data.num_workers = 2, 4, RES, 1
    cfg.model.num_queries = 12
    cfg.optim.eval_freq, cfg.optim.runtime_save_iter, cfg.optim.epochs = 1000, 1000, 1
    for k, v in optim.items():
        setattr(cfg.optim, k, v)
    cfg.parallel.backbone_dtype = "float32"
    cfg.parallel.num_devices = 1
    return cfg


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture
def egoclip_fixture(tmp_path):
    return _fixture(tmp_path, noun_width=32)


def test_loop_logs_the_losses_and_accuracies_of_jax(jx, egoclip_fixture, tmp_path):
    meta, data = egoclip_fixture
    jmodels, tmodels = _models(jx)
    jcfg = _configure(jx.cfg.ExperimentConfig(), meta, data, str(tmp_path / "jax"), "run")
    tcfg = _configure(ExperimentConfig(), meta, data, str(tmp_path / "port"), "run")
    _, jbest = jx.pre.pretrain(jcfg, max_steps=3, eval_limit=2, models=jmodels)
    state, tbest = tpre.pretrain(tcfg, max_steps=3, eval_limit=2, models=tmodels, device="cpu")
    assert state.step == 3

    def losses(root):
        return {r["step"]: r["local/total_loss"] for r in _rows(root / "run" / "train_metrics.jsonl")
                if "local/total_loss" in r}

    want, got = losses(tmp_path / "jax"), losses(tmp_path / "port")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=1e-5), s
    jval, tval = (_rows(tmp_path / p / "run" / "val_metrics.jsonl") for p in ("jax", "port"))
    assert [{k: v for k, v in r.items() if k != "time"} for r in tval] == \
        [{k: v for k, v in r.items() if k != "time"} for r in jval]
    assert tbest == jbest
    window = [r for r in _rows(tmp_path / "port" / "run" / "train_metrics.jsonl") if "loop/steps_per_s" in r]
    assert [r["step"] for r in window] == [1, 2, 3] and all(0 <= r["loop/data_share"] <= 1 for r in window)


def test_resume_continues_the_step_counter(jx, egoclip_fixture, tmp_path):
    meta, data = egoclip_fixture
    cfg = _configure(ExperimentConfig(), meta, data, str(tmp_path), "resume", runtime_save_iter=2)
    state, _ = tpre.pretrain(cfg, max_steps=2, eval_limit=1, models=_models(jx)[1], device="cpu")
    assert state.step == 2 and latest_step(str(tmp_path / "resume" / "checkpoints")) == 2
    saved, _ = restore_checkpoint(str(tmp_path / "resume" / "checkpoints"))
    state2, _ = tpre.pretrain(cfg, max_steps=4, eval_limit=1, models=_models(jx)[1], device="cpu")
    assert state2.step == 4 and latest_step(str(tmp_path / "resume" / "checkpoints")) == 4
    assert saved["step"] == 2 and set(saved) == {"decoder", "optimizer", "step", "best_acc"}
    steps = [r["step"] for r in _rows(tmp_path / "resume" / "train_metrics.jsonl") if "local/total_loss" in r]
    assert steps == [1, 2, 3, 4]


def test_best_checkpoint_on_improved_inter_video_accuracy(jx, egoclip_fixture, tmp_path, monkeypatch):
    accs = iter([40.0, 30.0, 55.0])
    monkeypatch.setattr(tpre, "run_egomcq", lambda model, ds, limit=0, **kw: {"Inter-video": next(accs),
                                                                               "Intra-video": 0.0})
    meta, data = egoclip_fixture
    cfg = _configure(ExperimentConfig(), meta, data, str(tmp_path), "best", eval_freq=1, runtime_save_iter=10)
    state, best = tpre.pretrain(cfg, max_steps=3, eval_limit=1, models=_models(jx)[1], device="cpu")
    assert best == 55.0
    best_dir = str(tmp_path / "best" / "best")
    assert latest_step(best_dir) == 3 and sorted(os.listdir(best_dir)) == ["step_00000003"]
    tree, step = restore_checkpoint(best_dir)
    assert step == 3 and tree["best_acc"] == 55.0
    for k, v in state.decoder.state_dict().items():
        assert torch.equal(tree["decoder"][k], v), k


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"c": 1.5}, "step": 3}
    for step in (1, 2, 3):
        save_checkpoint(str(tmp_path), step, tree, keep=2)
    assert latest_step(str(tmp_path)) == 3 and not os.path.exists(tmp_path / "step_00000001")
    restored, step = restore_checkpoint(str(tmp_path))
    assert step == 3 and torch.equal(restored["a"], tree["a"]) and restored["b"] == {"c": 1.5}
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"))


def test_checkpoint_save_behind(tmp_path):
    """block=False: the snapshot is immune to later updates, writes go in
    order, keep-k still prunes, result() returns the step dir."""
    tree = {"a": torch.zeros(2, 3), "b": 1.5}
    p1 = save_checkpoint(str(tmp_path), 1, tree, keep=2, block=False)
    assert isinstance(p1, PendingSave)
    tree["a"] += 100  # in place, after the submission
    p2 = save_checkpoint(str(tmp_path), 2, tree, keep=2, block=False)
    p3 = save_checkpoint(str(tmp_path), 3, tree, keep=2, block=False)
    assert p1.result().endswith("step_00000001")
    for p in (p2, p3):
        p.result()
    assert latest_step(str(tmp_path)) == 3 and not os.path.exists(tmp_path / "step_00000001")
    r2, _ = restore_checkpoint(str(tmp_path), 2)
    assert torch.equal(r2["a"], torch.full((2, 3), 100.0))


@pytest.mark.parametrize("overrides", [
    [],
    ["data.batch_size=64", "optim.lr=0.001", "name=x", "model.pred_traj=false", "data.augment=true",
     "data.randcrop_scale=0.4,0.9", "data.color_jitter=(0.2,0.1,0.05)", "optim.log_flush_iter=7",
     "model.int8_backbone=1"],
], ids=["defaults", "overrides"])
def test_config_overrides_and_json_equal_jax(jx, overrides):
    got = apply_overrides(ExperimentConfig(), overrides)
    want = jx.cfg.apply_overrides(jx.cfg.ExperimentConfig(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    back = ExperimentConfig.from_json(got.to_json())
    assert json.loads(back.to_json()) == json.loads(got.to_json())


def test_cli_accepts_every_flag_of_jax(jx):
    from helping_hand_for_egocentric_videos_tpu.cli import train as jtrain

    from helping_hand_for_egocentric_videos_torch.cli import train as ttrain

    want, got = vars(jtrain.parse_args([])), vars(ttrain.parse_args([]))
    assert {k: got[k] for k in want} == want and set(got) - set(want) == {"device", "sync_debug"}
    argv = ["--augment", "--int8_backbone", "--batch_size", "8", "--set", "optim.lr=0.01", "--max_steps", "3"]
    assert dataclasses.asdict(ttrain.build_config(ttrain.parse_args(argv))) == dataclasses.asdict(
        jtrain.build_config(jtrain.parse_args(argv)))


def test_cli_trains_on_the_cpu(tmp_path):
    """``cli.train.main --device cpu`` with the tiny backbone on a fixture
    whose noun dictionary has the tiny text width (64)."""
    from helping_hand_for_egocentric_videos_torch.cli import train as ttrain

    meta, data = _fixture(tmp_path, noun_width=64)
    state, best = ttrain.main(["--device", "cpu", "--backbone", "timesformer_tiny", "--meta_dir", meta,
                               "--data_dir", data, "--batch_size", "2", "--num_workers", "1", "--output_dir",
                               str(tmp_path / "runs"), "--eval_freq", "2", "--runtime_save_iter", "2",
                               "--epochs", "1", "--max_steps", "2", "--augment", "--set",
                               "data.color_jitter=0.2,0.2,0.1", "data.loading=strict"])
    exp = tmp_path / "runs" / "egoclip_pretrain"
    assert state.step == 2 and latest_step(str(exp / "checkpoints")) == 2
    assert json.loads((exp / "running_config.json").read_text())["data"]["augment"] is True
    losses = [r["local/total_loss"] for r in _rows(exp / "train_metrics.jsonl") if "local/total_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert [r["step"] for r in _rows(exp / "val_metrics.jsonl")] == [2]


def test_int8_backbone_trains_through_the_loop(tmp_path):
    """``model.int8_backbone``: ``build_models`` quantizes the visual block
    matmuls, and the loop trains on the quantized tower."""
    from helping_hand_for_egocentric_videos_torch.models.quant import QuantLinear

    meta, data = _fixture(tmp_path, noun_width=64)
    cfg = ExperimentConfig(name="q", output_dir=str(tmp_path / "runs"))
    cfg.model.backbone, cfg.model.int8_backbone = "timesformer_tiny", True
    cfg.data.meta_dir, cfg.data.data_dir, cfg.data.batch_size, cfg.data.num_workers = meta, data, 2, 1
    models = tpre.build_models(cfg, 0)
    assert isinstance(models[1].visual.blocks[0].attn.qkv, QuantLinear)
    assert isinstance(models[1].visual.blocks[1].mlp_fc2, QuantLinear)
    state, _ = tpre.pretrain(cfg, max_steps=2, eval_limit=1, models=models, device="cpu")
    losses = [r["local/total_loss"] for r in _rows(tmp_path / "runs" / "q" / "train_metrics.jsonl")
              if "local/total_loss" in r]
    assert state.step == 2 and len(losses) == 2 and np.isfinite(losses).all()


def test_profile_step_writes_a_trace(jx, egoclip_fixture, tmp_path):
    meta, data = egoclip_fixture
    cfg = _configure(ExperimentConfig(), meta, data, str(tmp_path), "prof", profile_step=2)
    tpre.pretrain(cfg, max_steps=2, eval_limit=1, models=_models(jx)[1], device="cpu")
    trace = json.loads((tmp_path / "prof" / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_refusals(jx, egoclip_fixture, tmp_path):
    meta, data = egoclip_fixture
    cfg = _configure(ExperimentConfig(), meta, data, str(tmp_path), "r")
    cfg.parallel.model_parallel, cfg.parallel.num_devices = 2, 0
    with pytest.raises(ValueError, match="model_parallel=2 does not divide the run's 1 ranks"):
        tpre.pretrain(cfg, max_steps=1, models=_models(jx)[1], device="cpu")
    cfg.parallel.model_parallel, cfg.parallel.num_devices = 1, 2
    with pytest.raises(ValueError, match="num_devices"):
        tpre.pretrain(cfg, max_steps=1, models=_models(jx)[1], device="cpu")
    cfg.parallel.num_devices = 0
    with pytest.raises(ValueError, match="CUDA"):
        tpre.pretrain(cfg, max_steps=1, models=_models(jx)[1], device="cpu", sync_debug="error")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _split_loop_rank(rank: int, port: int, path: str, eval_limit: int = 2):
    """One of two ranks of the loop, configured by the payload at ``path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    cfg, models = torch.load(path, weights_only=False)
    state, best = tpre.pretrain(cfg, max_steps=3, eval_limit=eval_limit, models=models, device="cpu")
    torch.save({"step": state.step, "best": best}, f"{path}.rank{rank}")
    torch.distributed.destroy_process_group()


def test_loop_with_a_split_backbone_logs_the_one_process_loop(jx, egoclip_fixture, tmp_path):
    """``parallel.model_parallel=2`` on two ``gloo`` ranks: one model group
    (each rank holds half of the backbone's heads and hidden units) and one
    data group, so the same global batch as one process; both ranks run
    the online EgoMCQ and rank 0 logs it. The decoder's dropout is on: the
    ranks of a model group must draw what one process draws."""
    meta, data = egoclip_fixture
    one = _configure(ExperimentConfig(), meta, data, str(tmp_path / "one"), "run")
    split = _configure(ExperimentConfig(), meta, data, str(tmp_path / "split"), "run")
    split.parallel.model_parallel, split.parallel.num_devices = 2, 2
    path = str(tmp_path / "payload.pt")
    torch.save((split, _models(jx, dropout=0.1)[1]), path)
    mp.start_processes(_split_loop_rank, args=(_free_port(), path), nprocs=2, start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(2)]
    state, best = tpre.pretrain(one, max_steps=3, eval_limit=2, models=_models(jx, dropout=0.1)[1], device="cpu")
    assert [r["step"] for r in ranks] == [3, 3] and state.step == 3
    assert ranks[0]["best"] == ranks[1]["best"] == best

    def losses(root):
        return {r["step"]: r["local/total_loss"] for r in _rows(root / "run" / "train_metrics.jsonl")
                if "local/total_loss" in r}

    want, got = losses(tmp_path / "one"), losses(tmp_path / "split")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for s in want:
        assert got[s] == pytest.approx(want[s], rel=1e-5), s
    jval, tval = (_rows(tmp_path / p / "run" / "val_metrics.jsonl") for p in ("one", "split"))
    assert [{k: v for k, v in r.items() if k != "time"} for r in tval] == \
        [{k: v for k, v in r.items() if k != "time"} for r in jval]


def test_data_ranks_return_the_one_process_best(jx, egoclip_fixture, tmp_path):
    """Two ``gloo`` data ranks (``model_parallel=1``): only data group 0
    runs the online EgoMCQ, yet both ranks return the best Inter-video
    accuracy of the one-process loop on the same global batch."""
    meta, data = egoclip_fixture
    one = _configure(ExperimentConfig(), meta, data, str(tmp_path / "one"), "run", eval_freq=1)
    two = _configure(ExperimentConfig(), meta, data, str(tmp_path / "two"), "run", eval_freq=1)
    two.parallel.num_devices = 2
    path = str(tmp_path / "payload.pt")
    torch.save((two, _models(jx)[1]), path)
    mp.start_processes(_split_loop_rank, args=(_free_port(), path, 4), nprocs=2, start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(2)]
    _, best = tpre.pretrain(one, max_steps=3, eval_limit=4, models=_models(jx)[1], device="cpu")
    assert best > 0.0  # all 4 EgoMCQ items: 50.0 here
    assert [r["best"] for r in ranks] == [best, best]


def _fixture(tmp_path, noun_width):
    """The harness fixture's layout with a noun dictionary of ``noun_width``."""
    meta, data = _write(tmp_path)
    torch.save({"pad": torch.zeros(noun_width), "drawer": torch.ones(noun_width)},
               os.path.join(meta, "noun_dict_lavila_embeds.pth"))
    return meta, data


def _write(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(0)
    meta, data = tmp_path / "fixture" / "meta", tmp_path / "fixture" / "data"
    meta.mkdir(parents=True)
    uid = "vid_001"
    vdir = data / "videos_256_chunked" / uid
    vdir.mkdir(parents=True)
    np.save(vdir / "0.mp4.npy", (rng.random((90, 32, 48, 3)) * 255).astype(np.uint8))
    rows = ["video_uid\tclip_start\tclip_end\tclip_text\ttag_noun\ttag_verb\tnarration_time"]
    rows += [f"{uid}\t{0.2 + i * 0.3}\t{0.7 + i * 0.3}\t#C C opens a drawer\t[1]\t[0]\t{0.2 + i * 0.3}"
             for i in range(8)]
    (meta / "egoclip.csv").write_text("\n".join(rows))

    def choice(start):
        return {"video_uid": uid, "clip_start": start, "clip_end": start + 0.5, "clip_text": "#C C opens a drawer",
                "tag_noun": "[1]", "tag_verb": "[0]", "narration_time": start}

    mcq = {str(q): {"query": choice(0.2 + 0.3 * q), "choices": {str(i): choice(0.2 + 0.3 * i) for i in range(5)},
                    "answer": q % 5, "types": 1 + q % 2} for q in range(4)}
    (meta / "egomcq.json").write_text(json.dumps(mcq))
    pd.DataFrame({"group": [["drawer"], ["drawer"]]}).to_csv(meta / "narration_noun_taxonomy.csv", index=False)
    torch.save({}, meta / "lavila_rephrased.pth")
    return str(meta), str(data)


@pytest.mark.cuda
def test_cuda_loop_on_the_kernel_route_without_host_syncs(tmp_path):
    """The loop on the card with a kernel-friendly tiny backbone (N = 64,
    dh = 64): K1 and K2 once a block a step, augmentation on, the steps
    between flushes under ``set_sync_debug_mode("error")``, resume."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (python -m pytest --noconftest -m cuda tests/test_torch_pretrain.py)")
    from helping_hand_for_egocentric_videos_torch.models import Lavila, ObjDecoder
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    meta, data = _fixture(tmp_path, noun_width=32)
    lcfg = LavilaConfig(visual=SpaceTimeConfig(img_size=112, patch_size=14, width=128, depth=2, heads=2,
                                               num_frames=4),
                        text=TextConfig(width=32, heads=4, layers=2, embed_dim=16), embed_dim=16)
    dcfg = DecoderConfig(d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_classes=8, feature_dim=128,
                         text_width=32, embed_dim=16, num_frames=4, patches_per_frame=64)
    gen = torch.Generator().manual_seed(0)
    cfg = ExperimentConfig(name="cuda", output_dir=str(tmp_path / "runs"))
    cfg.data.meta_dir, cfg.data.data_dir, cfg.data.batch_size, cfg.data.num_workers = meta, data, 2, 1
    cfg.data.input_res, cfg.data.augment, cfg.data.color_jitter = 112, True, (0.2, 0.2, 0.1)
    cfg.optim.epochs, cfg.optim.log_flush_iter, cfg.optim.eval_freq, cfg.optim.runtime_save_iter = 2, 4, 4, 4
    da.divided_patch_attention.launches_space = da.divided_patch_attention.launches_time = 0
    state, _ = tpre.pretrain(cfg, models=(lcfg, Lavila(lcfg, generator=gen), dcfg, ObjDecoder(dcfg, generator=gen)),
                             sync_debug="error")
    assert state.step == 8  # 2 epochs of 4 steps
    # each step one forward (2 blocks); each eval 4 items of 5 clips in one batch
    assert da.divided_patch_attention.launches_space >= 8 * 2
    losses = [r["local/total_loss"] for r in _rows(tmp_path / "runs" / "cuda" / "train_metrics.jsonl")
              if "local/total_loss" in r]
    assert losses and np.isfinite(losses).all()

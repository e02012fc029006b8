"""The port's copies of the data pipeline against the JAX package's originals.

The copies (``data/samplers.py``, ``box_crop.py``, ``video.py``,
``egoclip.py``, ``loader.py``, ``native.py``, ``metrics/retrieval.py``,
``utils/logging.py``) use numpy alone, so on the same inputs and seeds
they must give the JAX package's indices, frames and batches bit for bit:
on ``tests/test_data.py::egoclip_fixture`` (npy chunks, hand-object
pickles, rephrased captions, a noun taxonomy), ``ShardedSampler`` over
two ranks and two epochs, the dataset's train items (with their
scene-aware negatives drawn from the seeded generator) and val items,
``PrefetchLoader`` + ``prepare_train_batch``, ``load_noun_dict``, the
frame samplers, the box-union crop and the EgoMCQ metrics. Also: the
torch ``device_prefetch`` / ``pinned_put`` (order, depth, the host
buffers held until the next batch is asked for), the native decoder
building into the checkout's ``build/`` (never into a package), and a
``cuda`` case for the pinned, non-blocking copy.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from test_data import egoclip_fixture  # noqa: F401  (the fixture)

from helping_hand_for_egocentric_videos_torch.data import box_crop as tbox
from helping_hand_for_egocentric_videos_torch.data import egoclip as tego
from helping_hand_for_egocentric_videos_torch.data import loader as tload
from helping_hand_for_egocentric_videos_torch.data import native as tnative
from helping_hand_for_egocentric_videos_torch.data import samplers as tsamp
from helping_hand_for_egocentric_videos_torch.data import video as tvideo
from helping_hand_for_egocentric_videos_torch.data.tokenizer import ClipTokenizer
from helping_hand_for_egocentric_videos_torch.metrics import retrieval as tret
from helping_hand_for_egocentric_videos_torch.utils import logging as tlog

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jd():
    from helping_hand_for_egocentric_videos_tpu.data import box_crop, egoclip, loader, samplers, video
    from helping_hand_for_egocentric_videos_tpu.metrics import retrieval

    return {"box_crop": box_crop, "egoclip": egoclip, "loader": loader, "samplers": samplers, "video": video,
            "retrieval": retrieval}


def _equal(a, b, path="item"):
    """Bit-for-bit equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_sampler_matches_jax(jd, world, shuffle):
    for rank in range(world):
        kw = dict(shuffle=shuffle, host_id=rank, num_hosts=world, seed=5)
        t, j = tload.ShardedSampler(37, 4, **kw), jd["loader"].ShardedSampler(37, 4, **kw)
        assert len(t) == len(j)
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            _equal([b.tolist() for b in t], [b.tolist() for b in j])
        for drop_last in (False,):
            t2 = tload.ShardedSampler(37, 4, drop_last=drop_last, **kw)
            j2 = jd["loader"].ShardedSampler(37, 4, drop_last=drop_last, **kw)
            assert len(t2) == len(j2) and [b.tolist() for b in t2] == [b.tolist() for b in j2]


@pytest.mark.parametrize("split", ["train", "val"])
def test_egoclip_items_match_jax(jd, egoclip_fixture, split):  # noqa: F811
    meta, data = egoclip_fixture
    kw = dict(meta_dir=meta, data_dir=data, split=split, decode_res=(32, 48), seed=3, frame_sample="rand")
    t = tego.EgoClipDataset(tego.EgoClipConfig(**kw))
    j = jd["egoclip"].EgoClipDataset(jd["egoclip"].EgoClipConfig(**kw))
    assert len(t) == len(j) > 0
    for i in list(range(len(t))) * 2:  # twice: the seeded draws go on alike
        _equal(t[i], j[i], f"{split}[{i}]")


def test_load_noun_dict_matches_jax(jd, egoclip_fixture):  # noqa: F811
    meta, _ = egoclip_fixture
    (tn, te), (jn, je) = tego.load_noun_dict(meta), jd["egoclip"].load_noun_dict(meta)
    assert tn == jn
    _equal(te, je)
    assert tego.STOPWORD_NOUN_IDS == jd["egoclip"].STOPWORD_NOUN_IDS


@pytest.mark.parametrize("world", [1, 2])
def test_loader_and_prepared_batches_match_jax(jd, egoclip_fixture, world):  # noqa: F811
    """A rank's loader (its share of the global batch of 2 items) through
    ``prepare_train_batch``, both packages, two epochs."""
    meta, data = egoclip_fixture
    tok = ClipTokenizer()
    for rank in range(world):
        out = []
        for mod in (tload, jd["loader"]):
            ego = tego if mod is tload else jd["egoclip"]
            ds = ego.EgoClipDataset(ego.EgoClipConfig(meta_dir=meta, data_dir=data, split="train",
                                                      decode_res=(32, 48), seed=111 + rank))
            sampler = mod.ShardedSampler(len(ds), 2 // world, host_id=rank, num_hosts=world, seed=111)
            loader = mod.PrefetchLoader(ds, sampler, num_threads=1, transform=lambda b: mod.prepare_train_batch(b, tok))
            batches = []
            for epoch in (0, 1):
                sampler.set_epoch(epoch)
                batches += list(loader)
            out.append(batches)
        _equal(out[0], out[1], f"rank{rank}")
        assert out[0][0]["video"].shape[0] == 2 * (2 // world)  # positives and their negatives


def test_frame_samplers_and_reader_match_jax(jd, tmp_path):
    j = jd["samplers"]
    for n, vlen in ((4, 90), (3, 12), (5, 40)):
        for sample in ("uniform", "rand"):
            assert tsamp.sample_frames(n, vlen, sample, rng=np.random.default_rng(1)) == j.sample_frames(
                n, vlen, sample, rng=np.random.default_rng(1))
            assert tsamp.sample_frames_start_end(n, 2, vlen + 2, sample, rng=np.random.default_rng(2)) == \
                j.sample_frames_start_end(n, 2, vlen + 2, sample, rng=np.random.default_rng(2))
        assert tsamp.sample_frames_clips(-3, vlen + 9, vlen, n) == j.sample_frames_clips(-3, vlen + 9, vlen, n)
        for jitter in (True, False):
            assert tsamp.get_frame_ids(3, 3 + vlen, n, jitter, rng=np.random.default_rng(3)) == j.get_frame_ids(
                3, 3 + vlen, n, jitter, rng=np.random.default_rng(3))
    rng = np.random.default_rng(4)
    np.save(tmp_path / "0.mp4.npy", (rng.random((45, 8, 8, 3)) * 255).astype(np.uint8))
    np.save(tmp_path / "1.mp4.npy", (rng.random((60, 8, 8, 3)) * 255).astype(np.uint8))
    for start, end in ((0.2, 0.9), (1.0, 2.0), (1.4, 1.45)):
        kw = dict(next_path=str(tmp_path / "1.mp4"), clip_length=4, jitter=True)
        _equal(tvideo.read_clip_chunked(str(tmp_path / "0.mp4"), start, end, rng=np.random.default_rng(5), **kw),
               jd["video"].read_clip_chunked(str(tmp_path / "0.mp4"), start, end, rng=np.random.default_rng(5), **kw))
    frames = (rng.random((2, 10, 14, 3)) * 255).astype(np.uint8)
    _equal(tvideo.resize_frames(frames, (6, 9)), jd["video"].resize_frames(frames, (6, 9)))


def test_box_union_crop_matches_jax(jd):
    rng = np.random.default_rng(6)
    frames = (rng.random((4, 40, 60, 3)) * 255).astype(np.uint8)
    boxes = np.zeros((4, 4, 4), np.float32)
    boxes[:, :2] = [10, 8, 22, 20]
    boxes[1, 2] = [30, 5, 44, 30]
    for b in (boxes, np.zeros_like(boxes)):
        (tf, tp), (jf, jp) = tbox.box_union_crop(frames, b), jd["box_crop"].box_union_crop(frames, b)
        _equal((tf, tp), (jf, jp))
        _equal(tbox.apply_crop_to_boxes(b, tp, 224), jd["box_crop"].apply_crop_to_boxes(b, jp, 224))


def test_retrieval_metrics_match_jax(jd):
    rng = np.random.default_rng(7)
    sims = rng.normal(size=(12, 5))
    gt, types = rng.integers(0, 5, 12), 1 + rng.integers(0, 2, 12)
    j = jd["retrieval"]
    assert tret.egomcq_accuracy_metrics(sims, gt, types) == j.egomcq_accuracy_metrics(sims, gt, types)
    assert tret.egomcq_accuracy_by_type(sims, gt, types) == j.egomcq_accuracy_by_type(sims, gt, types)
    sq = rng.normal(size=(9, 9))
    assert tret.t2v_metrics(sq) == j.t2v_metrics(sq) and tret.v2t_metrics(sq) == j.v2t_metrics(sq)


def test_metric_logger_and_meters(tmp_path):
    log = tlog.MetricLogger(str(tmp_path), "train")
    log.log(3, {"a": np.float32(1.5)}, prefix="local/")
    log.close()
    (row,) = [json.loads(x) for x in open(tmp_path / "train_metrics.jsonl")]
    assert row["step"] == 3 and row["local/a"] == 1.5
    m = tlog.AverageMeter("Loss", ":.2f")
    m.update(1.0)
    m.update(3.0)
    assert m.avg == 2.0 and str(m) == "Loss 3.00 (2.00)"


def test_device_prefetch_order_depth_and_held_buffers():
    put_log, out, live = [], [], []

    def put(b):
        put_log.append(b)
        return b, f"host{b}"

    gen = tload.device_prefetch(iter(range(7)), put, depth=2)
    for item in gen:
        out.append(item)
        assert len(put_log) - len(out) <= 2  # at most depth batches queued ahead
        live.append(gen.gi_frame.f_locals["held"][1])  # the consumed batch's host buffers are still held
    assert out == list(range(7)) and put_log == list(range(7)) and live == [f"host{i}" for i in range(7)]
    assert list(tload.device_prefetch(iter([42]), lambda b: (b, None), depth=4)) == [42]
    assert list(tload.device_prefetch(iter([]), lambda b: (b, None))) == []


def test_pinned_put_on_the_cpu_shares_memory_and_drops_strings():
    batch = {"video": np.arange(6, dtype=np.uint8).reshape(2, 3), "text_str": ["a", "b"], "n": np.zeros(2)}
    out, pinned = tload.pinned_put(batch, "cpu")
    assert set(out) == {"video", "n"} and pinned == {}
    assert out["video"].data_ptr() == batch["video"].ctypes.data


def test_native_builds_into_the_checkouts_build_dir(tmp_path, monkeypatch):
    """The library's and the tool's paths lie under ``build/native`` of
    the checkout, in neither package; a build from scratch (here into a
    temporary directory) decodes a JPEG as the JAX package's does."""
    for path in (tnative._LIB_PATH, tnative._FFTOOL_PATH):
        assert Path(path).parent == ROOT / "build" / "native"
    assert Path(tnative._SRC) == ROOT / "native" / "hh_dataio.cpp"
    from PIL import Image

    img = np.zeros((8, 12, 3), np.uint8)
    img[..., 0] = 10
    Image.fromarray(img).save(tmp_path / "a.jpg", quality=100)
    monkeypatch.setattr(tnative, "_LIB_PATH", str(tmp_path / "lib" / "libhh_dataio.so"))
    tnative.get_lib.cache_clear()
    try:
        got = tnative.decode_jpeg(str(tmp_path / "a.jpg"))
    except tnative.NativeUnavailable:
        tnative.get_lib.cache_clear()
        pytest.skip("toolchain/libjpeg unavailable on this host")
    assert os.path.exists(tmp_path / "lib" / "libhh_dataio.so")
    assert got.shape == (8, 12, 3) and int(got[0, 0, 0]) == 10
    tnative.get_lib.cache_clear()


@pytest.mark.cuda
def test_cuda_pinned_put_copies_without_waiting():
    """On the card: pinned host copies, non-blocking device copies equal
    to the arrays, and no host sync while queuing them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_data.py)")
    batches = [{"video": np.full((2, 4, 8, 8, 3), i, np.uint8), "boxes": np.full((2, 4), i, np.float32)}
               for i in range(5)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(tload.device_prefetch(iter(batches), lambda b: tload.pinned_put(b, "cuda"), depth=2))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for i, b in enumerate(got):
        assert b["video"].is_cuda and int(b["video"][0, 0, 0, 0, 0]) == i and float(b["boxes"][1, 3]) == i
    _, pinned = tload.pinned_put(batches[0], "cuda")
    assert all(t.is_pinned() for t in pinned.values())

"""The port's eval entry points against the JAX package's, on the CPU.

The five CLIs (``test_egomcq``, ``test_epic``, ``test_egtea`` with
``--spatial_crops 3``, ``extract_features`` and ``parity_check``) run in
both packages on the synthetic layouts of tests/test_cli.py and
tests/test_data.py, from the same reference-layout checkpoint files
(timesformer_tiny and a 13-query decoder at 4 frames, written by
test_torch_cli.py's ``_ckpts``), so both load the same weights; EPIC and
EGTEA run at 8 frames, so both temporal embeddings are inflated. Both
packages' ``EvalModel`` default to bf16; here both run in f32 (each
package's ``EvalModel`` is wrapped with its f32 dtype while the CLIs
build it). Then:

- the ``--out`` JSON has the JAX CLI's keys; the similarity dumps agree
  within 1e-5, and the metrics are equal wherever no ranked row holds a
  gap below 10x that (a near-tie could swap two ranks across frameworks;
  tests/test_torch_eval_harness.py states the rule);
- ``extract_features`` writes the same files, features within 1e-4;
- ``parity_check``'s report has JAX's fields plus ``backend`` and
  ``device``, and the same verdicts on tests/test_cli.py's target table.

The EPIC and EGTEA dataset copies give JAX's items bit for bit, in the
test and train modes and through EGTEA's padding of short videos.
"""

import functools
import json
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.cli import extract_features as j_extract
from helping_hand_for_egocentric_videos_tpu.cli import parity_check as j_parity
from helping_hand_for_egocentric_videos_tpu.cli import test_egomcq as j_egomcq
from helping_hand_for_egocentric_videos_tpu.cli import test_egtea as j_egtea
from helping_hand_for_egocentric_videos_tpu.cli import test_epic as j_epic
from helping_hand_for_egocentric_videos_tpu.data import egtea as j_egtea_data
from helping_hand_for_egocentric_videos_tpu.data import epic as j_epic_data
from helping_hand_for_egocentric_videos_tpu.train import evaluate as jev
from helping_hand_for_egocentric_videos_torch.cli import extract_features, parity_check, test_egomcq, test_egtea, test_epic
from helping_hand_for_egocentric_videos_torch.data import egtea as t_egtea_data
from helping_hand_for_egocentric_videos_torch.data import epic as t_epic_data
from helping_hand_for_egocentric_videos_torch.train import evaluate as tev
from test_cli import _egtea_fixture, _epic_fixture
from test_data import egoclip_fixture  # noqa: F401  (fixture re-export)
from test_torch_cli import _ckpts
from test_torch_eval_harness import _metrics_if_no_near_tie, _min_gap

SIM_TOL = 1e-5
FEAT_TOL = 1e-4
PORT_ARGS = ["--device", "cpu"]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return _ckpts(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(autouse=True)
def f32_models(monkeypatch):
    """Both packages' CLIs build f32 models, and JAX's keep no compilation
    cache outside the test's directories. Every cosine matrix a harness
    takes is recorded, by package."""
    monkeypatch.setenv("HH_COMPILATION_CACHE", "0")
    monkeypatch.setattr(jev, "EvalModel", functools.partial(jev.EvalModel, dtype=jnp.float32))
    monkeypatch.setattr(tev, "EvalModel", functools.partial(tev.EvalModel, dtype=torch.float32))
    sims = {"jax": [], "torch": []}
    for name, mod in (("jax", jev), ("torch", tev)):
        def recorded(a, b, _cos=mod._cos, _out=sims[name]):
            _out.append(_cos(a, b))
            return _out[-1]

        monkeypatch.setattr(mod, "_cos", recorded)
    return sims


def _model_args(ckpts):
    bpath, dpath = ckpts
    return ["--backbone", "timesformer_tiny", "--backbone_ckpt", bpath, "--decoder_ckpt", dpath]


def _both(tmp_path, run):
    """run(package name, out path, extra argv) for both packages -> {name:
    the --out JSON}."""
    res = {}
    for name, extra in (("jax", []), ("torch", PORT_ARGS)):
        out = tmp_path / f"{name}.json"
        run(name, out, extra)
        res[name] = json.loads(out.read_text())
    return res


def test_egomcq_cli_matches_jax(egoclip_fixture, ckpts, tmp_path):  # noqa: F811
    meta, data = egoclip_fixture
    mods = {"jax": j_egomcq, "torch": test_egomcq}

    def run(name, out, extra):
        mods[name].main(["--meta_dir", str(meta), "--data_dir", str(data), *_model_args(ckpts), "--out", str(out),
                         "--out_sims", str(tmp_path / f"{name}.npz"), *extra])

    res = _both(tmp_path, run)
    got, want = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    assert got["sims"].shape == want["sims"].shape == (2, 5)
    np.testing.assert_allclose(got["sims"], want["sims"], atol=SIM_TOL)
    np.testing.assert_array_equal(got["gt"], want["gt"])
    np.testing.assert_array_equal(got["types"], want["types"])
    _metrics_if_no_near_tie(res["torch"], res["jax"], _min_gap(want["sims"]), SIM_TOL)


def test_epic_cli_matches_jax(ckpts, tmp_path, capsys):
    meta, data = _epic_fixture(tmp_path)
    mods = {"jax": j_epic, "torch": test_epic}

    def run(name, out, extra):
        mods[name].main(["--meta_dir", meta, "--data_dir", data, *_model_args(ckpts), "--num_frames", "8",
                         "--batch_size", "2", "--out", str(out), "--out_sims", str(tmp_path / f"{name}.npz"),
                         *extra])

    res = _both(tmp_path, run)
    # the two lines in JAX's format, JAX's run first
    printed = [line for line in capsys.readouterr().out.splitlines() if line.startswith(("nDCG:", "mAP:"))]
    assert printed[2:] == ["nDCG: VT:{nDCG_VT:.3f} TV:{nDCG_TV:.3f} AVG:{nDCG_AVG:.3f}".format(**res["torch"]),
                           "mAP: VT:{mAP_VT:.3f} TV:{mAP_TV:.3f} AVG:{mAP_AVG:.3f}".format(**res["torch"])]
    assert len(printed) == 4
    got, want = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    for key in ("pred", "processed"):
        assert got[key].shape == want[key].shape == (4, 4)
        np.testing.assert_allclose(got[key], want[key], atol=SIM_TOL)
    for v in res["torch"].values():
        assert np.isfinite(v) and 0 <= v <= 1.0001
    gap = min(_min_gap(want["processed"]), _min_gap(want["processed"].T))
    _metrics_if_no_near_tie(res["torch"], res["jax"], gap, SIM_TOL)


def test_egtea_cli_multicrop_matches_jax(ckpts, tmp_path, f32_models):
    meta, data = _egtea_fixture(tmp_path)
    mods = {"jax": j_egtea, "torch": test_egtea}

    def run(name, out, extra):
        mods[name].main(["--meta_dir", meta, "--data_dir", data, *_model_args(ckpts), "--num_frames", "8",
                         "--num_clips", "2", "--splits", "1", "--spatial_crops", "3", "--out", str(out), *extra])

    res = _both(tmp_path, run)
    # the per-item logits: 2 windows x 3 crops against the 2 labels
    got, want = f32_models["torch"], f32_models["jax"]
    assert len(got) == len(want) == 3 and got[0].shape == (6, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=SIM_TOL)
    _metrics_if_no_near_tie(res["torch"], res["jax"], min(_min_gap(w.max(0)) for w in want), SIM_TOL)


def test_extract_features_cli_matches_jax(ckpts, tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "videos"
    data.mkdir()
    np.save(data / "a.mp4.npy", (rng.random((70, 16, 24, 3)) * 255).astype(np.uint8))
    np.save(data / "b.mp4.npy", (rng.random((40, 16, 24, 3)) * 255).astype(np.uint8))
    for name, mod, extra in (("jax", j_extract, []), ("torch", extract_features, PORT_ARGS)):
        mod.main(["--data_dir", str(data), "--out_dir", str(tmp_path / name), *_model_args(ckpts),
                  "--num_frames", "4", "--stride_sec", "1.0", "--fps", "30.0", "--batch_windows", "2", *extra])
    files = sorted(p.name for p in (tmp_path / "torch").glob("*.features.npz"))
    assert files == sorted(p.name for p in (tmp_path / "jax").glob("*.features.npz")) and len(files) == 2
    for f in files:
        got, want = np.load(tmp_path / "torch" / f), np.load(tmp_path / "jax" / f)
        assert got["features"].dtype == np.float32 and got["features"].shape == want["features"].shape
        np.testing.assert_allclose(got["features"], want["features"], atol=FEAT_TOL)
        for key in ("starts", "fps", "path"):
            np.testing.assert_array_equal(got[key], want[key])
    assert extract_features.iter_windows(70, 30.0, 4, 1.0) == j_extract.iter_windows(70, 30.0, 4, 1.0) == [0, 30, 60]
    assert extract_features.iter_windows(3, 30.0, 4, 1.0) == j_extract.iter_windows(3, 30.0, 4, 1.0) == [0]


def test_parity_check_cli_matches_jax_verdicts(egoclip_fixture, ckpts, tmp_path):  # noqa: F811
    meta, data = egoclip_fixture
    epic_meta, epic_data = _epic_fixture(tmp_path)
    egtea_meta, egtea_data = _egtea_fixture(tmp_path)
    targets = tmp_path / "targets.json"
    targets.write_text(json.dumps({  # tests/test_cli.py's table
        "egomcq.Inter-video": 50.0,  # gated with a huge tol -> pass
        "epic.mAP_AVG": 999.0,  # impossible target -> fail
        "egtea.mean_class_acc": 10.0,  # gated with a huge tol -> pass
        "egtea.missing_metric": 1.0,  # metric never produced -> fail + note
    }))
    reps = {}
    for name, mod, extra in (("jax", j_parity, []), ("torch", parity_check, PORT_ARGS)):
        out_dir = tmp_path / name
        reps[name] = mod.main([
            "--egomcq_meta", meta, "--egomcq_data", data, "--epic_meta", epic_meta, "--epic_data", epic_data,
            "--egtea_meta", egtea_meta, "--egtea_data", egtea_data, "--egtea_splits", "1", "--egtea_num_clips", "2",
            *_model_args(ckpts), "--egomcq_frames", "4", "--epic_frames", "4", "--egtea_frames", "4", "--int8_diff",
            "--targets", str(targets), "--tol", "100", "--out_dir", str(out_dir), *extra])
        assert json.loads((out_dir / "PARITY_REPORT.json").read_text()) == reps[name]
        assert (out_dir / "egomcq_sims_f32.npz").exists() and (out_dir / "epic_sims_int8.npz").exists()
    got, want = reps["torch"], reps["jax"]
    assert set(got) - set(want) == {"backend", "device"} and set(want) <= set(got)
    assert got["backend"] == "torch" and got["device"] == "cpu"
    assert got["backbone_ckpt_sha256"] == want["backbone_ckpt_sha256"] is not None
    assert got["decoder_ckpt_sha256"] == want["decoder_ckpt_sha256"] is not None
    for key in ("metrics", "metrics_int8"):
        assert {h: set(m) for h, m in got[key].items()} == {h: set(m) for h, m in want[key].items()}
    assert {k: (g["pass"], g.get("note")) for k, g in got["gate"].items()} == \
        {k: (g["pass"], g.get("note")) for k, g in want["gate"].items()}
    assert [k for k, g in got["gate"].items() if g["pass"]] == ["egomcq.Inter-video", "egtea.mean_class_acc"]
    assert set(got["int8_agreement"]) == set(want["int8_agreement"]) == {"egomcq", "epic"}
    for ag in got["int8_agreement"].values():
        assert 0.0 <= ag["argmax_agreement"] <= 1.0 and -1.0 <= ag["spearman"] <= 1.0
    assert got["int8_certified"] == all(a["pass"] for a in got["int8_agreement"].values())
    assert got["certified"] is want["certified"] is False
    # the f32 dumps, harness by harness
    for dump, key in (("egomcq_sims_f32.npz", "sims"), ("epic_sims_f32.npz", "pred")):
        np.testing.assert_allclose(np.load(tmp_path / "torch" / dump)[key], np.load(tmp_path / "jax" / dump)[key],
                                   atol=SIM_TOL)


# ---------------------------------------------------------------- dataset copies

def _items_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype
            np.testing.assert_array_equal(got[k], w)
        else:
            assert got[k] == w and type(got[k]) is type(w), k


@pytest.mark.parametrize("split", ["test", "train"])
def test_epic_dataset_items_equal_jax(tmp_path, split):
    meta, data = _epic_fixture(tmp_path)
    if split == "train":  # the train files: the test layout under the train names, graded relevancy
        import pickle

        for rel in ("retrieval_annotations/EPIC_100_retrieval_{}.csv",
                    "retrieval_annotations/EPIC_100_retrieval_{}_sentence.csv"):
            shutil.copy(f"{meta}/{rel.format('test')}", f"{meta}/{rel.format('train')}")
        rng = np.random.default_rng(5)
        with open(f"{meta}/relevancy/caption_relevancy_EPIC_100_retrieval_train.pkl", "wb") as f:
            pickle.dump(np.round(rng.random((4, 4)), 2), f)
    kw = dict(meta_dir=meta, data_dir=data, split=split, num_frames=8, seed=3)
    got = t_epic_data.EpicMIRDataset(t_epic_data.EpicConfig(**kw))
    want = j_epic_data.EpicMIRDataset(j_epic_data.EpicConfig(**kw))
    assert len(got) == len(want) == 4
    for i in (0, 1, 2, 3, 5):  # 5 wraps around
        _items_equal(got[i], want[i])
    assert t_epic_data.datetime2sec("01:02:03.50") == j_epic_data.datetime2sec("01:02:03.50") == 3723.5


@pytest.mark.parametrize("clip_length, training", [(4, False), (16, False), (4, True), (16, True)],
                         ids=["windows", "padded", "train", "train-padded"])
def test_egtea_dataset_items_equal_jax(tmp_path, clip_length, training):
    """24-frame videos: 2 windows of 4 x stride 2 sit inside them, one of
    16 x 2 = 32 frames pads them with zeros."""
    meta, data = _egtea_fixture(tmp_path)
    kw = dict(root=data, metadata=f"{meta}/test_split1.txt", anno_dir=meta, num_clips=2, clip_length=clip_length,
              clip_stride=2, is_training=training, seed=4)
    got = t_egtea_data.EgteaDataset(t_egtea_data.EgteaConfig(**kw))
    want = j_egtea_data.EgteaDataset(j_egtea_data.EgteaConfig(**kw))
    assert got.samples == want.samples and len(got) == 3
    for i in range(3):
        item = got[i]
        _items_equal(item, want[i])
        assert item["video"].shape[0] == clip_length * (1 if training else 2)
        if clip_length == 16:
            assert not item["video"][-4:].any()  # the zero padding, strided
    assert t_egtea_data.generate_label_map(f"{meta}/action_idx.txt") == \
        j_egtea_data.generate_label_map(f"{meta}/action_idx.txt") == (["open drawer", "cut onion"],
                                                                       {"open drawer": 0, "cut onion": 1})

"""The port's copies of the eval metrics against the JAX package's.

nDCG, mAP, the classification metrics and the Charades-style metrics are
host-side numpy in both packages: on the same seeded arrays they must give
the same numbers bit for bit, and nDCG the reference's golden value.
"""

import numpy as np
import pytest

from helping_hand_for_egocentric_videos_tpu import metrics as jm
from helping_hand_for_egocentric_videos_torch import metrics as tm

# the reference's nDCG self-test (utils/nDCG.py:136-164), as tests/test_metrics.py holds it
SIM = np.array([[1.0, 0.7, 0.4, 0.0], [0.3, 0.9, 0.6, 0.1], [0.2, 0.5, 0.8, 0.4]])
REL = np.array([[1.0, 0.5, 0.25, 0.0], [0.0, 1.0, 0.4, 0.0], [0.5, 0.3, 1.0, 0.0]])


def _graded(rng, n_q, n_d):
    """A relevancy matrix with graded values in [0, 1], zeros, and a 1 in every row and column."""
    rel = np.round(rng.random((n_q, n_d)), 2) * (rng.random((n_q, n_d)) < 0.5)
    rel[np.arange(n_q), rng.integers(0, n_d, n_q)] = 1.0
    rel[rng.integers(0, n_q, n_d), np.arange(n_d)] = 1.0
    return rel


def test_the_port_exports_the_jax_metric_names():
    assert set(tm.__all__) == set(jm.__all__)


def test_ndcg_golden_value():
    k = tm.calculate_k_counts(REL)
    assert (k == np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 1, 1, 0]])).all()
    ndcg = tm.calculate_nDCG(SIM, REL, k)
    assert abs(ndcg - 0.9371789900735429) < 1e-12
    assert ndcg == jm.calculate_nDCG(SIM, REL, k)


@pytest.mark.parametrize("shape", [(5, 7), (12, 12), (30, 9)])
def test_ndcg_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    sim, rel = rng.normal(size=shape), _graded(rng, *shape)
    k = tm.calculate_k_counts(rel)
    np.testing.assert_array_equal(k, jm.calculate_k_counts(rel))
    np.testing.assert_array_equal(tm.calculate_DCG(sim, rel, k), jm.calculate_DCG(sim, rel, k))
    idcg = tm.calculate_IDCG(rel, k)
    np.testing.assert_array_equal(idcg, jm.calculate_IDCG(rel, k))
    for red in ("mean", None):
        np.testing.assert_array_equal(tm.calculate_nDCG(sim, rel, k, IDCG=idcg, reduction=red),
                                      jm.calculate_nDCG(sim, rel, k, IDCG=idcg, reduction=red))
    assert tm.calculate_nDCG(sim, rel) == jm.calculate_nDCG(sim, rel)


@pytest.mark.parametrize("shape", [(5, 7), (12, 12), (30, 9)])
def test_map_matches_jax(shape):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    sim, rel = rng.normal(size=shape), _graded(rng, *shape)
    assert tm.calculate_mAP(sim, rel) == jm.calculate_mAP(sim, rel)
    assert tm.calculate_mAP(sim.T, rel.T.copy()) == jm.calculate_mAP(sim.T, rel.T.copy())


def test_map_hand_checked():
    # one query, relevant items at ranks 1 and 3: AP = (1/1 + 2/3) / 2
    np.testing.assert_allclose(tm.calculate_mAP(np.array([[0.9, 0.8, 0.7]]), np.array([[1, 0, 1]])),
                               (1.0 + 2 / 3) / 2)


@pytest.mark.parametrize("num_classes", [3, 106])
def test_classification_matches_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    labels = rng.integers(0, num_classes, 50)
    preds = np.where(rng.random(50) < 0.4, labels, rng.integers(0, num_classes, 50))
    np.testing.assert_array_equal(tm.confusion_matrix(preds, labels, num_classes),
                                  jm.confusion_matrix(preds, labels, num_classes))
    assert tm.mean_class_accuracy(preds, labels, num_classes) == jm.mean_class_accuracy(preds, labels, num_classes)
    scores = rng.normal(size=(50, num_classes))
    assert tm.topk_accuracy(scores, labels, ks=(1, 3, 5)) == jm.topk_accuracy(scores, labels, ks=(1, 3, 5))


def test_charades_metrics_match_jax():
    rng = np.random.default_rng(11)
    sub = rng.normal(size=(20, 6))
    gt = (rng.random((20, 6)) < 0.3).astype(int)
    gt[:, 5] = 0  # an empty class: nan in both
    gt[3] = 0  # a video with no labels: masked by charades_map
    m_ap, w_ap, aps = tm.multi_label_map(sub, gt)
    j_ap, j_w, j_aps = jm.multi_label_map(sub, gt)
    assert m_ap == j_ap
    np.testing.assert_array_equal(aps, j_aps)
    np.testing.assert_array_equal(w_ap, j_w)
    assert tm.charades_map(sub, gt) == jm.charades_map(sub, gt)
    labels = rng.integers(0, 6, 20)
    assert tm.oscc_accuracy(sub, labels) == jm.oscc_accuracy(sub, labels)


def test_pnr_keyframe_distance_matches_jax():
    from helping_hand_for_egocentric_videos_tpu.metrics.charades import pnr_keyframe_distance as jpnr
    from helping_hand_for_egocentric_videos_torch.metrics.charades import pnr_keyframe_distance as tpnr

    rng = np.random.default_rng(12)
    n = 10
    args = (rng.normal(size=(n, 16)), rng.integers(0, 2, n), np.full(n, 30.0), rng.integers(0, 50, n),
            rng.integers(100, 200, n), rng.integers(50, 100, n))
    assert tpnr(*args) == jpnr(*args)
    assert tpnr(args[0], np.zeros(n), *args[2:]) == jpnr(args[0], np.zeros(n), *args[2:]) == 0.0

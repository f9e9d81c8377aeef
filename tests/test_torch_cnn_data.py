"""The CNN slice's data path against hetu_tpu on the CPU: ``Dataloader``
batch order (in order, shuffled per epoch, with and without
``drop_last``) and casts, dataloader ops in a train + validate executor
and ``get_batch_num``, ``data.py`` (the checked-in digits, the seeded
synthetic CIFAR stand-in and its warning, one-hot, normalization,
augmentation) and every function of ``metrics.py``. The port keeps its
own copies of ``data.py`` and ``metrics.py``, so they must give exactly
the reference's values.
"""
import numpy as np
import pytest

import hetu_tpu as jht
import hetu_tpu.models as JM
import hetu_tpu_torch as tht
import hetu_tpu_torch.models as TM


def _batches(dl, n):
    return [dl.get_arr() for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_batch_order_matches(shuffle, drop_last):
    data = np.arange(23 * 3, dtype=np.float64).reshape(23, 3)
    jdl = jht.Dataloader(data, 5, "train", drop_last=drop_last,
                         shuffle=shuffle)
    tdl = tht.Dataloader(data, 5, "train", drop_last=drop_last,
                         shuffle=shuffle)
    jdl.init_states()
    tdl.init_states()
    assert tdl.batch_num == jdl.batch_num == (4 if drop_last else 5)
    n = 3 * tdl.batch_num + 2                   # three epochs and more
    for j, t in zip(_batches(jdl, n), _batches(tdl, n)):
        assert t.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(t, j)
    assert tdl.epoch == jdl.epoch == 3


def test_dataloader_casts_integers():
    small = np.arange(10, dtype=np.int64)
    assert tht.Dataloader(small, 2).raw_data.dtype == np.int32
    assert jht.Dataloader(small, 2).raw_data.dtype == np.int32
    big = np.array([0, 2 ** 40], dtype=np.int64)
    assert tht.Dataloader(big, 1).raw_data.dtype == np.int64
    with pytest.raises(ValueError, match="make no batch"):
        tht.Dataloader(small, 11).init_states()


def _digits_session(ht, models, train_x, train_y, val_x, val_y, batch):
    x = ht.dataloader_op([ht.Dataloader(train_x, batch, "train"),
                          [val_x, batch, "validate"]])
    y_ = ht.dataloader_op([ht.Dataloader(train_y, batch, "train"),
                           [val_y, batch, "validate"]])
    loss, y = models.logreg(x, y_, input_dim=train_x.shape[1])
    train = ht.optim.SGDOptimizer(0.5).minimize(loss)
    kw = {"ctx": tht.cpu(0)} if ht is tht else {}
    return ht.Executor({"train": [loss, y, y_, train],
                        "validate": [loss, y, y_]}, **kw)


def test_dataloader_ops_in_a_train_and_validate_executor():
    """logreg on the checked-in digits fed by dataloader ops: each run of
    a subgraph takes its own split's next batch; batch counts; losses
    and predictions against the reference."""
    (tx, ty), (vx, vy), _ = tht.data.digits()
    texe = _digits_session(tht, TM, tx, ty, vx, vy, 64)
    jexe = _digits_session(jht, JM, tx, ty, vx, vy, 64)
    assert texe.get_batch_num("train") == jexe.get_batch_num("train") \
        == len(tx) // 64
    assert texe.get_batch_num("validate") == len(vx) // 64
    for name, steps in (("train", 4), ("validate", 3), ("train", 2)):
        for _ in range(steps):
            jl, jy, jlabels = jexe.run(name,
                                       convert_to_numpy_ret_vals=True)[:3]
            tl, tyv, tlabels = texe.run(name,
                                        convert_to_numpy_ret_vals=True)[:3]
            np.testing.assert_array_equal(tlabels, jlabels)
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
            np.testing.assert_allclose(tyv, jy, rtol=1e-5, atol=1e-5)
    # the train split advanced 6 batches, validate 3
    sub = texe.subexecutors["validate"]
    dl = sub.dataloader_ops[0].dataloaders["validate"]
    assert dl.batch_index == 3 % dl.batch_num


def test_batch_num_is_the_fewest_of_a_subgraphs_dataloaders():
    a = tht.dataloader_op([[np.zeros((40, 2)), 8, "train"],
                           [np.zeros((16, 2)), 8]])        # "default"
    b = tht.dataloader_op([[np.zeros((30, 2)), 8, "train"],
                           [np.zeros((24, 2)), 8]])
    exe = tht.Executor({"train": [tht.add_op(a, b)]}, ctx=tht.cpu(0))
    assert exe.get_batch_num("train") == 3
    single = tht.Executor([tht.add_op(a, b)], ctx=tht.cpu(0))
    assert single.batch_num == 2
    with pytest.raises(ValueError, match="single subgraph"):
        tht.Executor({"train": [a], "validate": [b]},
                     ctx=tht.cpu(0)).batch_num


def test_digits_equals_the_reference():
    for (tx, ty), (jx, jy) in zip(tht.data.digits(), jht.data.digits()):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for (tx, ty), (jx, jy) in zip(tht.data.digits(onehot=False),
                                  jht.data.digits(onehot=False)):
        np.testing.assert_array_equal(ty, jy)
    assert sum(len(x) for x, _ in tht.data.digits()) == 1797


def test_synthetic_cifar_stand_in_warns_and_equals_the_reference(
        monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    monkeypatch.delenv("HETU_REQUIRE_REAL_DATA", raising=False)
    got = tht.data.cifar10()
    assert "SYNTHETIC" in capsys.readouterr().err
    for t, j in zip(got, jht.data.cifar10()):
        np.testing.assert_array_equal(t, j)
    assert got[0].shape == (10000, 3, 32, 32) and got[1].shape == (10000, 10)
    for t, j in zip(tht.data.normalize_cifar(), jht.data.normalize_cifar()):
        np.testing.assert_array_equal(t, j)
    monkeypatch.setenv("HETU_REQUIRE_REAL_DATA", "1")
    with pytest.raises(FileNotFoundError):
        tht.data.cifar10()


def test_data_helpers_equal_the_reference():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 7, 30)
    np.testing.assert_array_equal(tht.data.convert_to_one_hot(labels),
                                  jht.data.convert_to_one_hot(labels))
    for t, j in zip(tht.data.synthetic(50, (2, 3, 3), 5, seed=3),
                    jht.data.synthetic(50, (2, 3, 3), 5, seed=3)):
        np.testing.assert_array_equal(t, j)
    images = rng.rand(6, 3, 8, 8).astype(np.float32)
    for kw in ({"crop_shape": (6, 6)}, {"mode": "test", "crop_shape": (4, 4)},
               {"flip": True, "whiten": True, "noise": True, "seed": 5}):
        np.testing.assert_array_equal(
            tht.data.data_augmentation(images.copy(), **kw),
            jht.data.data_augmentation(images.copy(), **kw))


def test_every_metric_equals_the_reference():
    rng = np.random.RandomState(1)
    scores = rng.rand(40, 4)
    onehot = np.eye(4)[rng.randint(0, 4, 40)]
    binary = rng.randint(0, 2, 40)
    prob = rng.rand(40)
    cases = [
        ("accuracy", (scores, onehot), {}),
        ("precision", (scores, onehot), {"cls": 2}),
        ("recall", (scores, onehot), {"cls": 1}),
        ("f1_score", (scores, onehot), {"cls": 3}),
        ("auc", (prob, binary), {}),
        ("confusion_matrix", (scores, onehot), {"num_classes": 4}),
        ("softmax", (scores,), {}),
        ("confusion_matrix_at_thresholds", (prob, binary, [0.2, 0.5, 0.9]),
         {}),
        ("auc_at_thresholds", (prob, binary), {"num_thresholds": 50}),
        ("auc_at_thresholds", (prob, binary), {"curve": "PR"}),
        ("confusion_matrix_one_hot", (scores, onehot), {}),
        ("precision_score", (scores, onehot), {"average": "macro"}),
        ("recall_score", (scores, onehot), {"average": "micro"}),
        ("f_score", (scores, onehot), {"beta": 2.0}),
    ]
    for name, args, kw in cases:
        got = getattr(tht.metrics, name)(*args, **kw)
        want = getattr(jht.metrics, name)(*args, **kw)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    counts = tht.metrics.confusion_matrix_at_thresholds(prob, binary,
                                                        [0.1, 0.6])
    np.testing.assert_array_equal(
        tht.metrics.roc_pr_curve(counts),
        jht.metrics.roc_pr_curve(counts))
    with pytest.raises(ValueError, match="binary"):
        tht.metrics.auc_at_thresholds(binary, prob)

    streams = [tht.metrics.StreamingAUC(50), jht.metrics.StreamingAUC(50)]
    matrices = [tht.metrics.ConfusionMatrix(4), jht.metrics.ConfusionMatrix(4)]
    for lo in range(0, 40, 10):
        for s in streams:
            s.update(prob[lo:lo + 10], binary[lo:lo + 10])
        for m in matrices:
            m.update(scores[lo:lo + 10], onehot[lo:lo + 10])
    assert streams[0].result() == streams[1].result()
    assert matrices[0].accuracy() == matrices[1].accuracy()
    np.testing.assert_array_equal(matrices[0].cm, matrices[1].cm)

"""The port's copy of the native tokenizer (``data/fasttok.py`` and
``data/_fasttok.c``) against its numpy flatten and against the
reference's ``fasttok.flatten``, on ``tests/test_fasttok.py``'s inputs,
and the vertical builds it feeds against the reference's."""

import numpy as np
import pytest

from spark_fsm_tpu.data import fasttok as JF
from spark_fsm_tpu.data import vertical as JV
from spark_fsm_tpu.data.synth import synthetic_db
from spark_fsm_tpu_torch.data import fasttok as TF
from spark_fsm_tpu_torch.data import vertical as TV

_VDB_FIELDS = ("item_ids", "seq_lengths", "item_supports", "tok_item",
               "tok_seq", "tok_word", "tok_mask")


@pytest.fixture(scope="module")
def native():
    # this box has gcc and Python.h: the copy must build here
    assert TF.backend() == "native", TF.reason()
    assert TF.reason() is None
    assert TF.library_path().exists()
    assert TF.library_path().parent.parts[-2:] == ("build", "host")


@pytest.mark.parametrize("kw", [
    dict(seed=5, n_sequences=300, n_items=20, mean_itemsets=4.0,
         mean_itemset_size=1.5),
    dict(seed=8, n_sequences=120, n_items=12, mean_itemsets=40.0,
         max_itemsets=80),
])
def test_flatten_parity(native, kw):
    db = synthetic_db(**kw)
    got = TF.flatten(db)
    for a, b, c in zip(got, TF.flatten_numpy(db), JF.flatten_numpy(db)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    ref = JF.flatten(db)
    if ref is not None:  # the reference's own build, when it has one
        for a, c in zip(got, ref):
            np.testing.assert_array_equal(a, c)


def test_flatten_accepts_lists_and_rejects_garbage(native):
    lengths, counts, items = TF.flatten([[[1, 2], [3]], [[2]]])
    assert lengths.tolist() == [2, 1]
    assert counts.tolist() == [2, 1, 1]
    assert items.tolist() == [1, 2, 3, 2]
    with pytest.raises(TypeError):
        TF.flatten([((1, "x"),)])


def test_tokenize_is_native_flatten(native):
    db = synthetic_db(seed=7, n_sequences=50, n_items=9, mean_itemsets=3.0)
    for a, b in zip(TF.tokenize(db), TF.flatten_numpy(db)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("minsup", [1, 2, 9])
def test_build_vertical_and_stats_equal_reference(native, minsup):
    db = synthetic_db(seed=7, n_sequences=200, n_items=15, mean_itemsets=3.0,
                      mean_itemset_size=1.4)
    got = TV.build_vertical(db, min_item_support=minsup)
    want = JV.build_vertical(db, min_item_support=minsup)
    for attr in _VDB_FIELDS:
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert (got.n_sequences, got.n_words) == (want.n_sequences, want.n_words)
    assert TV.dataset_stats(db, minsup) == TV.DatasetStats(
        **vars(JV.dataset_stats(db, minsup)))


def test_failed_build_falls_back_to_numpy(monkeypatch, tmp_path):
    """Without Python.h the build raises, the reason says why, and the
    vertical build takes the numpy flatten with the same bytes."""
    db = synthetic_db(seed=7, n_sequences=80, n_items=10, mean_itemsets=3.0)
    want = TV.build_vertical(db, min_item_support=2)
    monkeypatch.setattr(TF, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TF.sysconfig, "get_paths",
                        lambda: {"include": str(tmp_path / "missing")})
    TF._load.cache_clear()
    try:
        assert TF.backend() == "numpy"
        assert "Python.h" in TF.reason()
        assert TF.flatten(db) is None
        got = TV.build_vertical(db, min_item_support=2)
    finally:
        monkeypatch.undo()
        TF._load.cache_clear()
    for attr in _VDB_FIELDS:
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    assert TF.backend() == "native"

"""Lazy shard loading (``load_to_memory=False``) and the test split of
the port, against its eager loading and against the JAX package's lazy
dataset (JAX ``tests/test_data_lazy.py``). Small shapes on the CPU; every
comparison of arrays is bit for bit unless it says otherwise."""
from pathlib import Path

import numpy as np
import pytest

from neural_waveshaping_synthesis_tpu.data import GeneralDataModule as JGeneralDataModule
from neural_waveshaping_synthesis_tpu.data import GeneralDataset as JGeneralDataset
from neural_waveshaping_synthesis_tpu_torch import minigin as gin
from neural_waveshaping_synthesis_tpu_torch.data import GeneralDataModule, GeneralDataset, URMPDataModule

from test_torch_training import _write_shards

KEYS = ("audio", "f0", "control")
SPLITS = (("train", 6), ("val", 2), ("test", 5))


@pytest.fixture
def root(tmp_path):
    return _write_shards(tmp_path / "data", splits=SPLITS)


def _same(a, b):
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lazy_matches_eager(root):
    """JAX ``test_lazy_matches_eager`` for the port: no arrays in memory,
    the same length, batches and items."""
    eager = GeneralDataset(root, "train")
    lazy = GeneralDataset(root, "train", load_to_memory=False)
    assert lazy.audio is None and lazy.control is None and len(lazy) == len(eager) == 6
    idx = np.array([3, 0, 5])
    _same(eager.batch(idx), lazy.batch(idx))
    for key in KEYS + ("amp", "name"):
        np.testing.assert_array_equal(eager[2][key], lazy[2][key])


@pytest.mark.parametrize("split", ["train", "test"])
def test_lazy_batches_match_the_jax_lazy_dataset(root, split):
    """The port's lazy batches and items against JAX's
    GeneralDataset(load_to_memory=False)."""
    ours = GeneralDataset(root, split, load_to_memory=False)
    theirs = JGeneralDataset(root, split, load_to_memory=False)
    assert ours.names == theirs.names
    idx = np.array([4, 1, 0])
    _same(ours.batch(idx), theirs.batch(idx))
    for key in KEYS + ("amp", "name"):
        np.testing.assert_array_equal(ours[1][key], theirs[1][key])


@pytest.mark.parametrize("load_to_memory", [True, False], ids=["eager", "lazy"])
def test_test_batches_match_jax(root, load_to_memory):
    """test_batches: the test split in order, the short last batch dropped
    (5 clips at batch 2 -> 2 batches), as JAX's."""
    ours = list(GeneralDataModule(root, 2, load_to_memory).test_batches())
    theirs = list(JGeneralDataModule(root, 2, load_to_memory).test_batches())
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        _same(a, b)


def test_a_pass_resumed_mid_way_loads_only_what_it_yields(root, monkeypatch):
    """train_batches(seed, start=k) yields the pass's batches from the k-th
    on, the same as the whole pass's tail, and a lazy split loads only
    their clips."""
    data = GeneralDataModule(root, batch_size=2, load_to_memory=False)
    whole = list(data.train_batches((0, 2, 1)))
    ds = data.dataset("train")
    loaded = []
    real = ds._load
    monkeypatch.setattr(ds, "_load", lambda idx: loaded.append(len(idx)) or real(idx))
    tail = list(data.train_batches((0, 2, 1), start=2))
    assert data.n_batches("train") == 3 and len(tail) == 1 and loaded == [2]
    _same(whole[2], tail[0])


def test_urmp_datamodule_passes_load_to_memory_through(tmp_path):
    _write_shards(tmp_path / "vn", splits=SPLITS)
    dm = URMPDataModule(str(tmp_path), "vn", batch_size=2, load_to_memory=False)
    assert dm.load_to_memory is False and dm.dataset("train").audio is None
    assert URMPDataModule(str(tmp_path), "vn").dataset("val").audio is not None


def test_load_to_memory_binds_through_the_ports_minigin(root):
    gin.clear_config()
    try:
        gin.parse_config("GeneralDataModule.load_to_memory = False")
        assert gin.validate_config() == []
        assert GeneralDataModule(root).dataset("val").audio is None
    finally:
        gin.clear_config()


def test_a_test_split_leaves_the_tone_datasets_other_splits_as_they_were(tmp_path):
    """chip_smoke.write_tone_dataset draws the test split after train and
    val, so adding it leaves their files and the statistics byte for
    byte."""
    import chip_smoke

    kw = {"seconds": 0.25, "seed": 3}
    a = Path(chip_smoke.write_tone_dataset(tmp_path / "a", splits=(("train", 3), ("val", 2)), **kw))
    b = Path(chip_smoke.write_tone_dataset(
        tmp_path / "b", splits=(("train", 3), ("val", 2), ("test", 2)), **kw))
    files = sorted(p.relative_to(a) for p in a.rglob("*.npy"))
    assert len(files) == 12
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert len(list((b / "test" / "audio").iterdir())) == 2

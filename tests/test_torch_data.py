"""The port's data pipeline (data/, utils/csv_io.py, utils/stats.py) against
the JAX package's.

The window table, split, batch order and gather are integer and copy work:
equal bit for bit. load_data on synthetic capture folders: with a feature
cache the same float32 values (the cache written by either package read by
both), without one the port's device frontend within
tests/test_torch_frontend.py's bounds of the JAX frontend; the facial data
equal. The stats file's text is the JAX file's.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from neurosync_trainer_lite_tpu.data import processing as jproc
from neurosync_trainer_lite_tpu.data import windowing as jwin
from neurosync_trainer_lite_tpu.utils import csv_io as jcsv
from neurosync_trainer_lite_tpu.utils import stats as jstats
from neurosync_trainer_lite_tpu_torch.data import native as tnative
from neurosync_trainer_lite_tpu_torch.data import processing as tproc
from neurosync_trainer_lite_tpu_torch.data import windowing as twin
from neurosync_trainer_lite_tpu_torch.utils import csv_io as tcsv
from neurosync_trainer_lite_tpu_torch.utils import stats as tstats
from tests.test_data_pipeline import SR, make_capture_folder


def _clips(seed=0, lengths=(300, 64, 256, 517)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, 16)).astype(np.float32),
             rng.standard_normal((n + 3, 5)) * 100) for n in lengths]


def test_window_table_split_order_and_gather_equal_jax():
    clips = _clips()
    ours = twin.WindowedDataset(clips, window=128)
    theirs = jwin.WindowedDataset(clips, window=128)
    assert np.array_equal(ours.table, theirs.table)
    assert len(ours) == (300 - 127 + 1) + (256 - 127) + (517 - 127 + 1)
    for seed in (0, 7):
        (ot, ov), (jt, jv) = ours.split(0.1, seed), theirs.split(0.1, seed)
        assert np.array_equal(ot.idxs, jt.idxs)
        assert np.array_equal(ov.idxs, jv.idxs)
        for kw in (dict(shuffle=True, seed=seed + 3, drop_last=True),
                   dict(wrap=True)):
            a = list(ot.index_batches(32, **kw))
            b = list(jt.index_batches(32, **kw))
            assert len(a) == len(b) and all(map(np.array_equal, a, b))
            for (os_, ot_), (js, jt_) in zip(ot.batches(32, **kw),
                                            jt.batches(32, **kw)):
                assert os_.tobytes() == js.tobytes()
                assert ot_.tobytes() == jt_.tobytes()


def test_native_and_numpy_gathers_are_equal():
    ds = twin.WindowedDataset(_clips(1), window=64)
    assert tnative.load_library() is not None      # g++ builds it here
    assert ds._native_gather() is not None
    assert str(tnative.library_path()).startswith(
        str(tnative.BUILD_DIR))                    # never beside the source
    idxs = np.random.default_rng(2).integers(0, len(ds), 50)
    native = ds.gather(idxs)
    plain = twin.WindowedDataset(_clips(1), window=64)
    plain._native = None                           # the numpy gather
    numpy_ = plain.gather(idxs)
    for a, b in zip(native, numpy_):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
    # into pinned-shaped host tensors, as host_batches does
    out = (torch.empty(50, 64, 16), torch.empty(50, 64, 5))
    ds.gather(idxs, (out[0].numpy(), out[1].numpy()))
    assert out[0].numpy().tobytes() == native[0].tobytes()
    with pytest.raises(IndexError):
        ds.gather(np.array([len(ds)]))


def test_host_batches_and_prefetch_keep_the_order():
    ds = twin.WindowedDataset(_clips(3), window=64)
    train, _ = ds.split(0.1, 0)
    want = list(train.batches(16, shuffle=True, seed=4, drop_last=True))
    got = list(twin.prefetch(twin.host_batches(
        train, 16, pin_memory=False, shuffle=True, seed=4, drop_last=True)))
    assert len(got) == len(want)
    for (s, t), (ws, wt) in zip(got, want):
        assert s.dtype == torch.float32
        assert np.array_equal(s.numpy(), ws) and np.array_equal(t.numpy(), wt)
    src, trg = twin.to_device(got[0], torch.device("cpu"))
    assert src is got[0][0]


def test_prefetch_raises_the_producers_error():
    def bad():
        yield 1
        raise ValueError("boom")

    it = twin.prefetch(bad())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    rng = np.random.default_rng(0)
    make_capture_folder(str(root), "c1", seconds=2.5, rng=rng)
    make_capture_folder(str(root), "c2", seconds=2.0, rng=rng)
    os.makedirs(root / "empty_dir")
    return root


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _f32(clips):
    return [(np.asarray(a, np.float32), np.asarray(f, np.float32))
            for a, f in clips]


def test_load_data_equals_jax_with_and_without_cache(folders, tmp_path):
    jroot = _copy(folders, tmp_path / "jax")
    troot = _copy(folders, tmp_path / "port")
    theirs = _f32(jproc.load_data(jroot, SR))          # cache miss, JAX
    ours = _f32(tproc.load_data(troot, SR, device="cpu"))  # cache miss, port
    assert len(ours) == len(theirs) == 2
    for (oa, of), (ja, jf) in zip(ours, theirs):
        assert oa.shape == ja.shape and of.shape == jf.shape
        np.testing.assert_allclose(oa[:, :69], ja[:, :69], atol=5e-3)
        np.testing.assert_allclose(oa[:, 69:], ja[:, 69:], atol=1e-4)
        assert np.array_equal(of, jf)
    # cache hits, each package reading the other's cache: the same values
    for root in (jroot, troot):
        hit_ours = _f32(tproc.load_data(root, SR, device="cpu"))
        hit_theirs = _f32(jproc.load_data(root, SR))
        for (oa, of), (ja, jf) in zip(hit_ours, hit_theirs):
            assert np.array_equal(oa, ja) and np.array_equal(of, jf)
    # the port's cache holds the features it extracted, float32 for float32
    feats, _ = tproc.extract_audio_features(
        os.path.join(troot, "c1", "audio.wav"), SR, device="cpu")
    cached = tproc.read_feature_cache(os.path.join(troot, "c1",
                                                   "audio_features.csv"))
    assert np.array_equal(cached.astype(np.float32), feats)


def test_feature_cache_round_trips_through_pandas(tmp_path):
    feats = (np.random.default_rng(5).standard_normal((40, 256))
             * np.logspace(-8, 4, 256)).astype(np.float32)
    ours = tmp_path / "ours.csv"
    tproc.write_feature_cache(str(ours), feats)
    frame = pd.read_csv(ours)
    assert list(frame.columns) == [str(i) for i in range(256)]
    assert np.array_equal(frame.values.astype(np.float32), feats)
    theirs = tmp_path / "theirs.csv"
    pd.DataFrame(feats).to_csv(theirs, index=False)
    assert ours.read_bytes() == theirs.read_bytes()
    assert np.array_equal(
        tproc.read_feature_cache(str(theirs)).astype(np.float32), feats)


def test_facial_csv_drops_the_named_columns(tmp_path):
    folder, blend = make_capture_folder(str(tmp_path), "f1", seconds=1.0)
    path = os.path.join(folder, "f1_iPhone_cal.csv")
    ours = tproc.read_facial_csv(path)
    theirs = pd.read_csv(path).drop(columns=jproc.COLUMNS_TO_DROP).values
    assert ours.shape == theirs.shape == blend.shape
    assert np.array_equal(ours.astype(np.float32), theirs.astype(np.float32))


def test_processing_helpers_equal_jax():
    rng = np.random.default_rng(6)
    seqs = [rng.random((50, 3)), rng.random((25, 3)), rng.random((7, 3))]
    assert np.array_equal(tproc.stack_with_blend(seqs, 30),
                          jproc.stack_with_blend(seqs, 30))
    x = rng.random((9, 61)) * 2 - 0.5
    for name in ("interpolate_slower", "smooth_facial_data",
                 "scale_facial_data", "remove_specified_dimensions",
                 "zero_specified_columns"):
        assert np.array_equal(getattr(tproc, name)(x.copy()),
                              getattr(jproc, name)(x.copy())), name


def test_stats_file_text_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    truth = rng.random((90, 61))
    gen = truth[:80] + rng.standard_normal((80, 61)) * 0.05
    gen[:, 3] = 0.2                                  # a constant column
    jcsv.save_generated_data_as_csv(truth, str(tmp_path / "truth.csv"))
    tcsv.save_generated_data_as_csv(gen, str(tmp_path / "gen.csv"))
    tstats.save_comparison_stats(str(tmp_path / "gen.csv"),
                                 str(tmp_path / "truth.csv"),
                                 str(tmp_path / "ours.txt"))
    jstats.save_comparison_stats(str(tmp_path / "gen.csv"),
                                 str(tmp_path / "truth.csv"),
                                 str(tmp_path / "theirs.txt"))
    assert (tmp_path / "ours.txt").read_text() == \
        (tmp_path / "theirs.txt").read_text()


def test_split_csv_by_frames_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    jcsv.save_generated_data_as_csv(rng.random((10, 61)),
                                    str(tmp_path / "cap.csv"))
    ours = tcsv.split_csv_by_frames(str(tmp_path / "cap.csv"),
                                    str(tmp_path / "o"), 4)
    theirs = jcsv.split_csv_by_frames(str(tmp_path / "cap.csv"),
                                      str(tmp_path / "j"), 4)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        fa, fb = pd.read_csv(a), pd.read_csv(b)
        assert list(fa.columns) == list(fb.columns)
        assert np.array_equal(fa.values[:, 2:].astype(float),
                              fb.values[:, 2:].astype(float))


def test_pad_data_zero_pads_the_shorter():
    a, b = tcsv.pad_data(np.ones((3, 2)), np.ones((5, 2)))
    assert a.shape == b.shape == (5, 2) and a[3:].sum() == 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_livelink_csv_bytes_equal_jax(tmp_path, dtype):
    """save_generated_data_as_csv writes the JAX writer's bytes (pandas'
    to_csv): each value in its dtype's shortest repr, '\\n' line ends."""
    data = (np.random.default_rng(4).uniform(0, 1, (40, 61))
            * np.logspace(-9, 6, 61)).astype(dtype)
    jcsv.save_generated_data_as_csv(data, str(tmp_path / "jax.csv"))
    tcsv.save_generated_data_as_csv(data, str(tmp_path / "torch.csv"))
    assert (tmp_path / "torch.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()

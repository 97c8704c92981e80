"""The port's observability tools against the JAX package's: the epoch-stats
parser and plotters (utils/epoch_stats.py), StepTimer and profile_trace
(utils/profiling.py), the training CLI's --profile, and playback without
pygame (utils/audio_io.py).

Stats files are written by the port's own writer (utils/stats.py); the
JAX parser reads the same directory, and the two histories must be equal,
NaN positions included. StepTimer runs on a patched clock fed the same
sequence to both packages' timers: equal summaries, exactly.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from neurosync_trainer_lite_tpu.utils import audio_io as jaudio
from neurosync_trainer_lite_tpu.utils import epoch_stats as jstats
from neurosync_trainer_lite_tpu.utils import profiling as jprof
from neurosync_trainer_lite_tpu_torch.utils import audio_io
from neurosync_trainer_lite_tpu_torch.utils import epoch_stats as tstats
from neurosync_trainer_lite_tpu_torch.utils import profiling as tprof
from neurosync_trainer_lite_tpu_torch.utils.csv_io import (
    DIMENSION_LABELS,
    save_generated_data_as_csv,
)
from neurosync_trainer_lite_tpu_torch.utils.stats import save_comparison_stats
from tests.test_data_pipeline import make_capture_folder

REPO = Path(__file__).resolve().parent.parent


def _write_stats_epoch(stats_dir: str, epoch: int, scale: float) -> None:
    """One epoch's stats file through the port's writer (CSV → stats txt)."""
    rng = np.random.default_rng(epoch)
    gt = rng.uniform(0, 1, (50, len(DIMENSION_LABELS)))
    gen = gt + scale * rng.standard_normal(gt.shape)
    gen_path = os.path.join(stats_dir, f"gen_{epoch}.csv")
    gt_path = os.path.join(stats_dir, "gt.csv")
    save_generated_data_as_csv(gen, gen_path)
    save_generated_data_as_csv(gt, gt_path)
    save_comparison_stats(gen_path, gt_path, os.path.join(
        stats_dir, f"comparison_stats_epoch_{epoch}.txt"))


@pytest.fixture(params=["every metric", "a metric missing in epoch 1"])
def stats_dir(tmp_path, request):
    tmp = str(tmp_path)
    for epoch, scale in ((1, 0.3), (2, 0.2), (3, 0.1)):
        _write_stats_epoch(tmp, epoch, scale)
    if request.param != "every metric":
        # as tests/test_cli_and_stats.py:266: epoch 1 without its r
        p1 = os.path.join(tmp, "comparison_stats_epoch_1.txt")
        with open(p1) as f:
            lines = [ln for ln in f
                     if not ln.startswith("Correlation Coefficient (r)")]
        with open(p1, "w") as f:
            f.writelines(lines)
    return tmp


def test_load_stats_history_equals_jax(stats_dir, request):
    ours, theirs = (tstats.load_stats_history(stats_dir),
                    jstats.load_stats_history(stats_dir))
    assert ours[0] == theirs[0] == [1, 2, 3]
    for o, t in ((ours[1], theirs[1]),
                 *((ours[2][d], theirs[2][d]) for d in theirs[2])):
        assert o.keys() == t.keys()
        for key in t:
            # equal values, NaN where JAX has NaN
            np.testing.assert_array_equal(o[key], t[key], err_msg=key)
    assert ours[2].keys() == theirs[2].keys()
    assert len(ours[2]) == 61
    assert tstats.find_stats_files(stats_dir) == jstats.find_stats_files(
        stats_dir)
    # the missing metric is a gap at its epoch; the rest stay dense
    r = ours[1]["Correlation Coefficient (r)"]
    missing = "missing" in request.node.callspec.id
    assert [bool(np.isnan(x)) for x in r] == [missing, False, False]
    mae = ours[1]["Mean Absolute Error (MAE)"]
    assert mae[0] > mae[1] > mae[2]


def test_plots_are_written(stats_dir):
    p1 = tstats.plot_overall_stats(stats_dir)
    p2 = tstats.plot_dimension_stats(stats_dir, "MAE")
    assert os.path.exists(p1) and os.path.exists(p2)
    assert os.path.basename(p1) == "overall_stats.png"
    with pytest.raises(ValueError):
        tstats.plot_dimension_stats(stats_dir, "NotAMetric")


def test_plots_raise_without_matplotlib(stats_dir, monkeypatch):
    """A plot is the caller's request: without matplotlib it raises (the
    parser still works), where the loop's own plots are skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for plot in (tstats.plot_overall_stats,
                 lambda d: tstats.plot_dimension_stats(d, "RMSE")):
        with pytest.raises(ImportError, match="needs matplotlib"):
            plot(stats_dir)
    assert tstats.load_stats_history(stats_dir)[0] == [1, 2, 3]


def test_step_timer_matches_jax(monkeypatch):
    """11 steps at sync_every=5 on one clock sequence: the first call only
    opens the window, so 10 steps are recorded, and the summaries are
    equal. The port's timer reads its sync value with .item()."""
    rng = np.random.default_rng(0)
    clock = np.cumsum(rng.uniform(0.05, 0.4, 64)).tolist()
    summaries = []
    for timer_cls, value in ((jprof.StepTimer, 1.0),
                             (tprof.StepTimer, torch.tensor(1.0))):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = timer_cls(sync_every=5)
        assert timer.summary() == {"steps": 0}
        for _ in range(11):
            timer.step(value)
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[1]["steps"] == 10
    assert set(summaries[1]) == {"steps", "mean_ms", "p50_ms", "p95_ms",
                                 "steps_per_sec"}


def test_step_timer_without_a_sync_value_records_nothing():
    timer = tprof.StepTimer(sync_every=2)
    for _ in range(5):
        timer.step()
    assert timer.summary() == {"steps": 0}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.profile_trace(str(tmp_path / "trace")) as prof:
        torch.mm(x, x)
    path = tmp_path / "trace" / tprof.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_profile_trace_writes_the_trace_when_the_body_raises(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with tprof.profile_trace(str(tmp_path)):
            torch.ones(4).sum()
            raise RuntimeError("boom")
    assert (tmp_path / tprof.TRACE_FILE).exists()


def test_train_cli_profile_writes_trace_json(tmp_path):
    """python -m neurosync_trainer_lite_tpu_torch.train --tiny --device cpu
    --profile DIR: one epoch under profile_trace, DIR/trace.json written."""
    data = tmp_path / "data"
    make_capture_folder(str(data), "clip", seconds=2.5)
    out = tmp_path / "out"
    flags = ["--tiny", "--device", "cpu", "--root_dir", str(data),
             "--micro_batch_size", "32", "--batch_size", "4",
             "--n_epochs", "3", "--max_steps_per_epoch", "2",
             "--model_path", str(out / "model.pth"),
             "--checkpoint_path", str(out / "ck" / "checkpoint"),
             "--plots_dir", str(out / "plots"),
             "--audio_path", str(tmp_path / "absent.wav"),
             "--profile", str(tmp_path / "prof")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
         *flags], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists() and f"profiler trace written to {trace}" in \
        proc.stdout
    assert "traceEvents" in json.loads(trace.read_text())
    assert proc.stdout.count("max_steps_per_epoch=2 reached") == 1


@pytest.mark.parametrize("play", ["play_audio_bytes",
                                  "play_audio_from_memory",
                                  "play_audio_from_path"])
def test_playback_without_pygame_prints_once(play, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "pygame", None)
    source = (audio_io.audio_to_bytes(np.zeros(100), 88200)
              if play != "play_audio_from_path" else "absent.wav")
    assert getattr(audio_io, play)(source) is None
    out = capsys.readouterr().out
    assert out == f"{play}: pygame not installed; skipping playback\n"


def test_load_audio_file_from_memory_matches_jax(capsys):
    wav = audio_io.audio_to_bytes(np.sin(np.arange(4410) * 0.05), 44100)
    theirs, their_sr = jaudio.load_audio_file_from_memory(wav, 88200)
    capsys.readouterr()
    y, sr = audio_io.load_audio_file_from_memory(wav, 88200)
    assert sr == their_sr == 88200
    np.testing.assert_array_equal(y, theirs)
    assert capsys.readouterr().out == \
        "Loaded audio data with sample rate 88200\n"

"""The port's training loop and CLI under data parallelism: train_model on
2 CPU ranks over gloo against the port at dp = 1, and the multi-process
flags of `python -m neurosync_trainer_lite_tpu_torch.train`.

This file doubles as its worker (`python tests/test_torch_parallel_loop.py
worker SPEC RANK`), spawned by tests/test_torch_parallel.py:spawn with a
timeout; the process group's own timeout bounds a hang.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from neurosync_trainer_lite_tpu_torch.config import Config  # noqa: E402
from neurosync_trainer_lite_tpu_torch.parallel import (  # noqa: E402
    distributed,
)
from tests.test_torch_parallel import (  # noqa: E402
    GEOM,
    GROUP_TIMEOUT,
    SPAWN_TIMEOUT,
    clips,
    results,
    spawn,
)

#: dropout on and two micro-batches: the rows interleave and each rank's
#: masks are its rows of the global ones
LOOP = dict(GEOM, dropout=0.3, grad_accum_steps=2, n_epochs=2,
            validation_interval=4)


def run_loop(out: Path, rank_dir: Path, init: dict) -> dict:
    """train_model for one epoch, then a resume for the second: the
    history of both. The checkpoint is shared by the ranks; model.pth and
    the plots go under rank_dir."""
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model

    cfg = Config(**LOOP).replace(
        n_epochs=1, checkpoint_path=str(out / "ck" / "checkpoint"),
        model_path=str(rank_dir / "model.pth"),
        plots_dir=str(rank_dir / "plots"),
        audio_path=str(out / "absent.wav"))
    history = {}
    _, first = train_model(cfg, clips(cfg), verbose=False, device="cpu",
                           init_state_dict=init, history_out=history)
    _, steps = train_model(cfg.replace(mode="resume", n_epochs=2), clips(cfg),
                           verbose=False, device="cpu", history_out=history)
    return {"first": first, "steps": steps,
            **{k: np.asarray(v) for k, v in history.items()}}


def worker(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init = {k: torch.from_numpy(v) for k, v in np.load(spec["init"]).items()}
    distributed.initialize_distributed(
        init_method=f"file://{spec['store']}", num_processes=spec["world"],
        process_id=rank, device="cpu", timeout_s=GROUP_TIMEOUT)
    try:
        out = Path(spec["out"])
        np.savez(out / f"loop_r{rank}.npz",
                 **run_loop(out, out / f"r{rank}", init))
    finally:
        distributed.destroy()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_train_model_dp2_equals_dp1(tmp_path):
    """train_model at dp = 2 (one epoch, a checkpoint, a resume for the
    second) against the port at dp = 1 from the same weights: every train
    loss, validation loss and grad norm within 1e-5 relative (sums in
    another order), the same on both ranks bit for bit; rank 0 alone
    writes model.pth and the plots, and the shared checkpoint rotated
    once."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    cfg = Config(**LOOP)
    init = init_seq2seq(cfg, torch.Generator().manual_seed(2),
                        "cpu").state_dict()
    spawn(Path(__file__), tmp_path / "dp2", 2, [], init)
    ranks = results(tmp_path / "dp2", "loop", 2)
    want = run_loop(tmp_path / "dp1", tmp_path / "dp1" / "r0", init)

    for key in ("train_losses", "val_losses", "grad_norms", "first",
                "steps", "epoch_samples"):
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key],
                                      err_msg=key)
    assert int(ranks[0]["steps"]) == int(want["steps"]) \
        == 2 * int(want["first"]) > 4
    for key in ("train_losses", "val_losses", "grad_norms"):
        assert len(want[key]) > 0
        np.testing.assert_allclose(ranks[0][key], want[key], rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_array_equal(ranks[0]["epoch_samples"],
                                  want["epoch_samples"])

    out = tmp_path / "dp2"
    assert (out / "r0" / "model.pth").exists()
    assert (out / "r0" / "plots").is_dir()
    assert not (out / "r1").exists()
    assert (out / "ck" / "checkpoint" / "meta.json").exists()
    assert len([d for d in os.listdir(out / "ck")
                if d.startswith("backup_")]) == 1


def test_cli_refuses_rank_flags_without_a_coordinator():
    """As tests/test_multihost.py:103-110: rank flags without --coordinator,
    or beside --distributed, refuse to run single-process."""
    from neurosync_trainer_lite_tpu_torch.train import main

    with pytest.raises(SystemExit, match="coordinator"):
        main(["--num_processes", "2"])
    with pytest.raises(SystemExit, match="auto-detection"):
        main(["--distributed", "--process_id", "0"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_trains_the_tiny_model_on_two_ranks(tmp_path):
    """python -m neurosync_trainer_lite_tpu_torch.train --coordinator
    HOST:PORT --num_processes 2 --process_id I, twice, on a synthetic
    capture: both exit 0 and print their rank; model.pth and the
    checkpoint are written."""
    from tests.test_data_pipeline import make_capture_folder

    data = tmp_path / "data"
    make_capture_folder(str(data), "clip", seconds=2.5)
    out = tmp_path / "out"
    flags = ["--tiny", "--device", "cpu", "--root_dir", str(data),
             "--micro_batch_size", "32", "--batch_size", "4",
             "--n_epochs", "1", "--max_steps_per_epoch", "2",
             "--model_path", str(out / "model.pth"),
             "--checkpoint_path", str(out / "ck" / "checkpoint"),
             "--plots_dir", str(out / "plots"),
             "--audio_path", str(tmp_path / "absent.wav"),
             "--coordinator", f"127.0.0.1:{_free_port()}",
             "--num_processes", "2"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
         *flags, "--process_id", str(r)], cwd=tmp_path, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        assert f"distributed: process {r}/2, device cpu" in log
    assert (out / "model.pth").exists()
    assert (out / "ck" / "checkpoint" / "meta.json").exists()


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_parallel_loop.py worker SPEC RANK")
    worker(sys.argv[2], int(sys.argv[3]))

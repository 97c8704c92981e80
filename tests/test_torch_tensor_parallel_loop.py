"""The port's tensor parallelism end to end: train_model at tp = 2 against
the port at tp = 1, the 'pallas' step at tp = 2 against the JAX mesh step
at 'pallas', and `python -m neurosync_trainer_lite_tpu_torch.train --tp 2`
on two ranks.

This file doubles as its worker (`python tests/test_torch_tensor_parallel_
loop.py worker SPEC RANK`), spawned by tests/test_torch_parallel.py:spawn
with a timeout; the process group's own timeout bounds a hang.
"""

import json
import os
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
    make_mesh,
)
from tests.test_torch_parallel import (  # noqa: E402
    GEOM,
    GROUP_TIMEOUT,
    SPAWN_TIMEOUT,
    batch,
    clips,
    port_steps,
    results,
    spawn,
)
from tests.test_torch_parallel_loop import LOOP, _free_port  # noqa: E402


def run_loop(out: Path, rank_dir: Path, init: dict, tp: int) -> dict:
    """train_model at `tp` for one epoch, then a resume for the second:
    the history of both, and the final parameters gathered to rank 0."""
    from neurosync_trainer_lite_tpu_torch.training.loop import train_model

    cfg = Config(**LOOP).replace(
        tp=tp, n_epochs=1, checkpoint_path=str(out / "ck" / "checkpoint"),
        model_path=str(rank_dir / "model.pth"),
        plots_dir=str(rank_dir / "plots"),
        audio_path=str(out / "absent.wav"))
    history = {}
    _, first = train_model(cfg, clips(cfg), verbose=False, device="cpu",
                           init_state_dict=init, history_out=history)
    state, steps = train_model(cfg.replace(mode="resume", n_epochs=2),
                               clips(cfg), verbose=False, device="cpu",
                               history_out=history)
    full = distributed.gather_state_dict(state.model, state.model.mesh)
    return {"first": first, "steps": steps,
            **{k: np.asarray(v) for k, v in history.items()},
            **({} if full is None else
               {f"g:{k}": v.numpy() for k, v in full["model"].items()})}


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
        if spec["part"] == "loop":
            res = run_loop(out, out / f"r{rank}", init, tp=2)
        else:                                   # the 'pallas' steps
            cfg = Config(**GEOM, attention_impl="pallas", dp=spec["dp"],
                         tp=2)
            src, trg = batch(3, cfg.batch_size, cfg)
            losses, norms, _, _ = port_steps(cfg, init, src, trg,
                                             mesh=make_mesh(cfg))
            res = {"losses": losses, "norms": norms}
        np.savez(out / f"{spec['part']}_r{rank}.npz", **res)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_train_model_tp2_equals_tp1(tmp_path):
    """train_model at tp = 2, dropout 0.3 and two micro-batches (one epoch,
    a checkpoint gathered to rank 0, a resume for the second) against the
    port at tp = 1 from the same weights: every train loss, validation
    loss and grad norm within 1e-5 relative (sums in another order), the
    same on both ranks bit for bit; rank 0 alone writes model.pth and the
    plots, and its model.pth equals the parameters gathered at the end."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq

    cfg = Config(**LOOP)
    init = init_seq2seq(cfg, torch.Generator().manual_seed(2),
                        "cpu").state_dict()
    spawn(Path(__file__), tmp_path / "tp2", 2, [], init,
          extra={"part": "loop"})
    ranks = results(tmp_path / "tp2", "loop", 2)
    want = run_loop(tmp_path / "tp1", tmp_path / "tp1" / "r0", init, tp=1)

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

    out = tmp_path / "tp2"
    assert (out / "r0" / "plots").is_dir()
    assert not (out / "r1").exists()
    assert (out / "ck" / "checkpoint" / "meta.json").exists()
    exported = torch.load(out / "r0" / "model.pth", weights_only=True)
    assert list(exported) == list(init)
    for key, value in exported.items():
        np.testing.assert_array_equal(value.numpy(), ranks[0][f"g:{key}"],
                                      err_msg=key)
    assert not any(k.startswith("g:") for k in ranks[1])


@pytest.fixture(scope="module")
def jax_pallas():
    """JAX's seeded init, the port's state dict of it, and 3 JAX mesh steps
    at 'pallas' on a (1, 2) mesh (its Pallas kernels in interpret mode)."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)
    from tests.test_torch_tensor_parallel import jax_mesh_steps

    jparams = jax.tree.map(np.asarray, init_seq2seq(jax.random.PRNGKey(1),
                                                    JConfig(**GEOM)))
    src, trg = batch(3, GEOM["batch_size"], Config(**GEOM))
    losses, norms, _ = jax_mesh_steps({"attention_impl": "pallas"}, 1, 2,
                                      jparams, src, trg)
    return params_from_jax(jparams, Config(**GEOM)), losses, norms


@pytest.mark.parametrize("dp", [1, 2])
def test_pallas_steps_match_the_jax_pallas_mesh_step(tmp_path, jax_pallas,
                                                     dp):
    """3 steps at 'pallas', dropout 0 (the fused attention's plain version,
    2 heads a rank) at (dp, tp) = (1, 2) and (2, 2) against the JAX mesh
    step at 'pallas': loss and pre-clip grad norm within 1e-5 relative
    (tests/test_training.py:105-135's bound); the ranks bitwise equal."""
    init, losses, norms = jax_pallas
    spawn(Path(__file__), tmp_path, 2 * dp, [], init,
          extra={"part": "pallas", "dp": dp})
    per_rank = results(tmp_path, "pallas", 2 * dp)
    for res in per_rank[1:]:
        np.testing.assert_array_equal(res["losses"], per_rank[0]["losses"])
        np.testing.assert_array_equal(res["norms"], per_rank[0]["norms"])
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-5)


def test_cli_trains_at_tp2_on_two_ranks(tmp_path):
    """python -m neurosync_trainer_lite_tpu_torch.train --tp 2 --coordinator
    HOST:PORT --num_processes 2 --process_id I, twice, on a synthetic
    capture: both exit 0 and print their rank and a mesh of one 'data'
    rank and two 'model' ranks; model.pth and the checkpoint are written;
    a world that is not dp · tp refuses to run."""
    from tests.test_data_pipeline import make_capture_folder

    data = tmp_path / "data"
    make_capture_folder(str(data), "clip", seconds=2.5)
    out = tmp_path / "out"
    flags = ["--tiny", "--device", "cpu", "--root_dir", str(data),
             "--micro_batch_size", "32", "--batch_size", "4", "--tp", "2",
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
        assert ("Rank mesh: {'data': 1, 'model': 2}, data index 0, model "
                f"index {r}") in log
    assert (out / "model.pth").exists()
    assert (out / "ck" / "checkpoint" / "meta.json").exists()

    bad = [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
           *flags[:flags.index("--coordinator")], "--dp", "2",
           "--coordinator", f"127.0.0.1:{_free_port()}",
           "--num_processes", "1", "--process_id", "0"]
    run = subprocess.run(bad, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=SPAWN_TIMEOUT)
    assert run.returncode != 0
    assert "mesh 2x2 needs 4 devices, have 1" in run.stdout + run.stderr


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_tensor_parallel_loop.py worker SPEC RANK")
    worker(sys.argv[2], int(sys.argv[3]))

"""The port's data parallelism (parallel/, the DP train step, shard-only
batches, collective checkpoints, MeshDecoder) against the JAX package.

The JAX package runs its mesh in this process, on the 8 virtual CPU devices
of tests/conftest.py. The port runs one process a rank: this file doubles
as its worker (`python tests/test_torch_parallel.py worker SPEC RANK`),
2 or 4 CPU ranks over gloo through a file:// store in tmp_path, each
writing .npz results that the tests hold against JAX, against the port at
dp = 1 (run here, without a process group) and against each other. Every
spawn has a timeout, and the process group's own timeout bounds a hang.

Geometry: tests/fixtures/reference_tiny's (hidden 64, 2+2 layers, 4
heads), fp32, windows of 16 frames, batch 8 (16 with accumulation).
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from neurosync_trainer_lite_tpu_torch.config import Config  # noqa: E402
from neurosync_trainer_lite_tpu_torch.parallel import (  # noqa: E402
    batch_rows,
    distributed,
    make_mesh,
)

GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, dropout=0.0, use_amp=False, batch_size=8,
            micro_batch_size=16, learning_rate=1e-3, n_epochs=10,
            frame_size=32, overlap=8)
STEPS = 3
SPAWN_TIMEOUT = 180          # seconds for a whole multi-process run
GROUP_TIMEOUT = 60           # seconds a collective may wait


def batch(seed: int, b: int, cfg) -> tuple[np.ndarray, np.ndarray]:
    """Seeded features and [0, 1) targets, as tests/test_training.py:110."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, cfg.micro_batch_size, cfg.input_dim))
    trg = rng.uniform(0, 1, (b, cfg.micro_batch_size, cfg.output_dim))
    return src.astype(np.float32), trg.astype(np.float32)


def clips(cfg) -> list:
    rng = np.random.default_rng(7)
    return [(rng.standard_normal((n, cfg.input_dim)).astype(np.float32),
             rng.standard_normal((n, cfg.output_dim)).astype(np.float32))
            for n in (50, 37)]


def port_steps(cfg, init: dict, src, trg, *, mesh=None, steps=STEPS):
    """`steps` port steps from `init` on this rank's rows of (src, trg):
    (losses, grad norms, final state dict, state)."""
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    state = init_train_state(cfg, 10, device="cpu", state_dict=init,
                             mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    rows = batch_rows(mesh, len(src), cfg.grad_accum_steps)
    s, t = torch.from_numpy(src[rows]), torch.from_numpy(trg[rows])
    losses, norms = [], []
    for i in range(steps):
        state, loss, norm = step(state, s, t, torch.Generator().manual_seed(
            100 + i))
        # the loop keeps an epoch's losses: each must hold its own 4 bytes
        assert loss.untyped_storage().nbytes() == 4
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, state.model.state_dict(), state


# ---------------------------------------------------------------------------
# the worker: one rank


def _case_steps(case, rank, spec, init, mesh):
    cfg = Config(**{**GEOM, **case["cfg"]})
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    losses, norms, sd, _ = port_steps(cfg, init, src, trg, mesh=mesh)
    return {"losses": losses, "norms": norms,
            **{f"p:{k}": v.numpy() for k, v in sd.items()}}


def _case_batch(case, rank, spec, init, mesh):
    """One shuffled batch through host_batches: the window table's CRC and
    the rows this rank gathered (every gather call recorded)."""
    from neurosync_trainer_lite_tpu_torch.data.windowing import (
        WindowedDataset, host_batches)

    cfg = Config(**GEOM)
    ds = WindowedDataset(clips(cfg), window=cfg.micro_batch_size)
    train, _ = ds.split(0.1, 0)
    gathered = []
    plain_gather = ds.gather

    def gather(idxs, out=None):
        gathered.append(np.asarray(idxs).copy())
        return plain_gather(idxs, out)

    ds.gather = gather
    out = {"table_crc": zlib.crc32(np.ascontiguousarray(ds.table).tobytes())}
    for accum in (1, 2):
        gathered.clear()
        src, trg = next(host_batches(
            train, case["batch_size"], pin_memory=False, mesh=mesh,
            accum=accum, shuffle=True, seed=3, drop_last=True))
        out[f"src{accum}"], out[f"trg{accum}"] = src.numpy(), trg.numpy()
        out[f"gathered{accum}"] = np.concatenate(gathered)
    return out


def _case_ckpt(case, rank, spec, init, mesh):
    """A collective save and restore, sync and async, the step after it,
    and a planted export failure on rank 0 that must raise on every rank."""
    from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt
    from neurosync_trainer_lite_tpu_torch.training.step import (
        make_train_step)

    cfg = Config(**GEOM)
    src, trg = batch(5, cfg.batch_size, cfg)
    _, _, _, state = port_steps(cfg, init, src, trg, mesh=mesh, steps=2)
    rows = batch_rows(mesh, cfg.batch_size)
    s, t = torch.from_numpy(src[rows]), torch.from_numpy(trg[rows])
    step = make_train_step(cfg, mesh=mesh)
    out = {}
    for mode in ("sync", "async"):
        path = os.path.join(spec["out"], f"ck_{mode}", "checkpoint")
        ckpt.save_checkpoint(state, 2, 3, cfg, path,
                             async_save=mode == "async")
        ckpt.wait_for_pending_saves()
        epoch, bstep, back = ckpt.load_checkpoint(path, cfg, 10,
                                                  device="cpu", mesh=mesh)
        same = (epoch, bstep) == (2, 3) and all(
            torch.equal(a, b) for a, b in zip(
                state.model.state_dict().values(),
                back.model.state_dict().values()))
        for key, a in state.optimizer.state_dict()["state"].items():
            b = back.optimizer.state_dict()["state"][key]
            same = same and all(torch.equal(a[k], b[k]) for k in a)
        _, loss, _ = step(back, s, t, torch.Generator().manual_seed(9))
        out[f"{mode}_equal"] = same
        out[f"{mode}_next_loss"] = float(loss)
    _, loss, _ = step(state, s, t, torch.Generator().manual_seed(9))
    out["continued_loss"] = float(loss)

    if rank == 0:
        plain_write = ckpt._write_atomic

        def planted(obj, path):
            if path.endswith("model.pth"):
                raise OSError("planted export failure")
            plain_write(obj, path)

        ckpt._write_atomic = planted
        ckpt.save_final_model(state.model, cfg,
                              os.path.join(spec["out"], "model.pth"),
                              async_save=True)
        ckpt._write_atomic = plain_write
    try:
        ckpt.wait_for_pending_saves()
        out["raised"] = ""
    except RuntimeError as e:
        out["raised"] = str(e)

    # rank 0's synchronous work planted to fail: the rotation, then the
    # state write; each must raise on every rank at its fence
    path = os.path.join(spec["out"], "ck_sync", "checkpoint")
    for name in ("_rotate_backups", "_write_atomic"):
        plain = getattr(ckpt, name)

        def planted(*args, name=name):
            raise OSError(f"planted {name} failure")

        if rank == 0:
            setattr(ckpt, name, planted)
        try:
            ckpt.save_checkpoint(state, 3, 4, cfg, path)
            out[f"raised{name}"] = ""
        except RuntimeError as e:
            out[f"raised{name}"] = str(e)
        setattr(ckpt, name, plain)
    return out


def _case_decode(case, rank, spec, init, mesh):
    from neurosync_trainer_lite_tpu_torch.inference.chunked import (
        MeshDecoder, process_audio_features)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    cfg = Config(**GEOM)
    model = Seq2Seq(cfg, "cpu")
    model.load_state_dict(init, strict=True)
    model.eval()
    arrays = np.load(os.path.join(spec["out"], "decode_in.npz"))
    dec = MeshDecoder(model, cfg, mesh)
    return {"chunks": dec(model, arrays["chunks"], cfg),
            "frames": process_audio_features(arrays["feats"], model, cfg,
                                             decode_batched=dec)}


CASES = {"steps": _case_steps, "batch": _case_batch, "ckpt": _case_ckpt,
         "decode": _case_decode}


def worker(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init = {k: torch.from_numpy(v) for k, v in np.load(spec["init"]).items()}
    distributed.initialize_distributed(
        init_method=f"file://{spec['store']}", num_processes=spec["world"],
        process_id=rank, device="cpu", timeout_s=GROUP_TIMEOUT)
    try:
        mesh = make_mesh(Config(**GEOM))
        for case in spec["cases"]:
            out = CASES[case["kind"]](case, rank, spec, init, mesh)
            np.savez(os.path.join(spec["out"], f"{case['name']}_r{rank}.npz"),
                     **out)
    finally:
        distributed.destroy()


# ---------------------------------------------------------------------------
# the parent: spawn, then compare


def spawn(script: Path, out: Path, world: int, cases: list, init: dict,
          extra: dict | None = None) -> None:
    """Run `world` ranks of `script`'s worker on `cases`; fail (after
    killing every rank) unless all exit 0 within SPAWN_TIMEOUT."""
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "init.npz", **{k: v.numpy() for k, v in init.items()})
    spec = {"world": world, "store": str(out / "store"), "out": str(out),
            "init": str(out / "init.npz"), "cases": cases, **(extra or {})}
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), "worker", str(spec_path), str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
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
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"


def results(out: Path, name: str, world: int) -> list[dict]:
    return [dict(np.load(out / f"{name}_r{r}.npz")) for r in range(world)]


def params(res: dict) -> dict:
    return {k[2:]: v for k, v in res.items() if k.startswith("p:")}


def assert_ranks_bitwise_equal(per_rank: list[dict]) -> None:
    for r, res in enumerate(per_rank[1:], 1):
        for key, value in per_rank[0].items():
            np.testing.assert_array_equal(res[key], value,
                                          err_msg=f"rank {r}: {key}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread in this module, restored after: under the suite's
    six xdist workers a thread a core in each would oversubscribe the
    host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's seeded init, as numpy leaves, and the port's state dict of it."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)

    jparams = jax.tree.map(np.asarray, init_seq2seq(jax.random.PRNGKey(1),
                                                    JConfig(**GEOM)))
    return jparams, params_from_jax(jparams, Config(**GEOM))


def jax_steps(overrides: dict, dp: int, jparams, src, trg):
    """STEPS JAX steps on a (dp, 1) mesh of the virtual devices: batches
    sharded over 'data', state placed by shard_state (tests/
    test_grad_accum.py:50, tests/test_training.py:105)."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        batch_sharding, make_mesh as jmake_mesh)
    from neurosync_trainer_lite_tpu.training.step import (
        init_train_state, make_train_step, shard_state)

    cfg = JConfig(**{**GEOM, **overrides, "dp": dp, "tp": 1})
    mesh = jmake_mesh(cfg)
    state, tx = init_train_state(cfg, 10, params=jax.tree.map(
        jax.numpy.asarray, jparams))
    state = shard_state(state, cfg, mesh, tx)
    step = make_train_step(cfg, tx, donate=False)
    s = jax.device_put(src, batch_sharding(mesh))
    t = jax.device_put(trg, batch_sharding(mesh))
    losses, norms = [], []
    for _ in range(STEPS):
        state, loss, norm = step(state, s, t, jax.random.PRNGKey(7))
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, jax.tree.map(np.asarray, state.params)


DP2_CASES = [
    {"kind": "steps", "name": "d0", "cfg": {}, "seed": 3},
    {"kind": "steps", "name": "accum", "seed": 1,
     "cfg": {"batch_size": 16, "grad_accum_steps": 2}},
    {"kind": "steps", "name": "drop", "seed": 3, "cfg": {"dropout": 0.3}},
    {"kind": "steps", "name": "drop_accum", "seed": 1,
     "cfg": {"dropout": 0.3, "batch_size": 16, "grad_accum_steps": 2}},
    {"kind": "batch", "name": "batch", "batch_size": 8},
    {"kind": "ckpt", "name": "ckpt"},
    {"kind": "decode", "name": "decode"},
]
DP4_CASES = [DP2_CASES[0], {"kind": "batch", "name": "batch", "batch_size": 8},
             DP2_CASES[-1]]


def decode_inputs(out: Path) -> dict:
    """An odd chunk count (5) and 150 frames of features (7 chunks), as
    tests/test_inference.py:122."""
    rng = np.random.default_rng(6)
    cfg = Config(**GEOM)
    arrays = {"chunks": rng.standard_normal(
                  (5, cfg.frame_size, cfg.input_dim)).astype(np.float32),
              "feats": rng.standard_normal(
                  (150, cfg.input_dim)).astype(np.float32)}
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "decode_in.npz", **arrays)
    return arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """The 2-rank and the 4-rank runs: {world: out directory}."""
    _, init = jax_init
    runs = {}
    for world, cases in ((2, DP2_CASES), (4, DP4_CASES)):
        out = tmp_path_factory.mktemp(f"dp{world}")
        decode_inputs(out)
        spawn(Path(__file__), out, world, cases, init)
        runs[world] = out
    return runs


# ---------------------------------------------------------------------------
# the mesh


@pytest.mark.parametrize("dp,tp,world", [(-1, 1, 4), (2, 1, 4), (8, 1, 4),
                                         (-1, 2, 4), (2, 2, 4), (1, 4, 4),
                                         (4, 2, 4)])
def test_make_mesh_matches_jax(dp, tp, world):
    """The mesh arithmetic and error text of JAX's make_mesh, one rank a
    device."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        make_mesh as jmake_mesh)

    try:
        theirs = dict(jmake_mesh(JConfig(dp=dp, tp=tp),
                                 devices=jax.devices()[:world]).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            make_mesh(Config(dp=dp, tp=tp), world=world)
        assert str(ours.value) == str(e) == (
            f"mesh {dp}x{tp} needs {dp * tp} devices, have 4")
        return
    assert make_mesh(Config(dp=dp, tp=tp), world=world).shape == theirs


def test_mesh_refusals(monkeypatch):
    """tp = 2 or dp = 2 with no process group is JAX's mesh error; a rank
    holds whole heads and an equal block of the FFN; a mesh larger than the
    world raises; a live group's mesh must use every rank (a world that is
    not dp · tp); batches split into equal shares."""
    from types import SimpleNamespace

    from neurosync_trainer_lite_tpu_torch.config import check_tp_split

    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        make_mesh(Config(tp=2))
    with pytest.raises(ValueError, match="num_heads 16 is not a multiple of "
                                         "tp 3"):
        make_mesh(Config(tp=3), world=3)
    with pytest.raises(ValueError, match="ffn_dim 6 is not a multiple of "
                                         "tp 4"):
        check_tp_split(SimpleNamespace(num_heads=4, ffn_dim=6), 4)
    with monkeypatch.context() as m:       # a live group of 4 ranks
        m.setattr(distributed, "world_size", lambda: 4)
        with pytest.raises(ValueError, match="mesh 1x2 uses 2 of the 4 "
                                             "ranks: launch 2 processes"):
            make_mesh(Config(dp=1, tp=2))
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        make_mesh(Config(dp=2))
    assert make_mesh(Config()).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="divisible by grad_accum_steps"):
        batch_rows(make_mesh(Config(dp=2), world=2), 6, 2)


def test_batch_rows_interleave_under_accumulation():
    """Rank r's rows of micro-batch i are [i·B/A + r·m, i·B/A + (r+1)·m):
    the ranks' rows tile the batch, and the local micro-batch i is the
    rank's share of the global micro-batch i."""
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import Mesh

    rows = [batch_rows(Mesh(dp=2, data_index=r), 16, 2) for r in range(2)]
    assert rows[0].tolist() == [0, 1, 2, 3, 8, 9, 10, 11]
    assert rows[1].tolist() == [4, 5, 6, 7, 12, 13, 14, 15]
    assert batch_rows(None, 8).tolist() == list(range(8))


# ---------------------------------------------------------------------------
# the step


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax_dp8(ranks, jax_init, world):
    """3 steps at dp = 2 and 4 against JAX at dp = 8 (tests/
    test_training.py:105-130's setup): loss and pre-clip grad norm within
    1e-5 relative, parameters within atol 1e-4 (the bound JAX's own DP test
    uses: reduction-order differences grow through Adam's rsqrt(v)), and
    every rank's parameters bitwise equal."""
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)

    jparams, _ = jax_init
    cfg = Config(**GEOM)
    src, trg = batch(3, cfg.batch_size, cfg)
    losses, norms, jfinal = jax_steps({}, 8, jparams, src, trg)
    per_rank = results(ranks[world], "d0", world)
    assert_ranks_bitwise_equal(per_rank)
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-5)
    theirs = params_from_jax(jfinal, cfg)
    for key, ours in params(per_rank[0]).items():
        np.testing.assert_allclose(ours, theirs[key].numpy(), atol=1e-4,
                                   err_msg=key)


def test_dp2_accumulation_matches_jax(ranks, jax_init):
    """grad_accum_steps 2 at dp = 2 against JAX's accumulation on a dp = 4
    mesh (tests/test_grad_accum.py:50's setup, batch 16): 1e-5."""
    jparams, _ = jax_init
    overrides = {"batch_size": 16, "grad_accum_steps": 2}
    cfg = Config(**{**GEOM, **overrides})
    src, trg = batch(1, 16, cfg)
    losses, norms, _ = jax_steps(overrides, 4, jparams, src, trg)
    per_rank = results(ranks[2], "accum", 2)
    assert_ranks_bitwise_equal(per_rank)
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-5)


@pytest.mark.parametrize("name", ["d0", "accum", "drop", "drop_accum"])
def test_dp2_equals_dp1(ranks, jax_init, name):
    """The port at dp = 2 against the port at dp = 1 (no process group),
    at dropout 0 and 0.3, with and without accumulation: each rank's masks
    are its rows of the global micro-batch's and its rows interleave across
    micro-batches, so only the order of the reductions differs: loss and
    norm within 1e-6 relative, parameters within 1e-5 after 3 steps."""
    _, init = jax_init
    case = next(c for c in DP2_CASES if c["name"] == name)
    cfg = Config(**{**GEOM, **case["cfg"]})
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    losses, norms, sd, _ = port_steps(cfg, init, src, trg)
    per_rank = results(ranks[2], name, 2)
    assert_ranks_bitwise_equal(per_rank)
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-6)
    for key, ours in params(per_rank[0]).items():
        np.testing.assert_allclose(ours, sd[key].numpy(), atol=1e-5,
                                   err_msg=key)


def test_dropout_rows_are_blocks_of_the_global_draw():
    """Under dropout_rows(n, i) a mask is block i of the n-times-taller
    draw; outside it the draw is unchanged."""
    from neurosync_trainer_lite_tpu_torch.ops.attention import (
        dropout_keep, dropout_rows)

    whole = dropout_keep(11, (6, 5, 4), 77, "cpu")
    for i in range(3):
        with dropout_rows(3, i):
            part = dropout_keep(11, (2, 5, 4), 77, "cpu")
        assert torch.equal(part, whole[2 * i: 2 * i + 2])
    assert torch.equal(dropout_keep(11, (6, 5, 4), 77, "cpu"), whole)
    with pytest.raises(ValueError):
        with dropout_rows(2, 2):
            pass


# ---------------------------------------------------------------------------
# batches, checkpoints, decode


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_gather_only_their_rows(ranks, world):
    """Identical window tables (CRC) on every rank; each rank gathers
    exactly its B/dp windows of the seeded batch, laid out as batch_rows
    says with and without accumulation (the JAX multihost worker's
    MULTIHOST_BATCH checks)."""
    from neurosync_trainer_lite_tpu_torch.data.windowing import (
        WindowedDataset)
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import Mesh

    cfg = Config(**GEOM)
    ds = WindowedDataset(clips(cfg), window=cfg.micro_batch_size)
    train, _ = ds.split(0.1, 0)
    chunk = next(train.index_batches(8, shuffle=True, seed=3))
    src, trg = ds.gather(chunk)
    crc = zlib.crc32(np.ascontiguousarray(ds.table).tobytes())
    per_rank = results(ranks[world], "batch", world)
    for r, res in enumerate(per_rank):
        assert int(res["table_crc"]) == crc
        for accum in (1, 2):
            rows = batch_rows(Mesh(dp=world, data_index=r), 8, accum)
            assert res[f"gathered{accum}"].tolist() == chunk[rows].tolist()
            np.testing.assert_array_equal(res[f"src{accum}"], src[rows])
            np.testing.assert_array_equal(res[f"trg{accum}"], trg[rows])


def test_collective_checkpoint_and_failure_fence(ranks):
    """Saved at dp = 2 (rank 0 writes), restored on both ranks bitwise
    (sync and async saves), the next step's loss equal on both ranks and to
    the uninterrupted run's; an export failure planted on rank 0 raises on
    both ranks."""
    r0, r1 = results(ranks[2], "ckpt", 2)
    for res in (r0, r1):
        assert res["sync_equal"] and res["async_equal"]
        assert res["sync_next_loss"] == res["async_next_loss"] \
            == res["continued_loss"] == r0["continued_loss"]
    assert str(r0["raised"]) == ("async checkpoint save or model.pth export "
                                 "failed")
    assert str(r1["raised"]).endswith("failed on another process")


def test_sync_save_failures_raise_on_every_rank(ranks):
    """A backup rotation and a synchronous state write planted to fail on
    rank 0 raise on both ranks at their fences (ckpt-post-rotate,
    ckpt-saved), the other rank never left waiting in a collective."""
    r0, r1 = results(ranks[2], "ckpt", 2)
    for name, tag in (("_rotate_backups", "ckpt-post-rotate"),
                      ("_write_atomic", "ckpt-saved")):
        assert str(r0[f"raised{name}"]) == f"{tag}: failed"
        assert str(r1[f"raised{name}"]) == f"{tag}: failed on another process"


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_decoder_matches_jax(ranks, jax_init, world):
    """MeshDecoder at dp = 2 and 4 against the JAX MeshDecoder at (8, 1)
    and against decode_chunks_batched, standalone (5 chunks: an odd count)
    and through process_audio_features: atol 1e-5, rtol 1e-4 (tests/
    test_inference.py:144-151). Every rank gets the whole result."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.inference import chunked as jchunked
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        make_mesh as jmake_mesh)
    from neurosync_trainer_lite_tpu_torch.inference import chunked
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    jparams, init = jax_init
    arrays = dict(np.load(ranks[world] / "decode_in.npz"))
    jcfg = JConfig(**GEOM)
    jp = jax.tree.map(jax.numpy.asarray, jparams)
    jdec = jchunked.MeshDecoder(jp, jcfg, jmake_mesh(jcfg.replace(dp=8)))
    cfg = Config(**GEOM)
    model = Seq2Seq(cfg, "cpu")
    model.load_state_dict(init)
    model.eval()
    want = {
        "chunks": [jdec(jp, arrays["chunks"], jcfg),
                   chunked.decode_chunks_batched(model, arrays["chunks"],
                                                 cfg)],
        "frames": [jchunked.process_audio_features(arrays["feats"], jp, jcfg,
                                                   decode_batched=jdec),
                   chunked.process_audio_features(arrays["feats"], model,
                                                  cfg)]}
    per_rank = results(ranks[world], "decode", world)
    assert_ranks_bitwise_equal(per_rank)
    assert per_rank[0]["chunks"].shape == (5, cfg.frame_size, cfg.output_dim)
    for key, refs in want.items():
        for ref in refs:
            np.testing.assert_allclose(per_rank[0][key], ref, atol=1e-5,
                                       rtol=1e-4, err_msg=key)


def test_distributed_is_a_no_op_without_arguments():
    assert distributed.initialize_distributed() is False
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.rank_device("cpu") == torch.device("cpu")
    assert distributed.any_failed(True) and not distributed.any_failed(False)
    distributed.barrier("no-op")


def test_multi_rank_mesh_without_group_raises():
    """A mesh of two ranks with no process group: every collective, and a
    MeshDecoder on it, raises rather than compute one rank's share."""
    from neurosync_trainer_lite_tpu_torch.inference.chunked import (
        MeshDecoder)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    mesh = make_mesh(Config(dp=2), world=2)
    cfg = Config(**GEOM)
    model = Seq2Seq(cfg, "cpu").eval()
    chunks = np.zeros((3, cfg.frame_size, cfg.input_dim), np.float32)
    calls = [lambda: distributed.all_reduce_mean_(torch.zeros(3), mesh),
             lambda: distributed.broadcast_([torch.zeros(3)], mesh),
             lambda: distributed.all_gather_rows(torch.zeros(2, 3), mesh),
             lambda: MeshDecoder(model, cfg, mesh)(model, chunks, cfg)]
    for call in calls:
        with pytest.raises(RuntimeError, match="without a process group"):
            call()
    with pytest.raises(OSError, match="unchanged"):   # one process: as is
        with distributed.fenced("no-op"):
            raise OSError("unchanged")


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_parallel.py worker SPEC RANK")
    worker(sys.argv[2], int(sys.argv[3]))

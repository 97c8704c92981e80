"""The port's bench (neurosync_trainer_lite_tpu_torch/bench.py) against the
repo root's bench.py, which drives the JAX package.

Each mode prints the record bench.py prints: the same metric, unit and
keys, read from bench.py's source with ast (bench.py imports jax at its
top, so it is read, never imported). The work the bench times equals
JAX's on the same weights (carried with params_from_jax) and inputs:
_measure_train's first steps against the JAX step, the timed request
against the JAX serving API. Small geometries on the CPU.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.config import Config as JConfig
from neurosync_trainer_lite_tpu.inference import api as japi
from neurosync_trainer_lite_tpu.models import seq2seq as jmodel
from neurosync_trainer_lite_tpu.training import step as jstep
from neurosync_trainer_lite_tpu_torch import bench
from neurosync_trainer_lite_tpu_torch.config import Config, tiny_config
from neurosync_trainer_lite_tpu_torch.inference import api as tapi
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.utils.weights import params_from_jax

REPO = Path(__file__).resolve().parent.parent
JAX_BENCH = REPO / "bench.py"
#: the modes' geometry: small enough for the CPU
SMALL = dict(hidden_dim=32, n_layers=1, num_heads=2, batch_size=2,
             micro_batch_size=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one a worker process:
    torch's pool of a thread a core in each would oversubscribe the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_modes() -> dict[str, str]:
    """bench.py's --mode table: mode → function name."""
    for node in ast.walk(ast.parse(JAX_BENCH.read_text())):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys) and {
                k.value for k in node.keys} >= {"train", "infer"}:
            return {k.value: v.id for k, v in zip(node.keys, node.values)}
    raise AssertionError("bench.py has no --mode table")


def _pattern(node) -> str:
    """A regex for a str constant or an f-string (its fields match .+)."""
    if isinstance(node, ast.Constant):
        return re.escape(node.value)
    return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                   else ".+" for v in node.values)


def _jax_records(function: str) -> list[dict]:
    """Each record `function` prints, in order: its keys, the metric and
    unit patterns, and whether it goes to stderr."""
    tree = ast.parse(JAX_BENCH.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    records = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and getattr(node.func, "id", "")
                == "print" and node.args
                and isinstance(node.args[0], ast.Call)
                and getattr(node.args[0].func, "attr", "") == "dumps"):
            continue
        record = node.args[0].args[0]
        fields = {k.value: v for k, v in zip(record.keys, record.values)}
        records.append({
            "keys": set(fields), "metric": _pattern(fields["metric"]),
            "unit": _pattern(fields["unit"]),
            "stderr": any(kw.arg == "file" for kw in node.keywords)})
    return sorted(records, key=lambda r: r["metric"])


def test_the_mode_table_is_bench_pys():
    assert set(bench.MODES) == set(_jax_modes())
    assert {m: bench.MODES[m].__name__ for m in bench.MODES} == _jax_modes()


@pytest.mark.parametrize("mode", ["train", "infer", "stream", "frontend"])
def test_each_mode_prints_bench_pys_record(mode, capsys):
    cfg = tiny_config(**SMALL, dropout=0.3)
    out = bench.MODES[mode](cfg, "cpu")
    got = out if isinstance(out, list) else [out]
    printed = capsys.readouterr()
    want = _jax_records(_jax_modes()[mode])
    assert len(got) == len(want)
    for rec, spec in zip(sorted(got, key=lambda r: r["metric"]), want):
        assert set(rec) == spec["keys"]
        assert re.fullmatch(spec["metric"], rec["metric"]), rec["metric"]
        assert re.fullmatch(spec["unit"], rec["unit"])
        assert np.isfinite(rec["value"]) and rec["value"] > 0
        stream = printed.err if spec["stderr"] else printed.out
        assert json.dumps(rec) in stream.splitlines()
    # the headline (train's second record) is the last line of stdout
    assert json.loads(printed.out.strip().splitlines()[-1]) == got[-1]


def test_train_headline_names_the_training_dropout(capsys):
    """The dropout-0 line first (stderr), the headline at the config's
    dropout (0.3) last on stdout: bench.py's exact metric names."""
    d0, head = bench.main(tiny_config(**SMALL, dropout=0.3), "cpu")
    assert d0["metric"] == "228M_train_samples_per_sec_per_chip_dropout0"
    assert head["metric"] == "228M_train_samples_per_sec_per_chip_dropout0.3"
    printed = capsys.readouterr()
    assert json.dumps(d0) in printed.err.splitlines()
    assert json.loads(printed.out.strip().splitlines()[-1]) == head
    assert "remat plan at dropout 0.3" in printed.err


GEOM = dict(hidden_dim=64, n_layers=2, num_heads=4, input_dim=32,
            output_dim=7, dropout=0.0, use_amp=False, batch_size=4,
            micro_batch_size=16)


def test_measure_train_steps_match_jax():
    """_measure_train's loop from JAX's weights on bench's own batch: the
    first 3 steps' losses within 1e-5 relative of the JAX step's (fp32,
    dropout 0; the bound of test_torch_training.py)."""
    jcfg, cfg = JConfig(**GEOM), Config(**GEOM)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(1), jcfg)
    losses = []
    bench._measure_train(cfg, 1, device="cpu", losses=losses,
                         state_dict=params_from_jax(
                             jax.tree.map(np.asarray, params), cfg))
    assert len(losses) == bench.TRAIN_WARMUP + 1
    src, trg = (t.numpy() for t in bench.train_batch(cfg, torch.device("cpu")))
    state, tx = jstep.init_train_state(jcfg, 100, params=params)
    step = jstep.make_train_step(jcfg, tx, donate=False)
    for i in range(3):
        state, loss, _ = step(state, jnp.asarray(src), jnp.asarray(trg),
                              jax.random.PRNGKey(i))
        assert float(losses[i]) == pytest.approx(float(loss), rel=1e-5), i
    assert float(losses[2]) < float(losses[0])


def test_timed_request_matches_the_jax_api():
    """The infer mode's request (bench's seeded 30 s WAV through the bytes
    API) on JAX's weights: frames within the API parity test's atol 1e-6,
    rtol 1e-4 (fp32 both sides)."""
    geom = dict(hidden_dim=32, n_layers=1, num_heads=2, dropout=0.0,
                use_amp=False)
    jcfg, cfg = JConfig(**geom), Config(**geom)
    params = jmodel.init_seq2seq(jax.random.PRNGKey(0), jcfg)
    model = Seq2Seq(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          cfg), strict=True)
    wav = bench.seeded_wav(cfg)
    ours = tapi.generate_facial_data_from_bytes(wav, model.eval(), cfg,
                                                device="cpu")
    theirs = np.asarray(japi.generate_facial_data_from_bytes(wav, params,
                                                             jcfg))
    assert ours.shape == theirs.shape == (60 * bench.REQUEST_SECONDS + 1, 61)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-4)


def test_cli_prints_the_record_last():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.bench",
         "--mode", "infer", "--device", "cpu", "--tiny"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["metric"] == "audio_to_blendshape_frames_per_sec"
    assert last["unit"] == "frames/s" and last["value"] > 0

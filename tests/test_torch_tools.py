"""The port's probes (neurosync_trainer_lite_tpu_torch/tools/) against the
repo root's tools/, which drive the JAX package.

Each ported tool runs in a subprocess on the CPU at a tiny size
(--device cpu --tiny), exits 0 and prints the record of its JAX
counterpart: the same keys, read with ast from the JAX tool's record
literal (the JAX tools import jax, so they are read, not imported).
data_scale_probe --generate writes the JAX tool's files byte for byte at
the same seed; train_scale_run ends with the JAX tool's SUMMARY line.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
PORT = "neurosync_trainer_lite_tpu_torch.tools."


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _run(argv, timeout=600, stderr=False):
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    return (proc.stdout, proc.stderr) if stderr else proc.stdout


def _dict_keys(node: ast.Dict) -> set[str]:
    return {k.value for k in node.keys}


def _record_keys(tool: str) -> set[str]:
    """The keys of the record the JAX tool prints: its `rec = {...}`
    literal, or the dict tick_cost returns (local_dispatch_probe)."""
    tree = ast.parse((TOOLS / tool).read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", "") == "rec" for t in node.targets)):
            return _dict_keys(node.value)
        if (isinstance(node, ast.FunctionDef) and node.name == "tick_cost"):
            return next(_dict_keys(n.value) for n in ast.walk(node)
                        if isinstance(n, ast.Return)
                        and isinstance(n.value, ast.Dict))
    raise AssertionError(f"tools/{tool} has no record literal")


def _summary_keys() -> set[str]:
    """train_scale_run's SUMMARY keys: its summary literal and every
    summary["..."] it assigns."""
    tree = ast.parse((TOOLS / "train_scale_run.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.AnnAssign) and getattr(
                node.target, "id", "") == "summary":
            keys |= _dict_keys(node.value)
        if (isinstance(node, ast.Subscript)
                and getattr(node.value, "id", "") == "summary"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def _last_record(stdout: str) -> dict:
    line = stdout.strip().splitlines()[-1]
    return json.loads(line) if line.startswith("{\"") else ast.literal_eval(
        line)


RUNS = {
    "serving_soak": ["x", "--ticks", "12", "--sessions", "2",
                     "--max-sessions", "4", "--churn", "5"],
    "serving_knee --fused 1": ["x", "--k", "2", "--reps", "2", "--fused",
                               "1"],
    "serving_knee --fused 0": ["x", "--k", "2", "--reps", "2", "--fused",
                               "0"],
    "warmup_probe": ["--sessions", "2", "--soak-ticks", "6", "--live", "2",
                     "--churn-every", "3"],
    "step_probe": ["x", "--steps", "2", "--b", "4", "--t", "32",
                   "--dropout", "0.3", "--remat", "0"],
    "step_probe --fwd-only": ["x", "--steps", "2", "--b", "4", "--t", "32",
                              "--fwd-only", "--attn", "pallas"],
    "step_probe --patch ffn-bwd-pallas": [
        "x", "--steps", "2", "--b", "4", "--t", "32", "--amp", "1",
        "--patch", "ffn-bwd-pallas"],
}
JAX_TOOL = {"serving_soak": "serving_soak.py",
            "serving_knee": "serving_knee.py",
            "warmup_probe": "warmup_probe.py",
            "step_probe": "tpu_probe.py"}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tool_prints_the_jax_record(run, tmp_path):
    tool = run.split()[0]
    out = tmp_path / "results.jsonl"
    stdout, stderr = _run(["-m", PORT + tool, *RUNS[run], "--out", str(out),
                           "--device", "cpu", "--tiny"], stderr=True)
    rec = _last_record(stdout)
    assert set(rec) == _record_keys(JAX_TOOL[tool])
    assert json.loads(out.read_text().splitlines()[-1]) == rec
    if tool == "serving_soak":
        assert rec["total_frames"] > 0 and rec["slow_over_5s"] == 0
        assert rec["watchdog_flip_tick"] is None
        assert stdout.count("closed after") == 4   # 2 churned + 2 at the end
    if tool == "step_probe":
        assert rec["samples_per_sec"] > 0 and (rec["b"], rec["t"]) == (4, 32)
        # the launches line: 3 warm + 2 timed steps, and no kernel launched
        # (CPU tensors take the plain versions)
        line = next(x for x in stderr.splitlines()
                    if x.startswith("launches "))
        assert json.loads(line[len("launches "):]) == {"steps": 5,
                                                       "launches": {}}


def test_local_dispatch_probe_runs_on_the_cpu_when_asked():
    """--device cpu: the probe's tick loop on the in-process CPU, the JAX
    probe's forced CPU backend (without --device it needs the card)."""
    stdout = _run(["-m", PORT + "local_dispatch_probe", "--sessions", "2",
                   "--ticks", "10", "--device", "cpu"])
    assert stdout.splitlines()[0] == "backend: cpu"
    rec = _last_record(stdout)
    assert set(rec) == _record_keys("local_dispatch_probe.py")
    assert rec["intake_ticks"] + rec["decode_ticks"] == 10


def test_data_scale_probe_generates_the_jax_tools_bytes(tmp_path):
    """One voice, one minute, seed 0: every file byte-identical to the JAX
    tool's (pandas' CSVs); then --measure reads it through the port."""
    _run([str(TOOLS / "data_scale_probe.py"), "--generate",
          str(tmp_path / "jax"), "--voices", "1", "--minutes", "1"])
    _run(["-m", PORT + "data_scale_probe", "--generate",
          str(tmp_path / "port"), "--voices", "1", "--minutes", "1"])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert [str(f) for f in files] == [
        "voice_00/audio_features.csv", "voice_00/voice0_iPhone_cal.csv"]
    assert files == sorted(p.relative_to(tmp_path / "port") for p in (
        tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    stdout = _run(["-m", PORT + "data_scale_probe", "--measure",
                   str(tmp_path / "port"), "--epochs", "1", "--device",
                   "cpu"])
    assert "ingest: 1 clips, 5370 augmented frames" in stdout
    assert stdout.strip().splitlines()[-1].startswith("peak RSS: ")


def test_train_scale_run_ends_with_its_summary(tmp_path):
    _run(["-m", PORT + "data_scale_probe", "--generate",
          str(tmp_path / "data"), "--voices", "1", "--minutes", "1"])
    stdout = _run(["-m", PORT + "train_scale_run", "--root",
                   str(tmp_path / "data"), "--steps", "2", "--epochs", "1",
                   "--out", str(tmp_path / "out"), "--summary-out",
                   str(tmp_path / "summary.json"), "--device", "cpu",
                   "--tiny"])
    last = stdout.strip().splitlines()[-1]
    assert last.startswith("SUMMARY ")
    summary = json.loads(last[len("SUMMARY "):])
    assert set(summary) == _summary_keys()
    assert summary == json.loads((tmp_path / "summary.json").read_text())
    assert summary["optimizer_steps"] == 2 and summary["nan_steps"] == 0
    assert summary["checkpoint_entries"] and summary["model_pth_mb"] > 0

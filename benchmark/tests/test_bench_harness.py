"""The harness: driven by files found by name, no card no result, and no
JAX in any process it runs."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.common import harness

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "benchmark" / "run.py"


def test_spec_names_only_existing_files():
    spec = harness.benchmark_spec()
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        work = harness.workload(w["name"])
        assert work["config"] == w["config"] and work["chips"] == w["chips"]
        assert (harness.BENCH / "drivers" / f"{work['driver']}.py").is_file()
        assert set(work["limits"])
    for m in spec["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_cell_reports_what_the_contract_asks():
    spec = harness.benchmark_spec()
    assert all("workloads" in m for m in spec["per_layer"])
    for w in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, w["name"],
                                                       "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(spec, w["name"], "per_layer")


def test_new_metric_file_is_found(tmp_path):
    """A later change adds a per-layer metric as a file and an entry."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "window_steps.train.py").write_text(
        "def read(ctx, out):\n    return out.extras.get('window_steps')\n")
    spec = harness.benchmark_spec()
    spec["per_layer"].append({
        "name": "window_steps.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "the card",
        "moves": "train_frames_per_s", "workloads": ["train-w128-b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    spec = harness.benchmark_spec(tmp_path)
    names = [m["name"] for m in harness.cell_metrics(spec, "train-w128-b128",
                                                     "per_layer")]
    assert "window_steps.train" in names
    assert "window_steps.train" not in [
        m["name"] for m in harness.cell_metrics(spec, "train-dp4-w128-b128",
                                                "per_layer")]
    reader = harness.metric_reader("window_steps.train", bench)

    class Out:
        extras = {"window_steps": 7}
    assert reader.read(None, Out()) == 7


def _run(args, cwd=ROOT, **kw):
    return subprocess.run([sys.executable, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, **kw)


def test_no_card_no_result():
    r = _run([str(RUN), "--workload", "train-w128-b128", "--seed",
              str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
             env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "needs 1 CUDA card" in r.stderr


def test_without_the_port_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = _run(["benchmark/run.py", "--workload", "train-w128-b128",
              "--seed", "1", "--seconds", "1"], cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_levels():
    mods = {"neurosync_trainer_lite_tpu_torch.ops": 1, "jaxtyping": 1,
            "neurosync_trainer_lite_tpu.config": 1, "jax.numpy": 1,
            "flax": 1, "optaxx": 1}
    assert harness.forbidden_modules(mods) == [
        "flax", "jax.numpy", "neurosync_trainer_lite_tpu.config"]


PROBE = """
import sys
sys.path.insert(0, {root!r})
import runpy, importlib
from benchmark.common import harness
spec = harness.benchmark_spec()
import benchmark.run
for w in spec["workloads"]:
    harness.driver(harness.workload(w["name"])["driver"])
for m in spec["per_layer"]:
    harness.metric_reader(m["name"])
import benchmark.tools.readings, benchmark.tools.faults
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_nothing_run_imports_jax():
    """Every module of the harness, its drivers (and the program code they
    import when they run), its readers and its tools."""
    extra = ("from benchmark.tools import faults\n"
             "harness.driver('utterances')\n"
             "import neurosync_trainer_lite_tpu_torch.training.loop\n"
             "import neurosync_trainer_lite_tpu_torch.inference.api\n"
             "with faults.plant('train', 'unchanged'): pass\n"
             "with faults.plant('serve', 'altered'): pass\n")
    r = _run(["-c", PROBE.format(root=str(ROOT), extra=extra)])
    assert r.returncode == 0, r.stderr
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not tops & harness.FORBIDDEN
    assert "neurosync_trainer_lite_tpu_torch" in tops


def test_reference_imports_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.model, benchmark.reference.frontend\n"
            "import benchmark.reference.serve, benchmark.reference.compare\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "neurosync_trainer_lite_tpu_torch" not in tops
    assert not tops & harness.FORBIDDEN


def test_harness_reads_no_jax_era_records():
    """Nothing under benchmark/ names the JAX package's bench records."""
    for path in harness.BENCH.rglob("*.py"):
        if path.name == "test_bench_harness.py":
            continue
        text = path.read_text()
        for word in ("BENCH_r0", "MULTICHIP_", "BASELINE.json",
                     "import bench"):
            assert word not in text, (path, word)

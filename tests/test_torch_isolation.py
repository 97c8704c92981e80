"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU.

The port (neurosync_trainer_lite_tpu_torch) must import neither jax (nor
optax, which imports it) nor anything of neurosync_trainer_lite_tpu, nor
pandas or matplotlib (a CUDA host may lack both), and its entry points
must run on the CUDA card unless the caller asks for the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurosync_trainer_lite_tpu_torch import bench, compat
from neurosync_trainer_lite_tpu_torch.tools import (
    data_scale_probe,
    local_dispatch_probe,
    serving_knee,
    serving_soak,
    step_probe,
    train_scale_run,
    warmup_probe,
)
from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.processing import extract_audio_features
from neurosync_trainer_lite_tpu_torch.inference.api import (
    generate_facial_data_from_bytes,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq, init_seq2seq
from neurosync_trainer_lite_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from neurosync_trainer_lite_tpu_torch.ops.fused_attention import (
    fused_rope_attention_bwd_cuda,
    fused_rope_attention_cuda,
    make_tables,
)
from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
    MultiStreamer,
)
from neurosync_trainer_lite_tpu_torch.inference.server import (
    main as server_main,
    serve,
)
from neurosync_trainer_lite_tpu_torch.inference.streaming import (
    BlendshapeStreamer,
)
from neurosync_trainer_lite_tpu_torch.ops.frontend import (
    extract_audio_features as frontend_features,
    extract_audio_features_bucketed,
)
from neurosync_trainer_lite_tpu_torch.ops.rope import rope_tables
from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    initialize_distributed,
    rank_device,
)
from neurosync_trainer_lite_tpu_torch.ops.rope_kernel import rope_rotate_cuda
from neurosync_trainer_lite_tpu_torch.ops.ffn_bwd import ffn_bwd_dh1_cuda
from neurosync_trainer_lite_tpu_torch.train import main as train_main
from neurosync_trainer_lite_tpu_torch.training.loop import train_model
from neurosync_trainer_lite_tpu_torch.training.step import init_train_state
from neurosync_trainer_lite_tpu_torch.utils.audio_io import audio_to_bytes
from neurosync_trainer_lite_tpu_torch.utils.weights import load_model

REPO = Path(__file__).resolve().parent.parent
TINY = REPO / "tests" / "fixtures" / "reference_tiny" / "model.pth"
CFG = Config(hidden_dim=64, n_layers=2, num_heads=4, frame_size=32, overlap=8,
             dropout=0.0, use_amp=False)

_IMPORT_ALL = """
import importlib, pkgutil, sys
import neurosync_trainer_lite_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "optax", "neurosync_trainer_lite_tpu",
                      "pandas", "matplotlib")
             or n.startswith(("jax.", "jaxlib.", "optax.",
                              "neurosync_trainer_lite_tpu.", "pandas.",
                              "matplotlib.")))
need = [pkg.__name__ + m for m in (".compat", ".utils.profiling",
                                   ".utils.epoch_stats",
                                   ".ops.flash_attention", ".ops.ffn_bwd",
                                   ".parallel.mesh", ".parallel.distributed",
                                   ".parallel.tensor",
                                   ".training.loop", ".train",
                                   ".inference.streaming",
                                   ".inference.multi_stream",
                                   ".inference.server", ".bench",
                                   ".tools._serving_harness",
                                   ".tools.serving_soak",
                                   ".tools.serving_knee",
                                   ".tools.warmup_probe",
                                   ".tools.local_dispatch_probe",
                                   ".tools.step_probe",
                                   ".tools.data_scale_probe",
                                   ".tools.train_scale_run")]
print(len(names), bad, [m for m in need if m not in names])
sys.exit(1 if bad or len(names) < 15 or any(m not in names for m in need)
         else 0)
"""


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_OPS = """
import importlib, pkgutil, sys
import neurosync_trainer_lite_tpu_torch.ops as ops
names = [m.name for m in pkgutil.walk_packages(ops.__path__, ops.__name__ + ".")]
for name in names:
    importlib.import_module(name)
models = sorted(n for n in sys.modules
                if n.startswith("neurosync_trainer_lite_tpu_torch.models"))
print(len(names), models)
sys.exit(1 if models or len(names) < 10 else 0)
"""


def test_ops_import_nothing_of_models():
    """The kernels and their wrappers sit below the models: importing every
    ops/ module loads no module of neurosync_trainer_lite_tpu_torch.models."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_OPS], cwd=REPO,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """chip_smoke.py needs a CUDA card: without one it exits non-zero,
    prints no result line, and never imports JAX on the way."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "try:\n"
         "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
         "finally:\n"
         "    assert 'jax' not in sys.modules, 'chip_smoke imported jax'\n"],
        cwd=REPO, env={**_clean_env(), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "imported jax" not in proc.stderr


@pytest.mark.parametrize("argv", [["chip_smoke.py", "--only", "serve-s2"],
                                  ["chip_smoke.py", "--only", "live"],
                                  ["chip_smoke.py", "--only", "tensor"],
                                  ["chip_smoke.py", "--only", "compat"],
                                  ["chip_smoke.py", "--only", "tools"],
                                  ["k3_variants.py"], ["k2_variants.py"]])
def test_card_scripts_refuse_to_run_without_a_card(argv):
    """The other ways to run the card scripts exit non-zero too, without a
    result line and without importing JAX."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         f"sys.argv = {argv!r}\n"
         "try:\n"
         "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
         "finally:\n"
         "    assert 'jax' not in sys.modules, 'imported jax'\n"],
        cwd=REPO, env={**_clean_env(), "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
    assert "imported jax" not in proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_model():
    return init_seq2seq(CFG, torch.Generator().manual_seed(0), device="cpu")


ENTRY_POINTS = {
    "Seq2Seq": lambda: Seq2Seq(CFG),
    "load_model": lambda: load_model(str(TINY), CFG),
    "frontend": lambda: frontend_features(np.zeros(44100, np.float32)),
    "processing": lambda: extract_audio_features(
        audio_to_bytes(np.zeros(44100), 88200), from_bytes=True),
    "api": lambda: generate_facial_data_from_bytes(
        audio_to_bytes(np.zeros(44100), 88200), _cpu_model(), CFG),
    "init_train_state": lambda: init_train_state(
        CFG, 1, generator=torch.Generator()),
    "train_model": lambda: train_model(CFG),
    "compat.build_model": lambda: compat.build_model(CFG),
    "compat.generate_facial_data_from_bytes": lambda: (
        compat.generate_facial_data_from_bytes(
            audio_to_bytes(np.zeros(44100), 88200), _cpu_model(), None, CFG)),
    "train.main": lambda: train_main(["--tiny"]),
    "bucketed frontend": lambda: extract_audio_features_bucketed(
        np.zeros(44100, np.float32)),
    "BlendshapeStreamer": lambda: BlendshapeStreamer(_cpu_model(), CFG),
    "MultiStreamer": lambda: MultiStreamer(_cpu_model(), CFG),
    "server.serve": lambda: serve(_cpu_model(), CFG, port=0),
    "server.main": lambda: server_main(["--model", str(TINY)]),
    "rank_device": lambda: rank_device(),
    "initialize_distributed": lambda: initialize_distributed(
        init_method="file:///nonexistent/store", num_processes=1,
        process_id=0),
    "train.main --coordinator": lambda: train_main(
        ["--tiny", "--coordinator", "127.0.0.1:1", "--num_processes", "1",
         "--process_id", "0"]),
    # the runnable scripts, as `python -m ...` runs them without --device
    **{f"bench --mode {mode}": (lambda mode=mode: bench.cli(
        ["--mode", mode, "--tiny"])) for mode in bench.MODES},
    "tools.serving_soak": lambda: serving_soak.main(["x", "--tiny"]),
    "tools.serving_knee": lambda: serving_knee.main(["x", "--tiny"]),
    "tools.warmup_probe": lambda: warmup_probe.main(["--tiny"]),
    "tools.local_dispatch_probe": lambda: local_dispatch_probe.main(
        ["--sessions", "2", "--ticks", "1"]),
    "tools.step_probe": lambda: step_probe.main(["x", "--tiny"]),
    "tools.data_scale_probe --measure": lambda: data_scale_probe.main(
        ["--measure", "/nonexistent"]),
    "tools.train_scale_run": lambda: train_scale_run.main(
        ["--root", "/nonexistent", "--tiny"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_on_a_cpu_only_machine(no_cuda, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_api_refuses_a_model_on_another_device():
    wav = audio_to_bytes(np.zeros(44100), 88200)
    with pytest.raises(ValueError, match="model weights are on cpu"):
        generate_facial_data_from_bytes(wav, _cpu_model(), CFG, device="cuda")


@pytest.mark.parametrize("entry", ["BlendshapeStreamer", "MultiStreamer",
                                   "server.serve"])
def test_live_serving_refuses_a_model_on_another_device(entry):
    make = {"BlendshapeStreamer": BlendshapeStreamer,
            "MultiStreamer": MultiStreamer,
            "server.serve": lambda m, c, device: serve(m, c, port=0,
                                                       device=device)}[entry]
    with pytest.raises(ValueError, match="model weights are on cpu"):
        make(_cpu_model(), CFG, device="cuda")


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    x = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rope_rotate_cuda(x, *rope_tables(8, 64, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        fused_rope_attention_cuda(x, x, x, make_tables(8, 8, 16, 4, "cpu"),
                                  4, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        fused_rope_attention_bwd_cuda(x, x, x, x,
                                      make_tables(8, 8, 16, 4, "cpu"), 4, 0.25)
    x4 = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x4, x4, x4, 0.25)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(x4, x4, x4, x4, 0.25)
    xb = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ffn_bwd_dh1_cuda(xb, xb.t().contiguous(), torch.zeros(
            8, 8, dtype=torch.bfloat16), scale=1.0)

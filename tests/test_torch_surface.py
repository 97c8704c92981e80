"""The port does everything the JAX package does: every public name of the
JAX package has a counterpart at the same path in the port, or an entry in
the map below that names what replaces it or why it does not apply.

The JAX package is read with ast, never imported, for this walk. A public
name is a top-level function, class or assignment of a JAX module whose
name does not start with an underscore; each subpackage's __all__ too.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "neurosync_trainer_lite_tpu"
PORT = "neurosync_trainer_lite_tpu_torch"

#: JAX modules with no port module at the same path
MODULES = {
    "ops/rope_pallas.py": "K1's Pallas kernel: ops/rope_kernel.py "
                          "(rope_rotate, csrc/rope.cu)",
    "ops/ffn_bwd_pallas.py": "K2's Pallas kernel: ops/ffn_bwd.py "
                             "(ffn_bwd_dh1, ffn_fused, csrc/ffn_bwd.cu)",
    "utils/torch_interop.py": "folded into utils/weights.py, whose "
                              "docstring maps each name",
    "utils/compilation_cache.py": "not applicable: eager PyTorch compiles "
                                  "no programs; the nvcc builds cache in "
                                  "build/torch_kernels/ by a hash of their "
                                  "sources (ops/kernels.py)",
}

#: public JAX names with no port name at the same path
NAMES = {
    "inference/api.py": {
        "reset_device_pipeline_breaker": "not applicable: the port has no "
        "device-pipeline breaker (no fallback; inference/api.py)",
    },
    "models/seq2seq.py": {
        "seq2seq_apply": "the Seq2Seq module's forward",
        "encoder_apply": "the Encoder module's forward",
        "decoder_apply": "the Decoder module's forward",
    },
    "ops/attention.py": {
        "SDPA_LEAN": "a TPU ablation switch for tools/tpu_probe.py; the "
                     "lean attention core is always on",
    },
    "ops/flash_attention.py": {
        "Q_BLOCK": "the Pallas query tile; csrc/flash_attention.cu has its "
                   "own tiles",
    },
    "ops/fused_attention.py": {
        "VMEM_BUDGET": "the TPU VMEM gate: SMEM_BUDGET",
        "fits_vmem": "the TPU VMEM gate: fits_smem",
        "MAX_KV_LEN": "a legacy bound the JAX gate supersedes: fits_smem",
    },
    "ops/frontend.py": {
        "extract_audio_features_jax": "extract_audio_features, the frontend "
                                      "on the device",
    },
    "ops/frontend_np.py": {
        name: "the numpy host twin of the frontend, not ported under the "
              "no-fallback rule; the torch frontend runs on the CPU with "
              "device='cpu'"
        for name in ("frame_signal", "power_spectrogram", "power_to_db",
                     "mfcc", "cmvn", "delta", "smooth_features",
                     "reduce_features", "mfcc_features",
                     "compute_autocorr_with_deltas", "autocorr_features",
                     "extract_audio_features_np")
    },
    "parallel/distributed.py": {
        "host_put": "jax.Array placement; a rank holds its own tensors",
        "assemble_sharded_batch": "global-array assembly; each rank gathers "
                                  "its rows (data/windowing.py)",
        "needs_cross_host_gather": "gather_state_dict is always collective",
        "host_local_params": "gather_state_dict",
    },
    "parallel/mesh.py": {
        "param_shardings": "param_specs",
        "batch_sharding": "batch_rows",
        "replicated": "param_spec's None",
        "shard_params": "shard_state_dict",
    },
    "training/step.py": {
        "state_shardings": "param_specs: the optimizer's moments follow "
                           "their parameters (shard_optimizer_state)",
        "shard_state": "init_train_state with a mesh keeps each rank's "
                       "shard",
    },
}


def _public_names(path: Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _dunder_all(path: Path) -> list[str]:
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _module_name(rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([PORT, *parts])


JAX_MODULES = sorted(p.relative_to(JAX_PKG).as_posix()
                     for p in JAX_PKG.rglob("*.py"))
SUBPACKAGES = sorted(p for p in JAX_MODULES if p.endswith("__init__.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(rel):
    names = _public_names(JAX_PKG / rel)
    if rel in MODULES:
        assert not (REPO / PORT / rel).exists(), (
            f"{rel} is mapped as replaced but the port has the module")
        return
    port = importlib.import_module(_module_name(Path(rel)))
    mapped = NAMES.get(rel, {})
    missing = sorted(n for n in names
                     if not hasattr(port, n) and n not in mapped)
    assert not missing, f"{rel}: no port counterpart for {missing}"
    stale = sorted(n for n in mapped if hasattr(port, n) or n not in names)
    assert not stale, f"{rel}: mapped names that the port has, or that " \
                      f"the JAX module lacks: {stale}"


@pytest.mark.parametrize("rel", SUBPACKAGES)
def test_every_subpackage_export_is_importable(rel):
    """`from neurosync_trainer_lite_tpu.X import name` works with the
    port's package name, or the name is mapped."""
    port = importlib.import_module(_module_name(Path(rel)))
    mapped = {name for names in NAMES.values() for name in names}
    missing = [n for n in _dunder_all(JAX_PKG / rel)
               if n not in mapped and not hasattr(port, n)]
    assert not missing, f"{rel}: __all__ names the port lacks: {missing}"
    assert set(getattr(port, "__all__", [])) >= (
        set(_dunder_all(JAX_PKG / rel)) - mapped)


def test_the_maps_name_jax_modules():
    assert set(MODULES) <= set(JAX_MODULES)
    assert set(NAMES) <= set(JAX_MODULES)

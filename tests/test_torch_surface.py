"""The port does everything the JAX package does: every public name of the
JAX package has a counterpart at the same path in the port, or an entry in
the map below that names what replaces it or why it does not apply.

The JAX package is read with ast, never imported, for this walk. A public
name is a top-level function, class or assignment of a JAX module whose
name does not start with an underscore; each subpackage's __all__ too.

Three more walks, with their own maps: the repo's runnable scripts outside
the package (bench.py, tools/, __graft_entry__.py), each ported into the
port's bench.py or tools/ or mapped; every argparse flag (and choice) of a
ported script, kept or mapped; and every parameter of every public JAX
function, class constructor and method that has a counterpart, present
in the port, renamed, or mapped with its reason.
"""

import ast
import importlib
import inspect
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
                             "(ffn_bwd_dh1, csrc/ffn_bwd.cu); its "
                             "ffn_lean_core_fused and ffn_fused are "
                             "models/layers.py's FFN core with k2 and "
                             "ffn_fused",
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


# ---------------------------------------------------------------------------
# the repo's runnable scripts outside the package

SCRIPTS = REPO / "tools"
#: root scripts (JAX) → their port counterpart, a module path in the port
PORTED_SCRIPTS = {
    "bench.py": "bench.py",
    "tools/_serving_harness.py": "tools/_serving_harness.py",
    "tools/serving_soak.py": "tools/serving_soak.py",
    "tools/serving_knee.py": "tools/serving_knee.py",
    "tools/warmup_probe.py": "tools/warmup_probe.py",
    "tools/local_dispatch_probe.py": "tools/local_dispatch_probe.py",
    "tools/tpu_probe.py": "tools/step_probe.py",
    "tools/data_scale_probe.py": "tools/data_scale_probe.py",
    "tools/train_scale_run.py": "tools/train_scale_run.py",
}
#: root scripts with no port counterpart, and why
MAPPED_SCRIPTS = {
    "tools/tpu_trace.py": "parses jax.profiler traces: the port's trace is "
                          "utils/profiling.py:profile_trace (torch.profiler), "
                          "read by chip_smoke.py's profile_once",
    "tools/serving_trace.py": "parses jax.profiler traces of the serving "
                              "tick: utils/profiling.py:profile_trace and "
                              "chip_smoke.py's profile_once over the live run",
    "tools/hlo_bytes.py": "reads XLA's optimized HLO; the port's bytes per "
                          "kernel are chip_smoke.py phase 5's bounds",
    "tools/check_freshness.py": "checks the JAX package's docs under docs/",
    "tools/make_frontend_goldens.py": "fixture producer: the port reads the "
                                      "committed fixtures as they are",
    "tools/make_golden_assets.py": "fixture producer (committed fixtures)",
    "tools/make_realspeech_goldens.py": "fixture producer (committed "
                                        "fixtures)",
    "tools/make_reference_fixture.py": "fixture producer from the original "
                                       "trainer (committed fixtures)",
    "tools/race_reference.py": "reads the original trainer from outside the "
                               "repository at run time: waits until it is "
                               "in the repository",
    "tools/real_capture_demo.py": "reads the original trainer's real capture "
                                  "pair from outside the repository at run "
                                  "time: waits until it is in the repository",
    "__graft_entry__.py": "the JAX forward and the virtual-mesh dry run: "
                          "chip_smoke.py phase 7 (the full-width forward) "
                          "and phases 12-13 (dp and tp over ranks)",
}
#: the only options a ported script adds: where it runs, and the CPU size
ADDED_FLAGS = {"--device", "--tiny"}
#: JAX script flags (and "--flag=choice" values) the port does not take
_PATCH = ("the JAX probe's ablation or prototype of a piece of the XLA "
          "program; eager PyTorch runs no XLA program")
MAPPED_FLAGS = {
    "tools/tpu_probe.py": {
        "--rng": "JAX's PRNG implementation (threefry or rbg); the port's "
                 "dropout seeds come from a torch.Generator",
        **{f"--rng={r}": "--rng's values" for r in ("threefry", "rbg")},
        "--unroll": "lax.scan's unroll factor of the layer scans; the port's "
                    "layers are a Python loop",
        "--cache": "XLA's persistent compile cache; the nvcc builds cache in "
                   "build/torch_kernels/ by a hash of their sources",
        "--ffn-bm": "the Pallas K2's tile rows; csrc/ffn_bwd.cu picks its "
                    "own tiles",
        "--ffn-bias": "ablates the Pallas K2's in-kernel bias sums; the "
                      "CUDA K2 always returns db2 and db1",
        "--unroll-residents": "Config.unroll_residents, semantics only in "
                              "the port (no scan to unroll)",
        **{f"--patch={p}": _PATCH for p in (
            "norope", "noln", "nosoftmax", "noattn", "noffn", "fastattn",
            "fusedqkv", "projonly", "notranspose", "attndrop-skip",
            "attndrop-bf16", "attn-fp32-chain", "ln-autodiff",
            "ffn-autodiff", "unroll-dec-tail", "unroll-remat-head",
            "sdpa-nonlean", "sdpa-lean-nosplit", "no-opt",
            "grads-bf16-stage", "no-gradnorm")},
    },
    "tools/serving_soak.py": {
        "--pressure": "fills XLA's executable cache to provoke an eviction "
                      "and recompile; eager PyTorch has no such cache (the "
                      "record keeps the key at 0)",
        "--pressure-every": "the cadence of --pressure (the record keeps "
                            "the key at None)",
    },
    "tools/train_scale_run.py": {
        "--platform": "--device (jax_platforms becomes a torch device)",
        "--platform=cpu": "--device cpu",
        "--platform=tpu": "--device cuda, the default",
    },
}


def _script_flags(path: Path) -> set[str]:
    """A script's argparse flags and positionals, and "--flag=choice" for
    each value of a flag's choices (bench.py: "--mode=<mode>" from its mode
    table, the JAX bench's hand-parsed --mode)."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            name = node.args[0].value
            flags.add(name)
            for kw in node.keywords:
                if kw.arg == "choices" and isinstance(kw.value, ast.Tuple):
                    flags |= {f"{name}={c.value}" for c in kw.value.elts}
        if (isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys)
                and {k.value for k in node.keys} >= {"train", "infer"}):
            flags |= {"--mode"} | {f"--mode={k.value}" for k in node.keys}
    return flags


def test_every_root_script_is_ported_or_mapped():
    scripts = {"bench.py", "__graft_entry__.py",
               *(p.relative_to(REPO).as_posix() for p in SCRIPTS.glob("*.py"))}
    assert not set(PORTED_SCRIPTS) & set(MAPPED_SCRIPTS)
    missing = sorted(scripts - set(PORTED_SCRIPTS) - set(MAPPED_SCRIPTS))
    assert not missing, f"root scripts with no port counterpart: {missing}"
    assert set(PORTED_SCRIPTS) | set(MAPPED_SCRIPTS) == scripts
    for port in PORTED_SCRIPTS.values():
        assert (REPO / PORT / port).is_file(), port
        importlib.import_module(_module_name(Path(port)))


@pytest.mark.parametrize("script", sorted(PORTED_SCRIPTS))
def test_every_flag_of_a_ported_script_is_kept_or_mapped(script):
    theirs = _script_flags(REPO / script)
    ours = _script_flags(REPO / PORT / PORTED_SCRIPTS[script])
    mapped = MAPPED_FLAGS.get(script, {})
    missing = sorted(theirs - ours - set(mapped))
    assert not missing, f"{script}: flags neither kept nor mapped: {missing}"
    stale = sorted(f for f in mapped if f not in theirs or f in ours)
    assert not stale, f"{script}: mapped flags the port has or JAX lacks"
    added = ours - theirs
    assert {f.split("=")[0] for f in added} <= ADDED_FLAGS, added


# ---------------------------------------------------------------------------
# parameters of the public JAX functions and classes

def _model(*names):
    return {n: {"params": "model"} for n in names}


#: JAX parameter → the port's name for it, by module and function (a
#: class's constructor as "Class", a method as "Class.method")
RENAMED = {
    "compat.py": _model("save_final_model", "prepare_training_components"),
    "inference/api.py": _model("generate_facial_data_from_bytes"),
    "inference/chunked.py": _model("decode_chunks_batched", "MeshDecoder",
                                   "process_audio_features"),
    "inference/device_pipeline.py": _model(
        "infer_waveform_device", "generate_facial_data_from_bytes_device"),
    "inference/multi_stream.py": _model("MultiStreamer"),
    "inference/server.py": _model("make_handler", "serve"),
    "inference/streaming.py": _model("BlendshapeStreamer"),
    "training/checkpoint.py": _model("save_final_model"),
    "training/validation.py": _model("generate_and_save_facial_data"),
    "models/seq2seq.py": {"init_seq2seq": {"key": "generator"},
                          "count_parameters": {"params": "model"},
                          # the dict {'scale', 'bias'} → weight and bias
                          "layer_norm": {"p": "weight"}},
    "ops/attention.py": {"dropout_keep": {"rng": "seed"},
                         "dropout": {"rng": "seed"},
                         "sdpa": {"rng": "seed"},
                         "multi_head_attention": {"params": "p",
                                                  "rng": "seed"}},
    "ops/flash_attention.py": {"supports": {"rng": "seed"}},
    "ops/fused_attention.py": {"make_tables": {"Tq": "tq", "Tk": "tk"}},
    "parallel/distributed.py": {
        "initialize_distributed": {"coordinator_address": "coordinator"}},
    "parallel/mesh.py": {"make_mesh": {"devices": "world"}},
    "training/loop.py": {"train_model": {"init_params": "init_state_dict"}},
    "training/step.py": {"TrainState": {"params": "model",
                                        "opt_state": "optimizer"},
                         "init_train_state": {"rng": "generator",
                                              "params": "state_dict"},
                         "opt_step_count": {"opt_state": "state"}},
    "utils/csv_io.py": {"pad_data": {"df1": "a", "df2": "b"}},
}
#: JAX parameters the port does not take, and why
MAPPED_PARAMS = {
    "data/processing.py": {"extract_audio_features": {
        "use_device": "False took the numpy host frontend, not ported (no "
                      "fallback); device='cpu' runs the torch frontend on "
                      "the host"}},
    "data/windowing.py": {
        "prefetch": {
            "put": "the host-to-card copy belongs to the consumer (to_device "
                   "on the step's stream): a copy from the prefetch thread "
                   "would race the step (module docstring)"},
        "WindowedDataset": {
            "indices": "no caller in either package passes a table: every "
                       "dataset holds its clips' stride-1 windows, and the "
                       "train/validation split is an index view over it "
                       "(_View)"}},
    "inference/multi_stream.py": {"MultiStreamer.warmup": {
        "parallel": "the JAX warmup's compile thread pool: nothing compiles "
                    "in eager PyTorch (module docstring)"}},
    "models/seq2seq.py": {"layer_norm": {
        "eps": "no caller in either package passes another eps: every "
               "LayerNorm of the model uses 1e-5, the port's _LN_EPS"}},
    "ops/fused_attention.py": {"fused_rope_attention": {
        "rope": "no caller in either package passes rope=False: the JAX "
                "model calls the kernel with the rotation on "
                "(ops/attention.py), as the port's does"}},
    "ops/rope.py": {"rope_tables": {
        "dtype": "the tables are fp32 always, the JAX docstring's own rule "
                 "(angles must not be quantized) and what K1 and K4 read; "
                 "every JAX caller passes fp32. The port's third parameter "
                 "is the device"}},
    "parallel/distributed.py": {"initialize_distributed": {
        "local_device_ids": "a PyTorch process drives one card: "
                            "rank_device picks cuda:{LOCAL_RANK}"}},
    "training/checkpoint.py": {"load_checkpoint": {
        "shardings": "mesh: every rank reads the checkpoint and keeps its "
                     "shard (shard_state_dict)"}},
    "training/optim.py": {"make_optimizer": {
        "steps_per_epoch": "the LR schedule is make_schedule(cfg, "
                           "steps_per_epoch), which init_train_state builds "
                           "and the step applies; torch's Adam takes the LR "
                           "a step (test_torch_training.py holds the "
                           "schedule to JAX's step by step)"}},
    "training/step.py": {"make_train_step": {
        "tx": "the optimizer lives in the TrainState (init_train_state)",
        "donate": "the step updates its state in place; nothing to donate"}},
}


def _signature_args(fn) -> list[str]:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs,
                            *((a.vararg,) if a.vararg else ()),
                            *((a.kwarg,) if a.kwarg else ()))
            if x.arg not in ("self", "cls")]


def _jax_signatures(path: Path) -> dict[str, list[str]]:
    """Public functions, and public classes' constructors (or dataclass
    fields) and public methods (properties skipped): name → parameters."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _signature_args(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            fields = [b.target.id for b in node.body
                      if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)]
            for b in node.body:
                if not isinstance(b, ast.FunctionDef) or any(
                        getattr(d, "id", "") == "property"
                        for d in b.decorator_list):
                    continue
                if b.name == "__init__":
                    out[node.name] = _signature_args(b)
                elif not b.name.startswith("_"):
                    out[f"{node.name}.{b.name}"] = _signature_args(b)
            if fields and node.name not in out:
                out[node.name] = fields
    return out


def _port_parameters(module, qualname: str):
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return set(inspect.signature(obj).parameters) - {"self", "cls"}


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in MODULES])
def test_every_parameter_of_a_public_jax_function_is_ported_or_mapped(rel):
    port = importlib.import_module(_module_name(Path(rel)))
    renamed, mapped = RENAMED.get(rel, {}), MAPPED_PARAMS.get(rel, {})
    missing, stale = [], []
    for name, params in _jax_signatures(JAX_PKG / rel).items():
        have = _port_parameters(port, name)
        if have is None:       # no counterpart: the name walk maps it
            continue
        for p in params:
            new = renamed.get(name, {}).get(p)
            if new is not None:
                if new not in have or p in have:
                    stale.append(f"{name}({p} → {new})")
            elif p in mapped.get(name, {}):
                if p in have:
                    stale.append(f"{name}({p})")
            elif p not in have:
                missing.append(f"{name}({p})")
    assert not missing, f"{rel}: JAX parameters neither ported nor " \
                        f"mapped: {missing}"
    assert not stale, f"{rel}: mapped parameters the port has: {stale}"


def test_the_parameter_maps_name_jax_parameters():
    for table in (RENAMED, MAPPED_PARAMS):
        for rel, functions in table.items():
            sigs = _jax_signatures(JAX_PKG / rel)
            for name, params in functions.items():
                assert set(params) <= set(sigs[name]), (rel, name)

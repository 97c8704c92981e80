"""The training loop (port of neurosync_trainer_lite_tpu/training/loop.py;
reference: train.py:12-58, training_utils.py:10-303).

Per epoch, as the reference and the JAX package:
- the seeded split's training windows in a seeded order (seed + epoch),
  drop_last batches; a validation batch every `validation_interval` steps
  (training_utils.py:95-113)
- per-epoch loss and gradient-norm plots (training_utils.py:120-127)
- per-epoch checkpoint with backup rotation, weights-only model.pth export,
  and fixed-wav validation artifacts (checkpoint_utils.py:53-57)
- the LR schedule stepped per epoch from the optimizer's own count

On the card: batches are gathered in a background thread into pinned host
memory and copied non-blocking on the step's stream (data/windowing.py).
Losses and grad norms stay on the device during the epoch and are fetched
with one sync at its end; a validation print syncs every
`validation_interval` steps. Each step's dropout generator is seeded from
(cfg.seed + 1, batch_step), as JAX folds batch_step into its key, so a
resumed run draws the masks the uninterrupted run drew.

Data parallelism (parallel/): with a process group up, or dp > 1, the run
builds the rank mesh. Every rank walks the same seeded batch order and
gathers only its rows of each batch (for training laid out for the
micro-batches, data/windowing.py:host_batches), the step all-reduces, and
the history (train and validation losses, grad norms) is the same on every
rank. Checkpoints are collective (training/checkpoint.py); plots, CSVs,
the fixed-wav validation and model.pth are written by rank 0 alone, each
behind a fence (parallel/distributed.py:fenced) that raises its failure on
every rank. The epoch's samples/s counts the global batch.

Tensor parallelism (tp > 1): the ranks of a 'model' group gather the same
rows and each trains its shard (training/step.py). The model.pth export
and the fixed-wav validation run on rank 0 from the full parameters,
gathered over 'model' once an epoch (_export_model, collective: the JAX
package's _export_view over host_local_params); checkpoints gather their
own (training/checkpoint.py). The auto-remat planner keeps the JAX
package's arithmetic, which counts the 'data' shards and ignores tp.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.windowing import (
    _View,
    host_batches,
    prefetch,
    prepare_datasets,
    to_device,
)
from neurosync_trainer_lite_tpu_torch.models.architectures import architecture
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    Seq2Seq,
    count_parameters,
)
from neurosync_trainer_lite_tpu_torch.parallel import distributed
from neurosync_trainer_lite_tpu_torch.parallel.mesh import resolve_mesh
from neurosync_trainer_lite_tpu_torch.training.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    save_final_model,
    wait_for_pending_saves,
)
from neurosync_trainer_lite_tpu_torch.training.step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    opt_step_count,
)
from neurosync_trainer_lite_tpu_torch.training.validation import (
    generate_and_save_facial_data,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device
from neurosync_trainer_lite_tpu_torch.utils.plots import (
    save_gradient_norm_plot,
    save_loss_plot,
)
from neurosync_trainer_lite_tpu_torch.utils.profiling import span


def step_generator(seed: int, batch_step: int) -> torch.Generator:
    """The dropout generator of step `batch_step`: a pure function of
    (seed, batch_step), as jax.random.fold_in(key(seed), batch_step)."""
    root = np.random.SeedSequence([seed, batch_step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(root) >> 1)


def _epoch_artifacts(epoch, train_steps, train_losses, val_steps, val_losses,
                     gradient_norms, plots_dir):
    save_loss_plot(epoch, train_steps, train_losses, val_steps, val_losses,
                   save_dir=os.path.join(plots_dir, "loss"))
    save_gradient_norm_plot(
        epoch, gradient_norms,
        save_dir=os.path.join(plots_dir, "gradient_norms"))


def train_one_epoch(epoch, state: TrainState, train_view, val_view,
                    cfg: Config, train_step, eval_step, *, batch_step=0,
                    device=None, mesh=None, plots_dir=None, verbose=True,
                    history_out=None):
    """Returns (state, batch_step, mean_epoch_loss). history_out: optional
    dict extended with 'train_losses', 'val_losses' and 'grad_norms' lists
    and this epoch's 'epoch_seconds', 'epoch_samples' (global rows),
    'batch_wait_seconds' (the loop's waits on the prefetch queue) and
    'gather_seconds' (the prefetch thread's gathers, batches gathered ahead
    of a bounded epoch's end included).

    Under a profiler the epoch records spans (utils/profiling.py:span):
    nsync.loop.epoch around it all; nsync.loop.batch_wait around each
    next() on the prefetch queue (one a step, and one more that finds the
    queue's end unless max_steps_per_epoch ends the epoch);
    nsync.loop.upload, nsync.loop.validation and nsync.loop.epoch_sync (the
    one device → host fetch)."""
    with span("nsync.loop.epoch"):
        return _train_one_epoch(
            epoch, state, train_view, val_view, cfg, train_step, eval_step,
            batch_step=batch_step, device=device, mesh=mesh,
            plots_dir=plots_dir, verbose=verbose, history_out=history_out)


def _train_one_epoch(epoch, state, train_view, val_view, cfg, train_step,
                     eval_step, *, batch_step, device, mesh, plots_dir,
                     verbose, history_out):
    device = resolve_device(device)
    pin = device.type == "cuda"
    train_losses, train_steps = [], []
    val_losses, val_steps = [], []
    gradient_norms = []
    start_time = time.perf_counter()

    def val_stream():
        return host_batches(val_view, cfg.batch_size, pin_memory=pin,
                            mesh=mesh, wrap=True)

    val_iter = val_stream() if val_view is not None and len(val_view) else None

    def next_val_batch():
        nonlocal val_iter
        try:
            return next(val_iter)
        except StopIteration:
            val_iter = val_stream()
            return next(val_iter)

    anneal = cfg.loss_variant == "smoothness" and cfg.smoothness_annealing
    n_batches = 0
    batch_wait, gather = 0.0, [0.0]
    batch_iter = prefetch(host_batches(
        train_view, cfg.batch_size, pin_memory=pin, mesh=mesh,
        accum=cfg.grad_accum_steps, busy=gather, shuffle=True,
        seed=cfg.seed + epoch, drop_last=True))
    for batch_idx in itertools.count():
        with span("nsync.loop.batch_wait"):
            wait_start = time.perf_counter()
            host = next(batch_iter, None)
            batch_wait += time.perf_counter() - wait_start
        if host is None:
            break
        with span("nsync.loop.upload"):
            src, trg = to_device(host, device)
        state, loss, grad_norm = train_step(
            state, src, trg, step_generator(cfg.seed + 1, batch_step))
        train_steps.append(batch_step)
        train_losses.append(loss)           # on the device until epoch end
        gradient_norms.append(grad_norm)
        batch_step += 1
        n_batches += 1

        if cfg.max_steps_per_epoch > 0 and n_batches >= cfg.max_steps_per_epoch:
            if verbose:
                print(f"[Epoch {epoch}] max_steps_per_epoch="
                      f"{cfg.max_steps_per_epoch} reached — ending epoch "
                      "early (bounded run)")
            break

        if val_iter is not None and batch_idx % cfg.validation_interval == 0:
            with span("nsync.loop.validation"):
                vsrc, vtrg = to_device(next_val_batch(), device)
                # the annealed loss keeps validation on the training loss's
                # alpha/beta scale through the optimizer's count
                vloss = eval_step(state.model, vsrc, vtrg,
                                  opt_step_count(state) if anneal else None)
            val_steps.append(batch_step)
            val_losses.append(vloss)
            if verbose:
                print(f"[Epoch {epoch} - Batch {batch_idx}] "
                      f"Validation Loss: {float(vloss):.4f} | "
                      f"Train Loss: {float(loss):.4f} | "
                      f"Grad Norm: {float(grad_norm):.4f}")

    def fetch(xs):   # one device → host copy (and sync) for the epoch
        return torch.stack(xs).float().cpu().tolist() if xs else []

    with span("nsync.loop.epoch_sync"):
        train_losses = fetch(train_losses)
        val_losses = fetch(val_losses)
        gradient_norms = fetch(gradient_norms)

    epoch_time = time.perf_counter() - start_time
    mean_loss = float(np.mean(train_losses)) if train_losses else float("nan")
    if verbose:
        print(f"Epoch [{epoch + 1}/{cfg.n_epochs}], Loss: {mean_loss:.4f}, "
              f"Time: {epoch_time:.2f} seconds "
              f"({n_batches * cfg.batch_size / max(epoch_time, 1e-9):.1f} "
              f"samples/s; batch wait {batch_wait:.2f} s, "
              f"gather {gather[0]:.2f} s)")

    with distributed.fenced("epoch-plots"):   # rank 0 alone plots
        if plots_dir is not None:
            _epoch_artifacts(epoch, train_steps, train_losses, val_steps,
                             val_losses, gradient_norms, plots_dir)

    if history_out is not None:
        history_out.setdefault("train_losses", []).extend(train_losses)
        history_out.setdefault("val_losses", []).extend(val_losses)
        history_out.setdefault("grad_norms", []).extend(gradient_norms)
        history_out.setdefault("epoch_seconds", []).append(epoch_time)
        history_out.setdefault("epoch_samples", []).append(
            n_batches * cfg.batch_size)
        history_out.setdefault("batch_wait_seconds", []).append(batch_wait)
        history_out.setdefault("gather_seconds", []).append(gather[0])

    return state, batch_step, mean_loss


def _activation_bytes(cfg: Config, n_data_shards: int = 1) -> int:
    """The JAX package's activation estimate of one no-remat train step
    (per device): bytes·B·T·H·60·n_layers, bytes the compute dtype's width
    (2 under bf16 AMP, 4 in fp32). Its coefficient was calibrated on a TPU
    and is kept as semantics: the H100's is not measured yet."""
    b = max(1, cfg.batch_size // max(1, n_data_shards))
    if cfg.grad_accum_steps > 1:
        b = max(1, b // cfg.grad_accum_steps)
    act_bytes = 2 if cfg.use_amp else 4
    return act_bytes * b * cfg.micro_batch_size * cfg.hidden_dim * (
        60 * cfg.n_layers)


def estimate_step_hbm_bytes(cfg: Config, n_data_shards: int = 1) -> int:
    """Rough peak device memory of one no-remat train step (per device):
    the activations (_activation_bytes) plus fp32 params, grads and Adam
    moments (16 bytes a parameter), and one more fp32 gradient buffer with
    grad accumulation. Used only to decide auto-remat."""
    n_params = (cfg.input_dim * cfg.hidden_dim
                + cfg.n_layers * 28 * cfg.hidden_dim * cfg.hidden_dim
                + cfg.hidden_dim * cfg.output_dim)
    total = _activation_bytes(cfg, n_data_shards) + 16 * n_params
    if cfg.grad_accum_steps > 1:
        total += 4 * n_params
    return total


def _device_hbm_limit(device: torch.device) -> int | None:
    """The card's memory in bytes; None off the card (no planning)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _local_device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else ""


def _residency_cap_and_coeff(cfg: Config, kind: str) -> tuple[int, str, float]:
    """(max resident decoder layers, where that came from, per-resident-layer
    memory coefficient as a share of the layer's _activation_bytes). The
    JAX package measured both on a TPU v5e only; every other device,
    the H100 included, takes its conservative branch until measured."""
    return cfg.n_layers - 1, (
        f"fit-derived (no measured cap for {kind or 'this device'})"), 1.25


def _maybe_auto_remat(cfg: Config, n_data_shards: int, verbose: bool,
                      device: torch.device) -> Config:
    """Turn on decoder-scope remat when the no-remat step's estimate does
    not fit 85% of the card's memory, keeping as many decoder layers
    resident as the spare allows; escalate to remat_scope='all' when even a
    fully rematted decoder does not fit (the JAX package's planner)."""
    if cfg.remat or not cfg.auto_remat:
        return cfg
    limit = _device_hbm_limit(device)
    if limit is None:
        return cfg
    need = estimate_step_hbm_bytes(cfg, n_data_shards)
    budget = 0.85 * limit
    if need <= budget:
        return cfg

    # decoder/encoder activation split ≈ 35/25 (two attentions against one
    # per layer, the same FFN: the estimator's 60·L)
    acts = _activation_bytes(cfg, n_data_shards)
    dec_acts = acts * 35 // 60
    cap, cap_src, resident_coeff = _residency_cap_and_coeff(
        cfg, _local_device_kind(device))
    per_resident_layer = resident_coeff * dec_acts / cfg.n_layers
    spare = budget - (need - dec_acts)
    if spare < 0:
        need_all = need - acts
        if verbose:
            print(f"auto-remat: estimated step needs ~{need/1e9:.1f} GB of "
                  f"~{limit/1e9:.1f} GB device memory and a rematted decoder "
                  f"alone isn't enough — enabling remat_scope='all' "
                  "(set auto_remat=False to override)")
            if need_all > budget:
                print(f"auto-remat: WARNING — even full remat estimates "
                      f"~{need_all/1e9:.1f} GB; consider grad_accum_steps "
                      "or a smaller batch_size")
        return cfg.replace(remat=True, remat_scope="all", remat_layers=-1)
    resident = int(max(0, min(cfg.n_layers - 1, cap,
                              spare // per_resident_layer)))
    remat_layers = (cfg.n_layers - resident) if resident > 0 else -1
    if verbose:
        print(f"auto-remat: estimated step needs ~{need/1e9:.1f} GB of "
              f"~{limit/1e9:.1f} GB device memory — enabling "
              f"remat_scope='decoder' "
              + (f"with {resident} resident decoder layer(s) "
                 f"(remat_layers={remat_layers}, residency cap {cap_src}) "
                 if resident else "")
              + "(set auto_remat=False to override)")
    return cfg.replace(remat=True, remat_scope="decoder",
                       remat_layers=remat_layers)


def _export_model(state: TrainState, cfg: Config, device):
    """Rank 0's full model for model.pth and the fixed-wav validation:
    state.model itself where it is whole, else the full parameters
    gathered over 'model' into a model of their own (collective: every
    rank calls it). None on the other ranks."""
    model = state.model
    if model.mesh is None:
        return model if distributed.rank() == 0 else None
    full = distributed.gather_state_dict(model, model.mesh)
    if full is None:
        return None
    whole = Seq2Seq(cfg, device)
    whole.load_state_dict(full["model"], strict=True)
    return whole


def train_model(cfg: Config, clips=None, *, mesh=None, verbose=True,
                save_artifacts=True, init_state_dict=None, split_indices=None,
                history_out=None, device=None):
    """End-to-end training (reference: train.py:12-58 + __main__:61-104).

    device: where to train (default: the card; the CPU only when asked).
    mesh: the rank mesh (default: the config's when dp > 1 or a process
    group is up, parallel/mesh.py:resolve_mesh); every rank calls this.
    init_state_dict: a reference-format state dict to start from instead of
    the seeded init (a model.pth, or JAX params through
    utils.weights.params_from_jax); ignored on resume.
    split_indices: (train_idx, val_idx) window-index arrays in place of the
    seeded split. Returns (state, batch_step).
    """
    mesh = resolve_mesh(cfg, mesh)
    device = resolve_device(device)
    if clips is None and distributed.is_multiprocess():
        # rank 0 extracts the features and writes their caches first, so
        # that every rank then reads the same cached values
        with distributed.fenced("feature-cache"):
            if distributed.rank() == 0:
                prepare_datasets(cfg, None, device)
    ds, train_view, val_view = prepare_datasets(cfg, clips, device)
    if split_indices is not None:
        train_idx, val_idx = split_indices
        train_view, val_view = _View(ds, train_idx), _View(ds, val_idx)
    if len(train_view) == 0:
        raise RuntimeError(
            f"no training windows: root_dir={cfg.root_dir!r} yielded zero "
            f"usable clips (each capture folder needs a facial CSV plus "
            f"audio/video or a cached audio_features.csv, and clips must be "
            f"≥{cfg.micro_batch_size} frames long)")
    if len(train_view) < cfg.batch_size:
        # drop_last batching would run zero steps an epoch and still export
        # a random-weights model.pth
        raise RuntimeError(
            f"batch_size={cfg.batch_size} exceeds the {len(train_view)} "
            f"training windows the dataset yields; every epoch would run "
            f"zero optimizer steps. Lower --batch_size (≤{len(train_view)}) "
            f"or add data.")
    steps_per_epoch = max(1, len(train_view) // cfg.batch_size)
    n_data_shards = 1 if mesh is None else mesh.dp
    save_ckpt = save_artifacts     # collective: every rank
    save_artifacts = save_artifacts and distributed.rank() == 0
    cfg = _maybe_auto_remat(cfg, n_data_shards, verbose, device)

    generator = (None if init_state_dict is not None else
                 torch.Generator(device=device).manual_seed(cfg.seed))
    state = init_train_state(cfg, steps_per_epoch, generator=generator,
                             device=device, state_dict=init_state_dict,
                             mesh=mesh)
    if verbose:   # the full model's, counting each sharded leaf whole
        print(f"Total number of parameters: "
              f"{count_parameters(state.model)}")
        if mesh is not None:
            print(f"Rank mesh: {mesh.shape}, data index {mesh.data_index}, "
                  f"model index {mesh.model_index}")

    start_epoch, batch_step = 0, 0
    if cfg.mode == "resume" and os.path.exists(cfg.checkpoint_path):
        start_epoch, batch_step, state = load_checkpoint(
            cfg.checkpoint_path, cfg, steps_per_epoch, device=device,
            mesh=mesh)
        start_epoch += 1
        if verbose:
            print(f"Resumed from {cfg.checkpoint_path} at epoch {start_epoch}")

    total_steps = max(2, steps_per_epoch * cfg.n_epochs)
    train_step = make_train_step(cfg, total_steps=total_steps, mesh=mesh)
    eval_step = make_eval_step(cfg, total_steps=total_steps, mesh=mesh)

    have_val_assets = (os.path.exists(cfg.audio_path)
                       and os.path.exists(cfg.ground_truth_path))
    if not architecture(cfg.architecture).served:
        # the fixed-wav validation serves the model
        have_val_assets = False
        if save_artifacts:
            print(f"per-epoch fixed-wav validation is off for the "
                  f"{cfg.architecture!r} architecture, which is not served")
    elif save_artifacts and not have_val_assets:
        print(f"WARNING: per-epoch validation is DISABLED — golden pair not "
              f"found (audio_path={cfg.audio_path!r} "
              f"exists={os.path.exists(cfg.audio_path)}, "
              f"ground_truth_path={cfg.ground_truth_path!r} "
              f"exists={os.path.exists(cfg.ground_truth_path)}). "
              f"No comparison stats/plots will be written.")

    for epoch in range(start_epoch, cfg.n_epochs):
        state, batch_step, _ = train_one_epoch(
            epoch, state, train_view, val_view, cfg, train_step, eval_step,
            batch_step=batch_step, device=device, mesh=mesh,
            plots_dir=cfg.plots_dir if save_artifacts else None,
            verbose=verbose, history_out=history_out)
        if save_ckpt:
            # the async writes take host snapshots first, then overlap the
            # validation below and the next epoch
            save_checkpoint(state, epoch, batch_step, cfg,
                            async_save=cfg.async_checkpoint)
        # rank 0's work; a failure there raises on every rank
        with distributed.fenced("epoch-artifacts"):
            export = _export_model(state, cfg, device) if save_ckpt else None
            if save_artifacts:
                save_final_model(export, cfg,
                                 async_save=cfg.async_checkpoint)
                if have_val_assets:
                    generate_and_save_facial_data(
                        epoch, cfg.audio_path, export,
                        cfg.ground_truth_path, cfg)
            del export

    if save_ckpt:
        # collective: an export that failed on rank 0 raises on every rank
        wait_for_pending_saves()
    with distributed.fenced("final-export"):
        export = _export_model(state, cfg, device) if save_ckpt else None
        if save_artifacts:
            # a synchronous final write: a good model.pth even if an
            # epoch's async export failed
            save_final_model(export, cfg)
    return state, batch_step

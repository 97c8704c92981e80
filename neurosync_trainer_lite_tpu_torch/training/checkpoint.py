"""Checkpoint/resume with rotating backups, plus reference-format export
(port of neurosync_trainer_lite_tpu/training/checkpoint.py).

The directory contract is the JAX package's (reference:
utils/checkpoint_utils.py:10-51): a checkpoint is a directory holding the
state and a ``meta.json`` with epoch, batch_step and the config, and
``meta.json`` present means the state is complete. On every save the
previous checkpoint moves into a timestamped ``backup_YYYYmmdd_HHMMSS``
sibling and the 5 newest backups are kept; a resume from a checkpoint
without meta.json falls back to the newest complete backup. A weights-only
``model.pth`` in the reference format is written each epoch.

The state is ``torch.save`` of the model's and the optimizer's state dicts
(``state.pt``) where the JAX package writes an Orbax directory: neither
package reads the other's checkpoint, and ``model.pth`` is the interchange
between them.

Async saves. JAX arrays are immutable, so the JAX package may serialise the
live state in the background. Here ``opt.step()`` updates parameters and
moments in place, so an async save first takes a host snapshot (device →
host copies, synchronised) and only then hands the write to a thread;
``wait_for_pending_saves`` joins it, then writes the deferred meta.json,
and raises if a write failed.

Multi-process jobs (parallel/distributed.py). Rank 0 writes the whole
state, and saving is collective: every rank calls save_checkpoint and
passes the barriers around the rotation (ckpt-pre-rotate,
ckpt-post-rotate) and after the write or, when async, its start
(ckpt-saved). Under data parallelism every rank holds the whole state;
under tensor parallelism rank 0's 'model' group first gathers the
parameters and Adam moments to rank 0's host, leaf by leaf
(distributed.gather_state_dict), so the file is the tp = 1 format
whatever the mesh, and load_checkpoint cuts each rank's shard from it
(training/step.py:init_train_state): a checkpoint saved at one tp
resumes at any other, as the JAX package's Orbax restore into any
state_shardings does. Failures are fenced across the ranks: the last two
barriers are all-reduces of a failure flag (distributed.fenced), and
wait_for_pending_saves does the same for the async writes, so a failed
rotation, write or export on rank 0 raises on every rank, where a lone
raise would strand the others at the next collective. The fences run on
the caller's thread of every rank, never on a writer thread. On resume every
rank reads the checkpoint (a shared filesystem, as the JAX package's Orbax
restore assumes), then takes rank 0's state (training/step.py).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from datetime import datetime

import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.parallel import distributed
from neurosync_trainer_lite_tpu_torch.parallel.mesh import Mesh
from neurosync_trainer_lite_tpu_torch.training.step import (
    TrainState,
    init_train_state,
)
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device
from neurosync_trainer_lite_tpu_torch.utils.weights import (
    load_model as load_pth,
)

_STATE_FILE = "state.pt"
_META_FILE = "meta.json"
_KEEP_BACKUPS = 5


class _Pending:
    """Writes in flight: their threads, their errors, and the meta.json
    files to write once they land."""

    def __init__(self):
        self.threads: list[threading.Thread] = []
        self.errors: list[BaseException] = []
        self.metas: list[tuple[str, dict]] = []


_pending = _Pending()


def _write_meta(path: str, meta: dict) -> None:
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=2)


def _to_host(obj):
    """A copy of obj with every tensor copied to the host (synchronised)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write_atomic(obj, path: str) -> None:
    """torch.save to path + '.tmp', then os.replace: a crash mid-write never
    truncates the previous file."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _in_background(write, *args) -> None:
    """Run write(*args) on a non-daemon thread (an interpreter exit finishes
    the write); its exception is raised by wait_for_pending_saves."""

    def run():
        try:
            write(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised when joined
            _pending.errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    _pending.threads.append(t)


def wait_for_pending_saves() -> None:
    """Block until every async checkpoint and model.pth write has landed,
    then write the deferred meta.json files. If a write failed, no deferred
    meta is written (a meta-less checkpoint stays recognisably incomplete,
    and resume falls back to the newest complete backup) and this raises.
    Collective in a multi-process job: a failure on any rank raises on
    every rank."""
    for t in _pending.threads:
        t.join()
    _pending.threads.clear()
    metas, _pending.metas = _pending.metas, []
    err = _pending.errors[0] if _pending.errors else None
    _pending.errors.clear()
    if err is None:
        try:
            for path, meta in metas:
                _write_meta(path, meta)
        except OSError as e:   # still reaches the fence below
            err = e
    failed = err is not None
    if distributed.is_multiprocess():
        failed = distributed.any_failed(failed)
    if failed:
        raise RuntimeError("async checkpoint save or model.pth export failed"
                           + ("" if err is not None else
                              " on another process")) from err


def _backups(parent: str) -> list[str]:
    """backup_* directories of `parent`, newest first."""
    if not os.path.isdir(parent):
        return []
    return sorted((d for d in os.listdir(parent) if d.startswith("backup_")),
                  key=lambda d: os.path.getmtime(os.path.join(parent, d)),
                  reverse=True)


def _rotate_backups(checkpoint_path: str) -> None:
    """Move an existing checkpoint into backup_<ts>/ and prune to 5
    (reference: checkpoint_utils.py:22-36)."""
    if not os.path.exists(checkpoint_path):
        return
    parent = os.path.dirname(checkpoint_path) or "."
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    backup_dir = os.path.join(parent, f"backup_{timestamp}")
    while os.path.exists(backup_dir):  # saves within one second
        timestamp += "x"
        backup_dir = os.path.join(parent, f"backup_{timestamp}")
    os.makedirs(backup_dir)
    shutil.move(checkpoint_path,
                os.path.join(backup_dir, os.path.basename(checkpoint_path)))
    for old in _backups(parent)[_KEEP_BACKUPS:]:
        shutil.rmtree(os.path.join(parent, old))


def save_checkpoint(state: TrainState, epoch: int, batch_step: int,
                    cfg: Config, checkpoint_path: str | None = None,
                    *, async_save: bool = False) -> str:
    """Save the model and optimizer state with its meta.json; returns the
    state file's path. async_save=True returns once the host snapshot is
    taken; the disk write overlaps the caller's work and meta.json follows
    in wait_for_pending_saves. Collective in a multi-process job: every
    rank calls it, rank 0 writes (the full state, gathered where the model
    is sharded)."""
    path = os.path.abspath(checkpoint_path or cfg.checkpoint_path)
    primary = distributed.rank() == 0
    wait_for_pending_saves()  # the previous save must land before rotating
    distributed.barrier("ckpt-pre-rotate")   # ...on every rank
    with distributed.fenced("ckpt-post-rotate"):
        if primary:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            _rotate_backups(path)
            os.makedirs(path)
    state_file = os.path.join(path, _STATE_FILE)
    # async: the snapshot and the thread's start; the write is fenced in
    # wait_for_pending_saves
    with distributed.fenced("ckpt-saved"):
        # rank 0's host snapshot; collective where the model is sharded
        snapshot = distributed.gather_state_dict(
            state.model, state.model.mesh, optimizer=state.optimizer)
        if primary:
            meta = {"epoch": epoch, "batch_step": batch_step,
                    "config": cfg.to_dict()}
            if async_save:
                _in_background(_write_atomic, snapshot, state_file)
                _pending.metas.append((path, meta))
            else:
                _write_atomic(snapshot, state_file)
                _write_meta(path, meta)
    return state_file


def _resolve_complete_checkpoint(path: str) -> str:
    """A checkpoint directory that has meta.json: `path` itself, or the
    newest complete backup_<ts>/ sibling. A crash during an async save
    leaves `path` without meta after the previous good checkpoint was
    rotated into a backup; resume then continues from that backup."""
    if os.path.exists(os.path.join(path, _META_FILE)):
        return path
    parent = os.path.dirname(path) or "."
    base = os.path.basename(path)
    for b in _backups(parent):
        cand = os.path.join(parent, b, base)
        if os.path.exists(os.path.join(cand, _META_FILE)):
            print(f"Checkpoint at {path} is incomplete (no {_META_FILE}; "
                  f"likely a crash mid-async-save) — resuming from backup "
                  f"{cand}")
            return cand
    raise FileNotFoundError(
        f"No complete checkpoint: {path} lacks {_META_FILE} and no "
        f"backup_* sibling contains one")


def _load_state(path: str) -> tuple[dict, dict]:
    """(meta, {'model', 'optimizer'}) of a complete checkpoint directory,
    tensors on the host."""
    path = _resolve_complete_checkpoint(os.path.abspath(path))
    if not os.path.exists(os.path.join(path, _STATE_FILE)):
        raise FileNotFoundError(
            f"{path} holds no {_STATE_FILE}: not a checkpoint of this "
            f"package (the JAX package's Orbax directories are not readable "
            f"here; load its model.pth export)")
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    return meta, blob


def load_checkpoint(checkpoint_path: str, cfg: Config, steps_per_epoch: int,
                    device=None, mesh: Mesh | None = None
                    ) -> tuple[int, int, TrainState]:
    """Returns (epoch, batch_step, TrainState) on `device` (default: the
    card). The optimizer's moments move to their parameters' device; its
    step counts stay on the host, as a fresh Adam keeps them. Under a mesh
    every rank reads the checkpoint and then takes rank 0's state; where
    the mesh shards the model, each rank keeps its shard of it."""
    meta, blob = _load_state(checkpoint_path)
    state = init_train_state(cfg, steps_per_epoch, device=device,
                             state_dict=blob["model"],
                             optimizer_state=blob["optimizer"], mesh=mesh)
    return meta["epoch"], meta["batch_step"], state


def save_final_model(model: torch.nn.Module, cfg: Config,
                     final_model_path: str | None = None, *,
                     async_save: bool = False) -> str:
    """Weights-only export in the reference's model.pth format (reference:
    model_utils.py:46-49): the fp32 state dict on the host, written to a
    temporary file and moved into place. async_save=True writes in a thread
    after the host snapshot; join with wait_for_pending_saves()."""
    path = final_model_path or cfg.model_path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    snapshot = _to_host(model.state_dict())
    if async_save:
        _in_background(_write_atomic, snapshot, path)
        return path
    _write_atomic(snapshot, path)
    print(f"Final model saved to {path}")
    return path


def load_model(model_path: str, cfg: Config, device=None):
    """A model in eval mode from a reference-format model.pth or from one of
    the port's checkpoint directories (weights only)."""
    if not os.path.isdir(model_path):
        return load_pth(model_path, cfg, device)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    _, blob = _load_state(model_path)
    model = Seq2Seq(cfg, resolve_device(device))
    model.load_state_dict(blob["model"], strict=True)
    return model.eval()

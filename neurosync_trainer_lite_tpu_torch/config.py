"""Typed training/inference configuration (the port's own copy).

Same field names and defaults as neurosync_trainer_lite_tpu/config.py, so a
config dict moves between the two packages unchanged. The serving path reads
the geometry (sr, input_dim, output_dim, frame_size, overlap, hidden_dim,
n_layers, num_heads), use_amp and attention_impl. The training step
(training/step.py) also reads dropout, learning_rate, weight_decay, n_epochs,
warmup_epochs, grad_clip, delta, w1-w4, zero_penalty_weight, loss_variant,
smoothness_annealing and grad_accum_steps; dp and tp are the sizes of
the 'data' and 'model' axes of the rank mesh (parallel/mesh.py: dp = -1
takes every rank over tp), batch_size must split into grad_accum_steps ·
dp equal shares (check_batch_split), and a rank of the 'model' axis holds
whole heads and an equal block of the FFN (check_tp_split). The model
reads remat, remat_scope, remat_layers
and remat_policy (per-layer torch.utils.checkpoint, models/seq2seq.py);
unroll_residents is semantics only there. The training loop and its data
(training/loop.py, data/windowing.py) read mode, auto_remat (the remat
planner), async_checkpoint (checkpoint and model.pth writes in a thread),
validation_interval, val_split, max_steps_per_epoch and the paths.
prng_impl is read by no module: it
picks JAX's PRNG implementation, which has no torch counterpart (dropout
seeds come from a torch.Generator, ops/attention.py). use_multi_gpu and
num_gpus are kept for the reference's config dict only.

attention_impl on the card: 'pallas' selects the fused RoPE-attention CUDA
kernels (ops/fused_attention.py) where their shared-memory gate holds and
the flash-attention kernels (ops/flash_attention.py) elsewhere; 'auto' the
flash kernels from a key length of 512; both only where attention dropout
is off, as in JAX. Everything else takes the composed path, whose RoPE
runs through the RoPE CUDA kernel (ops/rope_kernel.py).
"""

from __future__ import annotations

import dataclasses
import shutil
from dataclasses import dataclass, field
from typing import Any


def _resolve_ffmpeg() -> str:
    """Locate an ffmpeg binary; media decoding raises lazily if it is missing."""
    return shutil.which("ffmpeg") or "ffmpeg"


@dataclass(frozen=True)
class Config:
    # --- run mode -----------------------------------------------------------
    mode: str = "scratch"            # 'scratch' or 'resume'

    # --- audio / data geometry ---------------------------------------------
    sr: int = 88200                  # input sample rate
    frame_rate: int = 60             # output blendshape fps
    input_dim: int = 256             # 69 MFCC(+deltas) + 187 autocorr lags
    output_dim: int = 61             # ARKit blendshape count
    frame_size: int = 128            # inference chunk length (frames)
    micro_batch_size: int = 128      # training window length (frames)
    overlap: int = 16                # inference chunk overlap (frames)

    # --- model --------------------------------------------------------------
    hidden_dim: int = 1024
    n_layers: int = 8
    num_heads: int = 16
    dropout: float = 0.3

    # --- optimization --------------------------------------------------------
    batch_size: int = 128
    learning_rate: float = 5e-5
    weight_decay: float = 1e-5
    n_epochs: int = 50
    warmup_epochs: int = 0
    grad_clip: float = 2.0
    delta: float = 1.0
    w1: float = 1.0
    w2: float = 1.0
    w3: float = 1.0
    zero_penalty_weight: float = 0.0
    loss_variant: str = "standard"
    w4: float = 1.0
    smoothness_annealing: bool = False
    validation_interval: int = 20
    val_split: float = 0.1
    max_steps_per_epoch: int = 0
    grad_accum_steps: int = 1

    # --- mixed precision ------------------------------------------------------
    use_amp: bool = True             # True → bf16 compute over fp32 params

    # --- parallelism ----------------------------------------------------------
    use_multi_gpu: bool = False
    num_gpus: int = 1
    dp: int = -1
    tp: int = 1

    # --- paths ----------------------------------------------------------------
    ffmpeg_path: str = field(default_factory=_resolve_ffmpeg)
    root_dir: str = "dataset/data"
    model_path: str = "out/model.pth"
    audio_path: str = "dataset/test_set/audio.wav"
    ground_truth_path: str = "dataset/test_set/testset.csv"
    checkpoint_path: str = "out/checkpoints/checkpoint"
    plots_dir: str = "dataset/validation_plots"

    # --- knobs of the JAX package, kept for config compatibility ---------------
    seed: int = 0
    prng_impl: str = "rbg"
    remat: bool = False
    auto_remat: bool = True
    remat_policy: str = "full"
    remat_scope: str = "all"
    remat_layers: int = -1
    unroll_residents: bool = True
    attention_impl: str = "auto"     # 'auto' | 'xla' | 'pallas'
    async_checkpoint: bool = True

    # ---------------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.hidden_dim % self.num_heads:
            raise ValueError(f"hidden_dim {self.hidden_dim} is not a multiple "
                             f"of num_heads {self.num_heads}")
        return self.hidden_dim // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_dim

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        """Build from a reference-style config dict; unknown keys ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def check_batch_split(batch_size: int, accum: int, dp: int) -> None:
    """The JAX config's constraint: a batch splits into `accum` micro-batches
    of `dp` equal rank shares each."""
    if batch_size % (accum * dp):
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"grad_accum_steps * dp = {accum} * {dp}")


def check_tp_split(cfg: Config, tp: int) -> None:
    """A rank of the 'model' axis holds num_heads / tp whole heads and
    ffn_dim / tp columns of the FFN. One stated difference from JAX, whose
    GSPMD would split a head across devices: any other layout raises."""
    for what, n in (("num_heads", cfg.num_heads), ("ffn_dim", cfg.ffn_dim)):
        if n % tp:
            raise ValueError(f"{what} {n} is not a multiple of tp {tp}: a "
                             f"rank of the 'model' axis holds whole heads "
                             f"and an equal block of the FFN")


def tiny_config(**kw) -> Config:
    """4-layer/4-head fp32 geometry, small enough for the CPU."""
    base = dict(
        hidden_dim=128, n_layers=4, num_heads=4, dropout=0.0,
        batch_size=8, use_amp=False, n_epochs=2,
    )
    base.update(kw)
    return Config(**base)


def full_config(**kw) -> Config:
    """The 228M-class 8-layer/16-head model, bf16."""
    return Config(**kw)

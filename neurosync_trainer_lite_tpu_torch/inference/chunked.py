"""Chunked long-audio inference with overlap blending, in PyTorch.

Port of neurosync_trainer_lite_tpu/inference/chunked.py. Semantics are the
reference's: frame_size-frame chunks at stride frame_size - overlap,
reflect-padding of short chunks, a linear cross-fade of the trailing
`overlap` frames between consecutive chunks, a tail pass so the output has
as many frames as the input, and the ÷100 rescale.

All chunks go to the device as one batch and decode in one forward, at
the true chunk count: the JAX package pads the batch to a power of two to
bound XLA recompiles, which eager PyTorch does not have. The serial blend
runs on the host in numpy.

MeshDecoder decodes the chunks over the rank mesh (parallel/mesh.py):
SPMD, every rank calls it with the same chunks, as every JAX process must
in a multi-process job. Each 'model' group decodes its 'data' rows with
its shard of the model (the Megatron linears sum over 'model'), and an
all-gather over 'data' hands every rank the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config
from neurosync_trainer_lite_tpu_torch.data.processing import (
    BLENDSHAPE_SCALE,
    SPECIFIED_COLUMNS,
)
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.parallel.distributed import (
    all_gather_rows,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (
    model_sharded,
    shard_state_dict,
)
from neurosync_trainer_lite_tpu_torch.utils.device import module_device


def pad_audio_chunk(audio_chunk: np.ndarray, frame_length: int,
                    num_features: int) -> np.ndarray:
    """Append reflect-padding to reach frame_length rows."""
    if audio_chunk.shape[0] < frame_length:
        pad_length = frame_length - audio_chunk.shape[0]
        padding = np.pad(audio_chunk, ((0, pad_length), (0, 0)), mode="reflect")
        audio_chunk = np.vstack((audio_chunk, padding[-pad_length:, :num_features]))
    return audio_chunk


def blend_chunks(chunk1: np.ndarray, chunk2: np.ndarray,
                 overlap: int) -> np.ndarray:
    """Linear cross-fade of the overlapping region."""
    actual_overlap = min(overlap, len(chunk1), len(chunk2))
    if actual_overlap == 0:
        return np.vstack((chunk1, chunk2))
    blended = np.copy(chunk1)
    alpha = (np.arange(actual_overlap) / actual_overlap)[:, None]
    blended[-actual_overlap:] = (
        (1 - alpha) * chunk1[-actual_overlap:] + alpha * chunk2[:actual_overlap])
    return np.vstack((blended, chunk2[actual_overlap:]))


def zero_columns(data: np.ndarray) -> np.ndarray:
    """A copy with the known-noise Lite dims zeroed (reference:
    audio_processing.py:114-121, a research helper the serving path does
    not call)."""
    modified = np.copy(data)
    modified[:, list(SPECIFIED_COLUMNS)] = 0
    return modified


def add_specified_dimensions_back(modified_data: np.ndarray) -> np.ndarray:
    """Reduced outputs re-expanded to the original 68 dims, zeros in the
    removed columns (reference: audio_processing.py:123-140, a research
    helper). Its column list differs from zero_columns'; the reference's
    two lists are kept as they are."""
    original_dim = 68
    columns_to_remove = [0, 1, 2, 3, 4, 7, 8, 9, 10, 11,
                         51, 52, 53, 54, 55, 56, 57, 58, 59, 60]
    new_data = np.zeros((modified_data.shape[0], original_dim))
    remaining = [c for c in range(original_dim) if c not in columns_to_remove]
    new_data[:, remaining] = modified_data
    return new_data


def _chunk_starts(num_frames: int, frame_length: int, overlap: int):
    starts, start = [], 0
    while start < num_frames:
        starts.append(start)
        start += frame_length - overlap
    return starts


def chunk_plan(num_frames: int, frame_length: int, overlap: int):
    """(starts, per-chunk valid lengths, tail `remaining` frames or 0).

    Simulates the reference's accumulated length (each chunk after the first
    loses min(overlap, acc, chunk) frames to blending) to decide whether the
    tail pass decodes one extra chunk.
    """
    starts = _chunk_starts(num_frames, frame_length, overlap)
    lengths = [min(s + frame_length, num_frames) - s for s in starts]
    acc_len = lengths[0] if lengths else 0
    for L in lengths[1:]:
        acc_len += L - min(overlap, acc_len, L)
    remaining = max(0, num_frames - acc_len)
    return starts, lengths, remaining


def blend_decoded_chunks(decoded, lengths, remaining: int, overlap: int,
                         num_frames: int) -> np.ndarray:
    """Serial overlap blend of decoded chunks as the reference accumulates
    it, plus the tail and the ÷100 rescale.
    decoded: [N(+1 if remaining), frame_length, output_dim]."""
    acc = decoded[0][: lengths[0]]
    for i in range(1, len(lengths)):
        acc = blend_chunks(acc, decoded[i][: lengths[i]], overlap)
    outputs = [acc]
    if remaining > 0:
        outputs.append(decoded[-1][:remaining])

    final = np.concatenate(outputs, axis=0)[:num_frames]
    final[:, :61] /= BLENDSHAPE_SCALE
    return final


@torch.inference_mode()
def decode_chunks_batched(model, chunks: np.ndarray, cfg: Config) -> np.ndarray:
    """[N, frame_size, input_dim] host chunks → [N, frame_size, output_dim]
    float64 on the host: one upload, one forward, one download."""
    x = torch.from_numpy(np.ascontiguousarray(chunks, np.float32))
    out = model(x.to(module_device(model)))
    return out.cpu().numpy().astype(np.float64)


class MeshDecoder:
    """Serving decode over the rank mesh, with decode_chunks_batched's
    signature so it drops into process_audio_features:

        mesh = make_mesh(cfg)
        dec = MeshDecoder(model, cfg, mesh)
        frames = process_audio_features(feats, model, cfg, decode_batched=dec)

    SPMD: every rank of the mesh calls it with the same chunks. The
    constructor takes the full model and, where the mesh has a 'model'
    axis, keeps this rank's shard of it (parallel/mesh.py:
    shard_state_dict), as the JAX MeshDecoder places its params once. The
    batch is padded with zero chunks to a multiple of dp (no power-of-two
    bucket: the port decodes at the true chunk count), the 'model' group of
    data index r decodes rows [r·m, (r+1)·m), and an all-gather over
    'data' returns the whole [:n] to every rank. The model argument of
    __call__ is ignored (the constructor's is used), as the JAX
    MeshDecoder ignores its params argument."""

    def __init__(self, model, cfg: Config, mesh):
        if model_sharded(mesh):
            shard = Seq2Seq(cfg, module_device(model), mesh)
            shard.load_state_dict(shard_state_dict(model.state_dict(), cfg,
                                                   mesh), strict=True)
            model = shard.eval()
        self.model, self.cfg, self.mesh = model, cfg, mesh

    @torch.inference_mode()
    def __call__(self, params_or_model, chunks: np.ndarray,
                 cfg: Config | None = None) -> np.ndarray:
        n, dp = chunks.shape[0], self.mesh.dp
        m = -(-n // dp)
        if m * dp != n:
            chunks = np.concatenate(
                [chunks, np.zeros((m * dp - n, *chunks.shape[1:]),
                                  chunks.dtype)])
        r = self.mesh.data_index
        x = torch.from_numpy(np.ascontiguousarray(chunks[r * m:(r + 1) * m],
                                                  np.float32))
        out = all_gather_rows(self.model(x.to(module_device(self.model))),
                              self.mesh)
        return out[:n].cpu().numpy().astype(np.float64)


def process_audio_features(audio_features: np.ndarray, model,
                           cfg: Config, *,
                           decode_batched=decode_chunks_batched
                           ) -> np.ndarray:
    """features [T, input_dim] → blendshapes [T, output_dim];
    decode_batched(model, chunks, cfg) decodes the chunk batch (a
    MeshDecoder decodes it over the rank mesh)."""
    frame_length = cfg.frame_size
    overlap = cfg.overlap
    num_features = audio_features.shape[1]
    num_frames = audio_features.shape[0]

    starts, lengths, remaining = chunk_plan(num_frames, frame_length, overlap)

    chunk_list = [
        pad_audio_chunk(audio_features[s: s + frame_length], frame_length,
                        num_features)
        for s in starts
    ]
    if remaining > 0:
        chunk_list.append(
            pad_audio_chunk(audio_features[num_frames - remaining: num_frames],
                            frame_length, num_features))

    decoded = decode_batched(
        model, np.asarray(chunk_list, dtype=np.float32), cfg)

    return blend_decoded_chunks(decoded, lengths, remaining, overlap,
                                num_frames)

"""The architectures the port trains, keyed by Config.architecture: each
one's model class, seeded init and dataset, and whether it has a served
and a tensor-parallel form. The modules that treat architectures apart
(training/step.py, training/loop.py, data/windowing.py, config.py's
checks) read this table and compare no names.

- 'seq2seq': the NeuroSync Seq2Seq (models/seq2seq.py) over MFCC feature
  windows (data/windowing.py); served and tensor-parallel.
- 'wav2vec2': wav2vec 2.0 large (models/wav2vec2.py) over waveform windows
  cut in samples (data/waveform.py); trained only, data-parallel only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from neurosync_trainer_lite_tpu_torch.data.waveform import waveform_windows
from neurosync_trainer_lite_tpu_torch.data.windowing import feature_windows
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq, init_seq2seq
from neurosync_trainer_lite_tpu_torch.models.wav2vec2 import (
    Wav2Vec2,
    init_wav2vec2,
)


@dataclass(frozen=True)
class Architecture:
    model: type                 # (cfg, device, mesh) → the nn.Module
    init: Callable              # (cfg, generator, device, mesh) → a model
    dataset: Callable           # (cfg, clips, device) → a WindowedDataset
    served: bool                # the serving paths run it
    sharded: bool               # it has a tensor-parallel form (tp > 1)


ARCHITECTURES = {
    "seq2seq": Architecture(Seq2Seq, init_seq2seq, feature_windows,
                            served=True, sharded=True),
    "wav2vec2": Architecture(Wav2Vec2, init_wav2vec2, waveform_windows,
                             served=False, sharded=False),
}


def architecture(name: str) -> Architecture:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise ValueError(f"architecture {name!r} is not one of "
                         f"{tuple(ARCHITECTURES)}") from None

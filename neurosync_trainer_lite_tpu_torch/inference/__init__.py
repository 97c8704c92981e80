from neurosync_trainer_lite_tpu_torch.inference.api import (
    generate_facial_data_from_bytes,
    smooth_by_averaging_pairs,
)
from neurosync_trainer_lite_tpu_torch.inference.chunked import (
    process_audio_features,
)

__all__ = [
    "process_audio_features",
    "generate_facial_data_from_bytes",
    "smooth_by_averaging_pairs",
    "BlendshapeStreamer",
    "MultiStreamer",
]


def __getattr__(name):
    # lazy, as in the JAX package: the streamers are not needed by users of
    # the bytes API alone
    if name == "BlendshapeStreamer":
        from neurosync_trainer_lite_tpu_torch.inference.streaming import (
            BlendshapeStreamer)
        return BlendshapeStreamer
    if name == "MultiStreamer":
        from neurosync_trainer_lite_tpu_torch.inference.multi_stream import (
            MultiStreamer)
        return MultiStreamer
    raise AttributeError(name)

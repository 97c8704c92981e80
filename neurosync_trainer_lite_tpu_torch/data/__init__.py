from neurosync_trainer_lite_tpu_torch.data.processing import (
    collect_features,
    load_data,
)
from neurosync_trainer_lite_tpu_torch.data.windowing import (
    WindowedDataset,
    prepare_datasets,
)

__all__ = ["load_data", "collect_features", "WindowedDataset", "prepare_datasets"]

"""``python -m neurosync_trainer_lite_tpu_torch`` → the training CLI."""

from neurosync_trainer_lite_tpu_torch.train import main

if __name__ == "__main__":
    main()

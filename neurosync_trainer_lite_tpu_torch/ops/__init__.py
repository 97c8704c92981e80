from neurosync_trainer_lite_tpu_torch.ops.attention import multi_head_attention

__all__ = ["multi_head_attention"]

"""Seq2Seq stands where the JAX package exports its functional
seq2seq_apply, encoder_apply and decoder_apply: the port's model is an
nn.Module, and its forward is the apply."""

from neurosync_trainer_lite_tpu_torch.models.loss import loss_fn
from neurosync_trainer_lite_tpu_torch.models.seq2seq import (
    Seq2Seq,
    count_parameters,
    init_seq2seq,
)

__all__ = ["init_seq2seq", "Seq2Seq", "count_parameters", "loss_fn"]

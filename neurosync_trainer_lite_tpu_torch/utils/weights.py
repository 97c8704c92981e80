"""Weights in and out of the port's model.

Port of neurosync_trainer_lite_tpu/utils/torch_interop.py. The port's
modules carry the reference checkpoint's state-dict keys, so a reference
``model.pth`` loads with strict=True. ``params_from_jax`` maps the JAX
package's stacked parameter pytree, given as numpy arrays, onto those keys
(JAX linears are [in, out], torch's [out, in]), so both packages can run the
same weights.

The JAX module's names, and what takes their place here:
  params_to_state_dict, state_dict_to_params  the port's model already is
      a state dict (Seq2Seq.state_dict / load_state_dict); params_from_jax
      carries a JAX pytree in
  save_torch_model   training/checkpoint.py:save_final_model
  load_torch_model   load_model below
  torch_available    always true in the port

Key mapping (reference module names ← JAX pytree paths):
  encoder.embedding                               ← encoder/embedding
  encoder.transformer_encoder.{i}.self_attn.{q,k,v,out}_linear
                                                  ← encoder/layers/self_attn[i]
  encoder.transformer_encoder.{i}.ffn.linear{1,2} ← encoder/layers/ffn[i]
  encoder.transformer_encoder.{i}.norm{1,2}       ← encoder/layers/norm{1,2}[i]
  encoder.layer_norm                              ← encoder/norm
  decoder.transformer_decoder.{i}.self_attn       ← decoder/layers/self_attn[i]
  decoder.transformer_decoder.{i}.multihead_attn  ← decoder/layers/cross_attn[i]
  decoder.transformer_decoder.{i}.ffn, norm{1,2,3}
  decoder.fc_output, decoder.layer_norm
"""

from __future__ import annotations

import numpy as np
import torch

from neurosync_trainer_lite_tpu_torch.config import Config, check_servable
from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
from neurosync_trainer_lite_tpu_torch.utils.device import resolve_device

_ATTN_KEYS = {"q": "q_linear", "k": "k_linear", "v": "v_linear",
              "out": "out_linear"}


def load_model(path: str, cfg: Config, device=None) -> Seq2Seq:
    """A reference-format ``model.pth``, loaded strictly, in eval mode."""
    check_servable(cfg)
    device = resolve_device(device)
    sd = torch.load(path, map_location=device, weights_only=True)
    model = Seq2Seq(cfg, device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def params_from_jax(params_np, cfg: Config) -> dict[str, torch.Tensor]:
    """The JAX package's stacked pytree (numpy leaves) → the port's state dict
    of fp32 CPU tensors."""
    sd: dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32))

    def linear(prefix, p, i=None):
        w, b = (p["w"], p["b"]) if i is None else (p["w"][i], p["b"][i])
        put(f"{prefix}.weight", np.asarray(w).T)
        put(f"{prefix}.bias", b)

    def norm(prefix, p, i=None):
        s, b = (p["scale"], p["bias"]) if i is None else (p["scale"][i],
                                                          p["bias"][i])
        put(f"{prefix}.weight", s)
        put(f"{prefix}.bias", b)

    def attn(prefix, p, i):
        for ours, theirs in _ATTN_KEYS.items():
            linear(f"{prefix}.{theirs}", p[ours], i)

    e, d = params_np["encoder"], params_np["decoder"]
    el, dl = e["layers"], d["layers"]
    linear("encoder.embedding", e["embedding"])
    for i in range(cfg.n_layers):
        pre = f"encoder.transformer_encoder.{i}"
        attn(f"{pre}.self_attn", el["self_attn"], i)
        linear(f"{pre}.ffn.linear1", el["ffn"]["linear1"], i)
        linear(f"{pre}.ffn.linear2", el["ffn"]["linear2"], i)
        norm(f"{pre}.norm1", el["norm1"], i)
        norm(f"{pre}.norm2", el["norm2"], i)
    norm("encoder.layer_norm", e["norm"])
    for i in range(cfg.n_layers):
        pre = f"decoder.transformer_decoder.{i}"
        attn(f"{pre}.self_attn", dl["self_attn"], i)
        attn(f"{pre}.multihead_attn", dl["cross_attn"], i)
        linear(f"{pre}.ffn.linear1", dl["ffn"]["linear1"], i)
        linear(f"{pre}.ffn.linear2", dl["ffn"]["linear2"], i)
        norm(f"{pre}.norm1", dl["norm1"], i)
        norm(f"{pre}.norm2", dl["norm2"], i)
        norm(f"{pre}.norm3", dl["norm3"], i)
    linear("decoder.fc_output", d["fc_output"])
    norm("decoder.layer_norm", d["norm"])
    return sd

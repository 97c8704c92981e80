"""Operations and bytes of the NeuroSync Seq2Seq, counted from its shapes.

The architecture (the reference's ``utils/model.py``): a Linear embedding
input_dim → hidden, n_layers post-LN encoder layers (self-attention, ReLU
FFN of width ffn), a final LayerNorm; n_layers decoder layers over the
encoder output (self-attention, cross-attention on the encoder output, FFN),
a LayerNorm and a Linear hidden → output_dim. Every attention has four
hidden × hidden projections; the cross-attention's memory has as many
frames as the query.

Model FLOPs count each multiply-add as 2, the products only (the
elementwise work is a rounding error against them), and no recompute: what
the model needs, not what a program does again to save memory.
"""

from __future__ import annotations


def dims(config: dict) -> dict:
    """The widths of a configuration file's model (keys as Config's)."""
    hidden = int(config["hidden_dim"])
    return {"input_dim": int(config["input_dim"]), "hidden": hidden,
            "layers": int(config["n_layers"]),
            "heads": int(config["num_heads"]), "ffn": 4 * hidden,
            "output_dim": int(config["output_dim"])}


def parameter_count(d: dict) -> int:
    """Every parameter: weights, biases and LayerNorm scales and shifts."""
    h, f = d["hidden"], d["ffn"]
    attn = 4 * (h * h + h)
    ffn = h * f + f + f * h + h
    ln = 2 * h
    enc = attn + ffn + 2 * ln
    dec = 2 * attn + ffn + 3 * ln
    return ((d["input_dim"] * h + h) + d["layers"] * enc + ln
            + d["layers"] * dec + ln + (h * d["output_dim"] + d["output_dim"]))


def matmul_weights(d: dict) -> dict:
    """Weight elements of the products: the embedding's, and the rest."""
    h, f, L = d["hidden"], d["ffn"], d["layers"]
    body = L * (4 * h * h + 2 * h * f) + L * (8 * h * h + 2 * h * f)
    return {"embedding": d["input_dim"] * h,
            "rest": body + h * d["output_dim"]}


def attention_flops_per_frame(d: dict, frames: int) -> int:
    """Scores and weights·values of the 3·n_layers attentions, per query
    frame, forward: 2·T·H for QKᵀ and 2·T·H for PV, T keys a window."""
    return 3 * d["layers"] * 4 * frames * d["hidden"]


def forward_flops_per_frame(d: dict, frames: int) -> int:
    """One frame through the forward of a window of `frames` frames."""
    w = matmul_weights(d)
    return 2 * (w["embedding"] + w["rest"]) + attention_flops_per_frame(
        d, frames)


def train_flops_per_frame(d: dict, frames: int) -> int:
    """Forward, and a backward that takes both operands' gradients of every
    product but the embedding's input (data, which needs none): 6 per
    weight, 4 per embedding weight, three times the attention's forward."""
    w = matmul_weights(d)
    return (6 * w["rest"] + 4 * w["embedding"]
            + 3 * attention_flops_per_frame(d, frames))


def rope_bytes(rows: int, frames: int, width: int, elem_bytes: int) -> int:
    """Kernel K1 (the RoPE rotation) over x [rows, frames, width]: x read
    once and the result written once, in x's type, and its three fp32
    [frames, width] tables read once."""
    return 2 * rows * frames * width * elem_bytes + 3 * frames * width * 4

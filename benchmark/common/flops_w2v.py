"""Parameters and operations of wav2vec 2.0 large as the trainer trains it
(benchmark/reference/wav2vec2.py), counted from its shapes.

Model FLOPs count each multiply-add as 2, the products and convolutions
only, and no recompute. A training step of B windows:

- the frozen conv feature encoder: its forward alone (no gradient);
- the feature projection: forward, and the weight's gradient (its input,
  the frozen encoder's output, needs none): 4 per weight and frame;
- the positional conv, the 24 layers' products and the head: 6 per weight
  and frame (forward, the input's and the weight's gradients);
- attention: QKᵀ and PV, 4·T·H a frame and layer forward, three times that
  for a training step.
"""

from __future__ import annotations

from benchmark.reference.wav2vec2 import dims, encoder_frames  # noqa: F401


def parameter_count(d: dict) -> int:
    """Every parameter: weights, biases, LayerNorms, weight_g and weight_v."""
    h, f = d["hidden"], d["ffn"]
    n, c_in = 0, 1
    for c, k in zip(d["conv_dim"], d["conv_kernel"]):
        n += c * c_in * k + c + 2 * c
        c_in = c
    n += 2 * c_in + c_in * h + h
    n += d["pos_kernel"] + h * (h // d["pos_groups"]) * d["pos_kernel"] + h
    layer = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    n += d["layers"] * layer + 2 * h
    return n + h * d["output_dim"] + d["output_dim"]


def frozen_count(d: dict) -> int:
    """The conv feature encoder's parameters (0 where it trains)."""
    if not d["frozen"]:
        return 0
    n, c_in = 0, 1
    for c, k in zip(d["conv_dim"], d["conv_kernel"]):
        n += c * c_in * k + 3 * c
        c_in = c
    return n


def frontend_flops_per_window(d: dict) -> int:
    """The conv stack's forward for one window."""
    n, c_in = 0, 1
    for c, k, frames in zip(d["conv_dim"], d["conv_kernel"],
                            encoder_frames(d)):
        n += 2 * frames * c * c_in * k
        c_in = c
    return n


def pos_conv_forward_flops(rows: int, d: dict) -> int:
    """The grouped positional conv's forward over `rows` windows:
    2 · rows · T · H · (H / groups) · kernel; its dgrad and its wgrad each
    take as many again."""
    h = d["hidden"]
    return (2 * rows * d["frames"] * h * (h // d["pos_groups"])
            * d["pos_kernel"])


def _per_frame(d: dict) -> dict:
    h, f, L = d["hidden"], d["ffn"], d["layers"]
    return {"projection": 2 * d["conv_dim"][-1] * h,
            "dense": 2 * (L * (4 * h * h + 2 * h * f) + h * d["output_dim"]),
            "pos_conv": pos_conv_forward_flops(1, d) // d["frames"],
            "attention": L * 4 * d["frames"] * h}


def forward_flops_per_window(d: dict) -> int:
    """One window through the forward (an eval step's)."""
    p = _per_frame(d)
    return (frontend_flops_per_window(d)
            + d["frames"] * sum(p.values()))


def train_flops_per_window(d: dict) -> int:
    """One window through a training step: forward and backward."""
    p = _per_frame(d)
    trained = 2 * p["projection"] + 3 * (p["dense"] + p["pos_conv"]
                                         + p["attention"])
    return frontend_flops_per_window(d) + d["frames"] * trained

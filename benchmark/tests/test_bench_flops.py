"""The counts of common/flops.py against sums by hand for Config()."""

from benchmark.common import flops
from benchmark.common.harness import config

D = flops.dims(config("neurosync-228m-train"))


def test_parameters():
    h, f = 1024, 4096
    enc_layer = 4 * (h * h + h) + (h * f + f + f * h + h) + 2 * 2 * h
    dec_layer = 8 * (h * h + h) + (h * f + f + f * h + h) + 3 * 2 * h
    total = (256 * h + h) + 8 * enc_layer + 2 * h + 8 * dec_layer + 2 * h \
        + (h * 61 + 61)
    assert flops.parameter_count(D) == total == 235_472_957
    w = flops.matmul_weights(D)
    assert w["rest"] == 234_943_488          # 234.9M outside the embedding
    assert w["embedding"] == 262_144


def test_training_frame():
    per_layer_attn = 4 * 128 * 1024          # QKᵀ and PV a query frame
    attn = 24 * per_layer_attn
    want = 6 * 234_943_488 + 4 * 262_144 + 3 * attn
    assert flops.train_flops_per_frame(D, 128) == want == 1_448_458_240
    assert abs(want / 1e9 - 1.45) < 0.01


def test_serving_chunk():
    fwd = 2 * (234_943_488 + 262_144) + 24 * 4 * 128 * 1024
    assert flops.forward_flops_per_frame(D, 128) == fwd == 482_994_176
    assert 128 * fwd == 61_823_254_528      # one chunk of 128 frames


def test_k1_bytes():
    x = 128 * 128 * 1024 * 2                  # bf16 [128, 128, 1024]
    tables = 3 * 128 * 1024 * 4
    assert flops.rope_bytes(128, 128, 1024, 2) == 2 * x + tables \
        == 68_681_728

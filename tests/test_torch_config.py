"""The port's Config has the JAX Config's field names and defaults."""

import dataclasses

import pytest

from neurosync_trainer_lite_tpu import config as jcfg
from neurosync_trainer_lite_tpu_torch import config as tcfg


def _jax_fields(d: dict) -> dict:
    """A port config dict without the port's own fields (the wav2vec2
    architecture's, which the JAX package does not have)."""
    return {k: v for k, v in d.items() if k not in tcfg.WAV2VEC2_FIELDS}


def test_field_names_types_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jcfg.Config)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.Config)}
    assert list(jf) + list(tcfg.WAV2VEC2_FIELDS) == list(tf)
    for name in jf:
        assert jf[name].type == tf[name].type, name
    assert jcfg.Config().to_dict() == _jax_fields(tcfg.Config().to_dict())
    assert tcfg.Config().architecture == "seq2seq"


@pytest.mark.parametrize("factory", ["tiny_config", "full_config"])
def test_factories_match(factory):
    kw = {"n_layers": 3}
    assert (getattr(jcfg, factory)(**kw).to_dict()
            == _jax_fields(getattr(tcfg, factory)(**kw).to_dict()))


def test_derived_sizes_and_helpers():
    for hidden, heads in ((1024, 16), (64, 4), (96, 6)):
        j = jcfg.Config(hidden_dim=hidden, num_heads=heads)
        t = tcfg.Config(hidden_dim=hidden, num_heads=heads)
        assert (t.head_dim, t.ffn_dim) == (j.head_dim, j.ffn_dim)
    d = {"hidden_dim": 64, "not_a_field": 1, "sr": 44100}
    assert (_jax_fields(tcfg.Config.from_dict(d).to_dict())
            == jcfg.Config.from_dict(d).to_dict())
    assert tcfg.Config().replace(overlap=8).overlap == 8
    with pytest.raises(ValueError):
        tcfg.Config(hidden_dim=100, num_heads=16).head_dim

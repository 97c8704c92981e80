"""The port's tensor parallelism (the 'model' axis of the rank mesh, the
Megatron linears of parallel/tensor.py, the TP step, layout-free
checkpoints, MeshDecoder) against the JAX package and against the port at
tp = 1.

The JAX package runs its (dp, tp) mesh in this process, on the 8 virtual
CPU devices of tests/conftest.py. The port runs one process a rank: this
file doubles as its worker (`python tests/test_torch_tensor_parallel.py
worker SPEC RANK`), 2 ranks at (dp, tp) = (1, 2) and 4 at (2, 2), over
gloo through a file:// store, spawned by tests/test_torch_parallel.py:
spawn with its timeout; the process group's own timeout bounds a hang.

Geometry: tests/test_torch_parallel.py's GEOM (hidden 64, 2+2 layers, 4
heads: 2 a rank at tp = 2), fp32, windows of 16 frames, batch 8.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from neurosync_trainer_lite_tpu_torch.config import Config  # noqa: E402
from neurosync_trainer_lite_tpu_torch.parallel import (  # noqa: E402
    batch_rows,
    distributed,
    make_mesh,
    tensor,
)
from neurosync_trainer_lite_tpu_torch.parallel.mesh import (  # noqa: E402
    param_spec,
    param_specs,
    shard_state_dict,
)
from tests.test_torch_parallel import (  # noqa: E402
    GEOM,
    GROUP_TIMEOUT,
    STEPS,
    assert_ranks_bitwise_equal,
    batch,
    params,
    port_steps,
    results,
    spawn,
)

#: the 'model' all-reduces of one step at GEOM's 2+2 layers: a row-parallel
#: linear's forward (2 an encoder layer, 3 a decoder layer), a column-
#: parallel linear's backward (4 and 7), and the grad norm's
STEP_COLLECTIVES = {"forward": 2 * 2 + 2 * 3, "backward": 2 * 4 + 2 * 7,
                    "grad_norm": 1}


def tp_cfg(case: dict, tp: int = 2) -> Config:
    return Config(**{**GEOM, **case.get("cfg", {}), "tp": tp})


# ---------------------------------------------------------------------------
# the worker: one rank


def _case_steps(case, rank, spec, init, mesh):
    from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq

    cfg = tp_cfg(case, mesh.tp)
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    plain_ffn = seq2seq._ffn
    if case.get("ffn_fused"):
        seq2seq._ffn = layers.ffn_fused
    tensor.reset_collectives()
    try:
        losses, norms, sd, _ = port_steps(cfg, init, src, trg, mesh=mesh)
    finally:
        seq2seq._ffn = plain_ffn
    return {"losses": losses, "norms": norms,
            "collectives": json.dumps(dict(tensor.COLLECTIVES)),
            **{f"p:{k}": v.float().numpy() for k, v in sd.items()}}


def _case_gather(case, rank, spec, init, mesh):
    """shard_state_dict of the full weights, loaded into this rank's shard
    of the model, gathered back (rank 0 keeps the result); then 2 steps
    and the Adam moments gathered too."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_train_step)

    cfg = tp_cfg(case, mesh.tp)
    model = Seq2Seq(cfg, "cpu", mesh)
    model.load_state_dict(shard_state_dict(init, cfg, mesh), strict=True)
    out = {f"shape:{k}": np.asarray(v.shape)
           for k, v in model.state_dict().items()}
    full = distributed.gather_state_dict(model, mesh)
    if full is not None:
        out.update({f"g:{k}": v.numpy() for k, v in full["model"].items()})
    src, trg = batch(5, cfg.batch_size, cfg)
    state = init_train_state(cfg, 10, device="cpu", state_dict=init,
                             mesh=mesh)
    step = make_train_step(cfg, mesh=mesh)
    rows = batch_rows(mesh, cfg.batch_size)
    for i in range(2):
        step(state, torch.from_numpy(src[rows]), torch.from_numpy(trg[rows]),
             torch.Generator().manual_seed(i))
    full = distributed.gather_state_dict(state.model, mesh,
                                         optimizer=state.optimizer)
    if full is not None:
        out.update({f"m:{k}": v.numpy() for k, v in full["model"].items()})
        for i, s in full["optimizer"]["state"].items():
            for k, v in s.items():
                out[f"o:{i}:{k}"] = v.numpy()
    return out


def _case_eval(case, rank, spec, init, mesh):
    from neurosync_trainer_lite_tpu_torch.training.step import (
        init_train_state, make_eval_step)

    cfg = tp_cfg(case, mesh.tp)
    src, trg = batch(4, cfg.batch_size, cfg)
    state = init_train_state(cfg, 10, device="cpu", state_dict=init,
                             mesh=mesh)
    rows = batch_rows(mesh, cfg.batch_size)
    tensor.reset_collectives()
    loss = make_eval_step(cfg, mesh=mesh)(state.model,
                                          torch.from_numpy(src[rows]),
                                          torch.from_numpy(trg[rows]))
    return {"loss": float(loss),
            "collectives": json.dumps(dict(tensor.COLLECTIVES))}


def _case_ckpt(case, rank, spec, init, mesh):
    """Resume at tp = 2 from the tp = 1 checkpoint the parent wrote, one
    step; then 2 steps from the initial weights, saved at tp = 2 for the
    parent to resume at tp = 1."""
    from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt

    cfg = tp_cfg(case, mesh.tp)
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    rows = batch_rows(mesh, cfg.batch_size)
    s, t = torch.from_numpy(src[rows]), torch.from_numpy(trg[rows])
    from neurosync_trainer_lite_tpu_torch.training.step import (
        make_train_step)

    step = make_train_step(cfg, mesh=mesh)
    epoch, bstep, state = ckpt.load_checkpoint(
        os.path.join(spec["out"], "ck_tp1", "checkpoint"), cfg, 10,
        device="cpu", mesh=mesh)
    _, loss, norm = step(state, s, t, torch.Generator().manual_seed(102))
    _, _, _, state = port_steps(cfg, init, src, trg, mesh=mesh, steps=2)
    ckpt.save_checkpoint(state, 1, 2, cfg,
                         os.path.join(spec["out"], "ck_tp2", "checkpoint"))
    return {"resumed": [epoch, bstep], "loss": float(loss),
            "norm": float(norm)}


def _case_decode(case, rank, spec, init, mesh):
    from neurosync_trainer_lite_tpu_torch.inference.chunked import (
        MeshDecoder, process_audio_features)
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    cfg = tp_cfg(case, mesh.tp)
    model = Seq2Seq(cfg, "cpu")
    model.load_state_dict(init, strict=True)
    model.eval()
    arrays = np.load(os.path.join(spec["out"], "decode_in.npz"))
    dec = MeshDecoder(model, cfg, mesh)
    return {"chunks": dec(model, arrays["chunks"], cfg),
            "frames": process_audio_features(arrays["feats"], model, cfg,
                                             decode_batched=dec)}


CASES = {"steps": _case_steps, "gather": _case_gather, "eval": _case_eval,
         "ckpt": _case_ckpt, "decode": _case_decode}


def worker(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    init = {k: torch.from_numpy(v) for k, v in np.load(spec["init"]).items()}
    distributed.initialize_distributed(
        init_method=f"file://{spec['store']}", num_processes=spec["world"],
        process_id=rank, device="cpu", timeout_s=GROUP_TIMEOUT)
    try:
        mesh = make_mesh(Config(**GEOM, dp=spec["dp"], tp=spec["tp"]))
        for case in spec["cases"]:
            out = CASES[case["kind"]](case, rank, spec, init, mesh)
            np.savez(os.path.join(spec["out"], f"{case['name']}_r{rank}.npz"),
                     **out)
    finally:
        distributed.destroy()


# ---------------------------------------------------------------------------
# the parent: spawn, then compare

DROP = {"dropout": 0.3}
ACCUM = {"batch_size": 16, "grad_accum_steps": 2}
TP2_CASES = [
    {"kind": "steps", "name": "auto", "seed": 3},
    {"kind": "steps", "name": "pallas", "seed": 3,
     "cfg": {"attention_impl": "pallas"}},
    {"kind": "steps", "name": "drop", "seed": 3, "cfg": DROP},
    {"kind": "steps", "name": "drop_accum", "seed": 1,
     "cfg": {**DROP, **ACCUM}},
    {"kind": "steps", "name": "remat", "seed": 3,
     "cfg": {**DROP, "remat": True}},
    {"kind": "steps", "name": "remat_dots", "seed": 3,
     "cfg": {**DROP, "remat": True, "remat_policy": "dots"}},
    {"kind": "steps", "name": "drop_bf16", "seed": 3,
     "cfg": {**DROP, "use_amp": True}},
    {"kind": "steps", "name": "remat_dots_bf16", "seed": 3,
     "cfg": {**DROP, "use_amp": True, "remat": True,
             "remat_policy": "dots"}},
    {"kind": "steps", "name": "window512", "seed": 2,
     "cfg": {"micro_batch_size": 512, "batch_size": 2}},
    {"kind": "steps", "name": "k2_bf16", "seed": 3, "ffn_fused": True,
     "cfg": {**DROP, "use_amp": True}},
    {"kind": "gather", "name": "gather"},
    {"kind": "eval", "name": "eval"},
    {"kind": "ckpt", "name": "ckpt", "seed": 5},
    {"kind": "decode", "name": "decode"},
]
DP2TP2_CASES = [TP2_CASES[0], TP2_CASES[1], TP2_CASES[2],
                {"kind": "gather", "name": "gather"},
                {"kind": "decode", "name": "decode"}]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_init():
    """JAX's seeded init, as numpy leaves, and the port's state dict of it."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)

    jparams = jax.tree.map(np.asarray, init_seq2seq(jax.random.PRNGKey(1),
                                                    JConfig(**GEOM)))
    return jparams, params_from_jax(jparams, Config(**GEOM))


def decode_inputs(out: Path) -> dict:
    """5 chunks (an odd count) and 150 frames of features, as tests/
    test_inference.py:122."""
    rng = np.random.default_rng(6)
    cfg = Config(**GEOM)
    arrays = {"chunks": rng.standard_normal(
                  (5, cfg.frame_size, cfg.input_dim)).astype(np.float32),
              "feats": rng.standard_normal(
                  (150, cfg.input_dim)).astype(np.float32)}
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "decode_in.npz", **arrays)
    return arrays


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_init):
    """The (1, 2) and the (2, 2) runs: {(dp, tp): out directory}. Before
    them, the port at tp = 1 writes the checkpoint the tp = 2 ranks resume
    from."""
    from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt

    _, init = jax_init
    runs = {}
    for (dp, tp), cases in (((1, 2), TP2_CASES), ((2, 2), DP2TP2_CASES)):
        out = tmp_path_factory.mktemp(f"dp{dp}tp{tp}")
        decode_inputs(out)
        if tp == 2 and dp == 1:
            cfg = Config(**GEOM)
            src, trg = batch(5, cfg.batch_size, cfg)
            *_, state = port_steps(cfg, init, src, trg, steps=2)
            ckpt.save_checkpoint(state, 1, 2, cfg,
                                 str(out / "ck_tp1" / "checkpoint"))
        spawn(Path(__file__), out, dp * tp, cases, init,
              extra={"dp": dp, "tp": tp})
        runs[dp, tp] = out
    return runs


def jax_mesh_steps(overrides: dict, dp: int, tp: int, jparams, src, trg):
    """STEPS JAX steps on a (dp, tp) mesh of the virtual devices: the state
    placed by shard_state (Megatron rules over 'model'), batches over
    'data' (tests/test_training.py:105-135's setup)."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        batch_sharding, make_mesh as jmake_mesh)
    from neurosync_trainer_lite_tpu.training.step import (
        init_train_state, make_train_step, shard_state)

    cfg = JConfig(**{**GEOM, **overrides, "dp": dp, "tp": tp})
    mesh = jmake_mesh(cfg)
    state, tx = init_train_state(cfg, 10, params=jax.tree.map(
        jax.numpy.asarray, jparams))
    state = shard_state(state, cfg, mesh, tx)
    step = make_train_step(cfg, tx, donate=False)
    s = jax.device_put(src, batch_sharding(mesh))
    t = jax.device_put(trg, batch_sharding(mesh))
    losses, norms = [], []
    for _ in range(STEPS):
        state, loss, norm = step(state, s, t, jax.random.PRNGKey(7))
        losses.append(float(loss))
        norms.append(float(norm))
    return losses, norms, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def jax_auto_steps(jax_init):
    """The JAX step at 'auto' on a (4, 2) mesh, dropout 0."""
    jparams, _ = jax_init
    cfg = Config(**GEOM)
    src, trg = batch(3, cfg.batch_size, cfg)
    return jax_mesh_steps({}, 4, 2, jparams, src, trg)


def full_params(per_rank: list[dict], tp: int) -> dict:
    """Rank 0's 'model' group's shards concatenated along each key's
    sharded dim: the full parameters."""
    out = {}
    for key, value in params(per_rank[0]).items():
        dim = param_spec(key)
        out[key] = value if dim is None else np.concatenate(
            [params(per_rank[r])[key] for r in range(tp)], dim)
    return out


def replicated_equal_across_model_ranks(per_rank: list[dict], tp: int):
    """Every rank of a 'model' group holds bitwise the same replicated
    leaves, and the same losses and norms."""
    for first in range(0, len(per_rank), tp):
        for r in range(first + 1, first + tp):
            for key, value in params(per_rank[first]).items():
                if param_spec(key) is None:
                    np.testing.assert_array_equal(
                        params(per_rank[r])[key], value,
                        err_msg=f"rank {r}: {key}")
            for key in ("losses", "norms"):
                np.testing.assert_array_equal(per_rank[r][key],
                                              per_rank[first][key])


# ---------------------------------------------------------------------------
# the mesh and the rules


def test_param_specs_match_jax_transposed():
    """Key by key, the torch dim sharded over 'model' is JAX's spec
    transposed: P(None, 'model') on w [in, out] shards torch's dim 0 (and
    the bias's), P('model', None) torch's dim 1; every other leaf is
    replicated."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.models.seq2seq import (
        init_seq2seq as jinit_seq2seq)
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        param_specs as jparam_specs)
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)

    cfg = Config(**GEOM)
    jspecs = jparam_specs(JConfig(**GEOM))
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    stacked = {"layers"}

    def torch_dim(path, spec):
        axes = tuple(spec)
        if any(getattr(p, "key", None) in stacked for p in path):
            axes = axes[1:]                  # the layer axis
        if "model" not in axes:
            return None
        j = axes.index("model")
        return 1 - j if len(axes) == 2 else 0

    # carry the JAX specs through params_from_jax's key map as numbers
    codes = jax.tree_util.tree_map_with_path(
        lambda path, spec: -1 if torch_dim(path, spec) is None
        else torch_dim(path, spec), jspecs, is_leaf=is_spec)
    shapes = jax.eval_shape(lambda: jinit_seq2seq(jax.random.PRNGKey(0),
                                                  JConfig(**GEOM)))
    theirs = params_from_jax(jax.tree.map(
        lambda code, shape: np.full(shape.shape, code, np.float32),
        codes, shapes), cfg)
    ours = param_specs(cfg)
    assert set(ours) == set(theirs)
    for key, t in theirs.items():
        code = int(t.reshape(-1)[0])
        assert ours[key] == (None if code < 0 else code), key
    layer = "encoder.transformer_encoder.0"
    assert {k[len(layer) + 1:]: v for k, v in ours.items()
            if k.startswith(layer) and v is not None} == {
        "self_attn.q_linear.weight": 0, "self_attn.q_linear.bias": 0,
        "self_attn.k_linear.weight": 0, "self_attn.k_linear.bias": 0,
        "self_attn.v_linear.weight": 0, "self_attn.v_linear.bias": 0,
        "self_attn.out_linear.weight": 1, "ffn.linear1.weight": 0,
        "ffn.linear1.bias": 0, "ffn.linear2.weight": 1}


@pytest.mark.parametrize("dp,tp,world", [(-1, 2, 4), (2, 2, 4), (1, 4, 4),
                                         (4, 2, 4)])
def test_rank_layout_is_jax_reshape(dp, tp, world):
    """Rank r sits at (r // tp, r % tp), as JAX's devices[:n].reshape(dp,
    tp) places device r; a mesh larger than the world raises."""
    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        make_mesh as jmake_mesh)
    import jax

    try:
        jmesh = jmake_mesh(JConfig(dp=dp, tp=tp),
                           devices=jax.devices()[:world])
    except ValueError:
        with pytest.raises(ValueError, match="needs 8 devices, have 4"):
            make_mesh(Config(dp=dp, tp=tp), world=world)
        return
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    ours = make_mesh(Config(dp=dp, tp=tp), world=world)
    for r in range(ours.dp * ours.tp):
        i, j = np.argwhere(ids == jax.devices()[r].id)[0]
        assert (r // ours.tp, r % ours.tp) == (i, j)


def test_layouts_without_whole_heads_raise():
    """A rank holds whole heads and an equal block of the FFN: the stated
    difference from JAX, whose GSPMD would split a head across devices.
    (With ffn_dim = 4 · hidden and whole heads the FFN always splits; the
    rule is checked on its own all the same.)"""
    from types import SimpleNamespace

    from neurosync_trainer_lite_tpu_torch.config import check_tp_split

    with pytest.raises(ValueError, match="num_heads 6 is not a multiple"):
        make_mesh(Config(num_heads=6, hidden_dim=96, tp=4), world=4)
    with pytest.raises(ValueError, match="ffn_dim 6 is not a multiple"):
        check_tp_split(SimpleNamespace(num_heads=4, ffn_dim=6), 4)
    check_tp_split(Config(), 16)


@pytest.mark.parametrize("model_index", [0, 1])
def test_sharded_init_is_the_shard_of_the_full_init(model_index):
    """init_seq2seq under a (1, 2) mesh (drawing each weight whole, keeping
    the rank's block) is bitwise shard_state_dict of the unsharded init
    from the same generator seed; no process group is needed to build it."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import init_seq2seq
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import Mesh

    cfg = Config(**GEOM)
    mesh = Mesh(dp=1, tp=2, model_index=model_index)
    full = init_seq2seq(cfg, torch.Generator().manual_seed(4), "cpu")
    want = shard_state_dict(full.state_dict(), cfg, mesh)
    got = init_seq2seq(cfg, torch.Generator().manual_seed(4), "cpu",
                       mesh).state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_mask_blocks_are_blocks_of_the_global_draw():
    """Under dropout_rows(n, i, nw, j) a mask is the rank's block of the
    global draw: rows i of n, and over a sharded width (the heads of an
    attention mask, dim 1; the FFN hidden columns, the last dim) block j of
    nw; a mask over the replicated width keeps it whole."""
    from neurosync_trainer_lite_tpu_torch.ops.attention import (
        dropout_keep, dropout_rows)

    heads = dropout_keep(11, (4, 6, 5, 5), 77, "cpu")     # [B, H, Tq, Tk]
    cols = dropout_keep(12, (4, 5, 12), 77, "cpu")        # [B, T, F]
    resid = dropout_keep(13, (4, 5, 8), 77, "cpu")        # [B, T, D]
    for i in range(2):
        for j in range(3):
            with dropout_rows(2, i, 3, j):
                rows = slice(2 * i, 2 * i + 2)
                assert torch.equal(
                    dropout_keep(11, (2, 2, 5, 5), 77, "cpu", split_dim=1),
                    heads[rows, 2 * j: 2 * j + 2])
                assert torch.equal(
                    dropout_keep(12, (2, 5, 4), 77, "cpu", split_dim=-1),
                    cols[rows, :, 4 * j: 4 * j + 4])
                assert torch.equal(dropout_keep(13, (2, 5, 8), 77, "cpu"),
                                   resid[rows])
    with pytest.raises(ValueError):
        with dropout_rows(1, 0, 2, 2):
            pass


# ---------------------------------------------------------------------------
# shards and the gather


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_shard_then_gather_is_bitwise(ranks, jax_init, mesh):
    """shard_state_dict → each rank's shard of the model (q/k/v/linear1
    cut along torch dim 0, out/linear2 along dim 1) → gather_state_dict:
    the original weights bit for bit (tests/test_training.py:299-316), on
    rank 0 only; after 2 steps the gathered parameters and Adam moments
    are the shards put back together."""
    _, init = jax_init
    dp, tp = mesh
    per_rank = results(ranks[mesh], "gather", dp * tp)
    for key, value in init.items():
        np.testing.assert_array_equal(per_rank[0][f"g:{key}"], value.numpy(),
                                      err_msg=key)
        want = list(value.shape)
        if param_spec(key) is not None:
            want[param_spec(key)] //= tp
        for res in per_rank:
            assert res[f"shape:{key}"].tolist() == want, key
    assert not any(k.startswith(("g:", "m:")) for res in per_rank[1:]
                   for k in res)
    moments = [k for k in per_rank[0] if k.startswith("o:")]
    assert len(moments) == 3 * len(init)          # step, exp_avg, exp_avg_sq
    assert all(np.isfinite(per_rank[0][k]).all() for k in moments)


# ---------------------------------------------------------------------------
# eval, steps


def test_tp2_eval_loss_matches_jax_4x2(ranks, jax_init):
    """The eval loss at tp = 2 against JAX's on a (4, 2) mesh within 1e-5
    (tests/test_training.py:138-152); one forward all-reduce a row-parallel
    linear."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        batch_sharding, make_mesh as jmake_mesh, shard_params)
    from neurosync_trainer_lite_tpu.training.step import make_eval_step

    jparams, _ = jax_init
    jcfg = JConfig(**GEOM, dp=4, tp=2)
    mesh = jmake_mesh(jcfg)
    src, trg = batch(4, 8, Config(**GEOM))
    theirs = float(make_eval_step(jcfg)(
        shard_params(jax.tree.map(jax.numpy.asarray, jparams), jcfg, mesh),
        jax.device_put(src, batch_sharding(mesh)),
        jax.device_put(trg, batch_sharding(mesh))))
    r0, r1 = results(ranks[1, 2], "eval", 2)
    assert float(r0["loss"]) == float(r1["loss"])
    assert abs(float(r0["loss"]) - theirs) < 1e-5
    assert json.loads(str(r0["collectives"])) == {
        "forward": STEP_COLLECTIVES["forward"]}


@pytest.mark.parametrize("mesh,impl", [((1, 2), "auto"), ((1, 2), "pallas"),
                                       ((2, 2), "auto"), ((2, 2), "pallas")])
def test_tp_steps_match_jax_mesh(ranks, jax_init, jax_auto_steps, mesh,
                                 impl):
    """3 steps at (dp, tp) = (1, 2) and (2, 2), 'auto' and 'pallas',
    dropout 0, against the JAX step on a (4, 2) mesh at 'auto': loss and
    pre-clip grad norm within 1e-5 relative, parameters within atol 1e-4
    (tests/test_training.py:105-135's bounds). At dropout 0 and T = 16 the
    JAX mesh step at 'pallas' equals its 'auto' one (tests/
    test_torch_tensor_parallel_loop.py holds the port's 'pallas' against
    it directly); the 'model' all-reduces are counted per step."""
    from neurosync_trainer_lite_tpu_torch.utils.weights import (
        params_from_jax)

    losses, norms, jfinal = jax_auto_steps
    dp, tp = mesh
    per_rank = results(ranks[mesh], impl, dp * tp)
    replicated_equal_across_model_ranks(per_rank, tp)
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-5)
    theirs = params_from_jax(jfinal, Config(**GEOM))
    for key, ours in full_params(per_rank, tp).items():
        np.testing.assert_allclose(ours, theirs[key].numpy(), atol=1e-4,
                                   err_msg=key)
    assert json.loads(str(per_rank[0]["collectives"])) == {
        k: STEPS * v for k, v in STEP_COLLECTIVES.items()}


@pytest.mark.parametrize("name", ["auto", "drop", "drop_accum", "window512"])
def test_tp2_equals_tp1(ranks, jax_init, name):
    """The port at tp = 2 against the port at tp = 1 from the same weights,
    at dropout 0 and 0.3, with two micro-batches, and at a 512-frame
    window (K3's plain version, one rank's 2 heads): each rank's masks are
    its blocks of the global draw at the global width, so only the order
    of fp32 sums differs: loss and norm within 1e-6 relative; parameters
    within atol 1e-4 after 3 steps, the JAX mesh test's bound for that
    order (Adam's rsqrt(v) amplifies it where a gradient is near zero: one
    weight of 4,096 moves by 1.02e-5 with accumulation); the replicated
    leaves bitwise equal on both ranks."""
    _, init = jax_init
    case = next(c for c in TP2_CASES if c["name"] == name)
    cfg = Config(**{**GEOM, **case.get("cfg", {})})
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    losses, norms, sd, _ = port_steps(cfg, init, src, trg)
    per_rank = results(ranks[1, 2], name, 2)
    replicated_equal_across_model_ranks(per_rank, 2)
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-6)
    for key, ours in full_params(per_rank, 2).items():
        np.testing.assert_allclose(ours, sd[key].numpy(), atol=1e-4,
                                   err_msg=key)
    accum = cfg.grad_accum_steps
    assert json.loads(str(per_rank[0]["collectives"])) == {
        "forward": STEPS * accum * STEP_COLLECTIVES["forward"],
        "backward": STEPS * accum * STEP_COLLECTIVES["backward"],
        "grad_norm": STEPS}


def test_dp2_tp2_dropout_equals_tp1(ranks, jax_init):
    """(2, 2) at dropout 0.3 against the port at tp = 1: both subgroups at
    once, rows from 'data' and widths from 'model' (1e-6; parameters 1e-4,
    as test_tp2_equals_tp1); the two 'model' groups' ranks bitwise equal
    where replicated."""
    _, init = jax_init
    cfg = Config(**{**GEOM, **DROP})
    src, trg = batch(3, cfg.batch_size, cfg)
    losses, norms, sd, _ = port_steps(cfg, init, src, trg)
    per_rank = results(ranks[2, 2], "drop", 4)
    replicated_equal_across_model_ranks(per_rank, 2)
    assert_ranks_bitwise_equal([{k: v for k, v in r.items()
                                 if k in ("losses", "norms")}
                                for r in per_rank])
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=1e-6)
    for key, ours in full_params(per_rank, 2).items():
        np.testing.assert_allclose(ours, sd[key].numpy(), atol=1e-4,
                                   err_msg=key)


def test_remat_at_tp2_equals_no_remat(ranks):
    """remat at tp = 2, dropout 0.3: bitwise the run without it (the
    recompute redraws the masks from their seeds and runs the forward's
    all-reduces again inside the backward: 2 a step more of each layer's
    forward count)."""
    plain = results(ranks[1, 2], "drop", 2)
    remat = results(ranks[1, 2], "remat", 2)
    for a, b in zip(plain, remat):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["norms"], b["norms"])
        for key, value in params(a).items():
            np.testing.assert_array_equal(params(b)[key], value,
                                          err_msg=key)
    assert json.loads(str(remat[0]["collectives"])) == {
        "forward": 2 * STEPS * STEP_COLLECTIVES["forward"],
        "backward": STEPS * STEP_COLLECTIVES["backward"],
        "grad_norm": STEPS}


@pytest.mark.parametrize("plain,remat", [("drop", "remat_dots"),
                                         ("drop_bf16", "remat_dots_bf16")])
def test_remat_dots_at_tp2_equals_no_remat(ranks, plain, remat):
    """remat_policy='dots' at tp = 2, dropout 0.3, fp32 and bf16 (_linear
    and the lean FFN core): bitwise the run without remat. The checkpoint
    keeps the products' outputs, so a row-parallel sum made in place on
    one would hand the recompute the sum, and it would be summed again."""
    for a, b in zip(results(ranks[1, 2], plain, 2),
                    results(ranks[1, 2], remat, 2)):
        np.testing.assert_array_equal(a["losses"], b["losses"])
        np.testing.assert_array_equal(a["norms"], b["norms"])
        for key, value in params(a).items():
            np.testing.assert_array_equal(params(b)[key], value,
                                          err_msg=key)


#: the K2-routed bf16 step at tp = 2 against tp = 1, relative (loss, grad
#: norm) and absolute (parameters after 3 steps). The fp32 partial sums,
#: added in another order, can round to the neighbouring bf16 value, and
#: the flip travels: on this test's inputs the gaps read 0, 1.5e-7 and
#: 1.2e-7; from another seed's init (torch.Generator 1) 1.8e-4, 5.3e-4 and
#: 2.0e-3, a weight with a near-zero gradient whose sign flips moving by
#: Adam's 2·lr (1e-3) a step. The bounds hold the latter with room: 3
#: steps of 2·lr for the parameters. 'change' bounds the worst leaf's
#: ‖Δθ(tp 2) − Δθ(tp 1)‖ / ‖Δθ(tp 1)‖ over the 3 steps, so that a shard
#: that never moved (1.0) fails: 5.5e-6 on this test's inputs, 0.157 from
#: Generator 1's init (a k_linear.bias, whose gradient is zero up to
#: rounding, softmax being invariant to a shift of k).
K2_BF16_LIMITS = dict(loss=1e-3, norm=2e-3,
                      params=3 * 2 * GEOM["learning_rate"], change=0.25)


def test_k2_routed_bf16_step_at_tp2(ranks, jax_init, monkeypatch):
    """seq2seq._ffn routed through models/layers.ffn_fused (K2's plain
    version on the CPU) in bf16 at dropout 0.3: tp = 2 against tp = 1
    within K2_BF16_LIMITS; the replicated leaves (db2 among them: Σdy of
    the replicated dy) bitwise equal on both ranks."""
    from neurosync_trainer_lite_tpu_torch.models import layers, seq2seq

    _, init = jax_init
    case = next(c for c in TP2_CASES if c["name"] == "k2_bf16")
    cfg = Config(**{**GEOM, **case["cfg"]})
    src, trg = batch(case["seed"], cfg.batch_size, cfg)
    monkeypatch.setattr(seq2seq, "_ffn", layers.ffn_fused)
    losses, norms, sd, _ = port_steps(cfg, init, src, trg)
    per_rank = results(ranks[1, 2], "k2_bf16", 2)
    replicated_equal_across_model_ranks(per_rank, 2)
    lim = K2_BF16_LIMITS
    np.testing.assert_allclose(per_rank[0]["losses"], losses, rtol=lim["loss"])
    np.testing.assert_allclose(per_rank[0]["norms"], norms, rtol=lim["norm"])
    change = {}
    for key, ours in full_params(per_rank, 2).items():
        np.testing.assert_allclose(ours, sd[key].numpy(), atol=lim["params"],
                                   err_msg=key)
        theirs = sd[key].numpy() - init[key].numpy()
        change[key] = float(np.linalg.norm(ours - init[key].numpy() - theirs)
                            / np.linalg.norm(theirs))
    worst = max(change, key=change.get)
    assert change[worst] < lim["change"], (worst, change[worst])


# ---------------------------------------------------------------------------
# checkpoints, decode


def test_tp1_checkpoint_resumes_at_tp2(ranks, jax_init):
    """A checkpoint written at tp = 1 (2 steps), resumed at tp = 2 (each
    rank cuts its shard of the parameters and Adam moments): its next
    step's loss and norm those of the uninterrupted tp = 1 run within
    1e-6."""
    _, init = jax_init
    cfg = Config(**GEOM)
    src, trg = batch(5, cfg.batch_size, cfg)
    losses, norms, _, _ = port_steps(cfg, init, src, trg)
    for res in results(ranks[1, 2], "ckpt", 2):
        assert res["resumed"].tolist() == [1, 2]
        assert float(res["loss"]) == pytest.approx(losses[2], rel=1e-6)
        assert float(res["norm"]) == pytest.approx(norms[2], rel=1e-6)


def test_tp2_checkpoint_resumes_at_tp1(ranks, jax_init):
    """The checkpoint written at tp = 2 is the tp = 1 format (the same keys
    and shapes, parameters and moments gathered), within fp32 sum order of
    the tp = 1 checkpoint of the same steps (parameters atol 1e-4, as
    test_tp2_equals_tp1; moments atol 1e-5, rtol 1e-4); resumed at tp = 1
    its next step matches the uninterrupted run within 1e-5 relative, the
    JAX mesh test's loss bound (the state carries two steps of tp = 2's
    sum order: the norm reads 1.7e-6 apart)."""
    from neurosync_trainer_lite_tpu_torch.training import checkpoint as ckpt
    from neurosync_trainer_lite_tpu_torch.training.step import (
        make_train_step)

    _, init = jax_init
    cfg = Config(**GEOM)
    out = ranks[1, 2]
    _, tp2 = ckpt._load_state(str(out / "ck_tp2" / "checkpoint"))
    _, tp1 = ckpt._load_state(str(out / "ck_tp1" / "checkpoint"))
    assert list(tp2["model"]) == list(tp1["model"])
    for key, value in tp1["model"].items():
        assert tp2["model"][key].shape == value.shape
        np.testing.assert_allclose(tp2["model"][key], value, atol=1e-4,
                                   err_msg=key)
    for i, s in tp1["optimizer"]["state"].items():
        for k, v in s.items():
            assert tp2["optimizer"]["state"][i][k].shape == v.shape
            np.testing.assert_allclose(tp2["optimizer"]["state"][i][k], v,
                                       atol=1e-5, rtol=1e-4)
    src, trg = batch(5, cfg.batch_size, cfg)
    losses, norms, _, _ = port_steps(cfg, init, src, trg)
    _, _, state = ckpt.load_checkpoint(str(out / "ck_tp2" / "checkpoint"),
                                       cfg, 10, device="cpu")
    _, loss, norm = make_train_step(cfg)(
        state, torch.from_numpy(src), torch.from_numpy(trg),
        torch.Generator().manual_seed(102))
    assert float(loss) == pytest.approx(losses[2], rel=1e-5)
    assert float(norm) == pytest.approx(norms[2], rel=1e-5)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_mesh_decoder_over_model_matches_jax_4x2(ranks, jax_init, mesh):
    """MeshDecoder at (1, 2) and (2, 2) against the JAX MeshDecoder at
    (4, 2), standalone (5 chunks) and through process_audio_features:
    atol 1e-5, rtol 1e-4 (tests/test_inference.py:122-152). Every rank
    gets the whole result."""
    import jax

    from neurosync_trainer_lite_tpu.config import Config as JConfig
    from neurosync_trainer_lite_tpu.inference import chunked as jchunked
    from neurosync_trainer_lite_tpu.parallel.mesh import (
        make_mesh as jmake_mesh)

    jparams, _ = jax_init
    dp, tp = mesh
    arrays = dict(np.load(ranks[mesh] / "decode_in.npz"))
    jcfg = JConfig(**GEOM)
    jp = jax.tree.map(jax.numpy.asarray, jparams)
    jdec = jchunked.MeshDecoder(jp, jcfg, jmake_mesh(jcfg.replace(dp=4,
                                                                  tp=2)))
    want = {"chunks": jdec(jp, arrays["chunks"], jcfg),
            "frames": jchunked.process_audio_features(
                arrays["feats"], jp, jcfg, decode_batched=jdec)}
    per_rank = results(ranks[mesh], "decode", dp * tp)
    assert_ranks_bitwise_equal(per_rank)
    for key, ref in want.items():
        np.testing.assert_allclose(per_rank[0][key], ref, atol=1e-5,
                                   rtol=1e-4, err_msg=key)


def test_model_axis_without_group_raises():
    """A mesh with tp = 2 and no process group: JAX's mesh error; its
    'model' sums and the gather raise rather than compute one rank's
    share."""
    from neurosync_trainer_lite_tpu_torch.models.seq2seq import Seq2Seq

    with pytest.raises(ValueError, match="mesh 1x2 needs 2 devices, have 1"):
        make_mesh(Config(**GEOM, tp=2))
    mesh = make_mesh(Config(**GEOM, tp=2), world=2)
    model = Seq2Seq(Config(**GEOM), "cpu", mesh)
    with pytest.raises(RuntimeError, match="without a process group"):
        distributed.all_reduce_sum_(torch.zeros(3), mesh)
    with pytest.raises(RuntimeError, match="without a process group"):
        distributed.gather_state_dict(model, mesh)
    with pytest.raises(RuntimeError, match="without a process group"):
        model(torch.zeros(1, 16, GEOM["input_dim"]))


if __name__ == "__main__":
    if sys.argv[1:2] != ["worker"]:
        sys.exit("usage: test_torch_tensor_parallel.py worker SPEC RANK")
    worker(sys.argv[2], int(sys.argv[3]))

"""wav2vec 2.0 (models/wav2vec2.py) against its plain reference
(tests/plain_wav2vec2.py, float32 PyTorch from the published equations,
nothing of the port) on seeded random weights, at a tiny size: hidden 64,
2 layers, 4 heads, conv widths 32 with the published kernels and strides,
the published 128-tap positional conv in 16 groups, windows of 8 frames =
2,133 samples at 16 kHz (6 encoder frames, interpolated to 8).

Tolerances, each with its reason:
- fp32 against fp32: the same math with products and sums in another
  order (the port's fused linears, grouped conv backward, seed-redrawn
  masks): 1e-5 of the largest magnitude for outputs and losses, 1e-4 of a
  leaf's norm for gradients and updates (a backward sums thousands of
  terms in another order);
- bf16 cores against the same composition in fp32 autograd: four bf16
  ulps (2^-7 each) of the largest magnitude: the cores round at h1, the
  activation, y, dh1 and dx, each at most half an ulp, and a rounded h1
  moves GELU's derivative by under one more;
- gradient leaves whose reference norm is under 1e-3 of the median leaf's
  are held to the median leaf's scale instead of their own: a key bias
  takes an analytic zero gradient (softmax ignores a shift along keys), so
  its value is round-off.

This file doubles as the worker of the data-parallel test
(`python tests/test_torch_wav2vec2.py worker SPEC RANK`).
"""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import plain_wav2vec2 as ref  # noqa: E402

from neurosync_trainer_lite_tpu_torch.config import (  # noqa: E402
    Config,
    check_tp_split,
)
from neurosync_trainer_lite_tpu_torch.data.waveform import (  # noqa: E402
    WaveformDataset,
    _center_trim,
    load_waveform_data,
)
from neurosync_trainer_lite_tpu_torch.models import wav2vec2 as w2v  # noqa: E402
from neurosync_trainer_lite_tpu_torch.ops.attention import (  # noqa: E402
    dropout_keep,
)
from neurosync_trainer_lite_tpu_torch.training import step as step_mod  # noqa: E402
from neurosync_trainer_lite_tpu_torch.training.loop import (  # noqa: E402
    step_generator,
)

SR = 16000
GEOM = dict(architecture="wav2vec2", sr=SR, hidden_dim=64, n_layers=2,
            num_heads=4, conv_dim=(32,) * 7, micro_batch_size=8,
            batch_size=4, use_amp=False, seed=5, n_epochs=4, dropout=0.1)
SPAWN_TIMEOUT, GROUP_TIMEOUT = 180, 60


def tiny(**kw) -> Config:
    return Config(**{**GEOM, **kw})


def weights(cfg: Config, seed: int = 7) -> dict:
    return ref.seeded_weights(ref.dims(cfg.to_dict()), seed, "cpu")


def model_of(cfg: Config, w: dict):
    model = w2v.Wav2Vec2(cfg, "cpu")
    model.load_state_dict(w, strict=True)
    return model


def batches(cfg: Config, n: int, seed: int = 3) -> list:
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(cfg.batch_size, cfg.window_samples, generator=g),
             torch.rand(cfg.batch_size, cfg.micro_batch_size, 61,
                        generator=g)) for _ in range(n)]


def opt_of(cfg: Config) -> dict:
    # the schedule's factor is 1 in the first epoch (warmup_epochs 0)
    return {"delta": cfg.delta, "grad_clip": cfg.grad_clip,
            "weight_decay": cfg.weight_decay, "lr": cfg.learning_rate}


def rel(a, b) -> float:
    a, b = (torch.as_tensor(t).detach().double() for t in (a, b))
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def leaf_gaps(ours: dict, theirs: dict) -> dict:
    """|ours − theirs| / max(‖theirs‖, 1e-3·median ‖theirs‖) per leaf."""
    med = float(np.median([float(v.norm()) for v in theirs.values()]))
    return {k: float((ours[k] - v).norm()) / max(float(v.norm()),
                                                 1e-3 * med)
            for k, v in theirs.items()}


@pytest.fixture(autouse=True)
def _plain():
    ref.plain_precision()
    torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the model against the reference


def test_parameter_names_and_count_match_the_reference():
    cfg = tiny()
    model = w2v.Wav2Vec2(cfg, "cpu")
    shapes = ref.param_shapes(ref.dims(cfg.to_dict()))
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(k.startswith("feature_extractor.") for k in frozen)
    assert frozen == [k for k in shapes if ref.frozen(k, ref.dims(
        cfg.to_dict()))]


@pytest.mark.parametrize("train", [False, True])
def test_forward_and_loss_match_the_reference(train):
    cfg = tiny()
    w = weights(cfg)
    model = model_of(cfg, w).train(train)
    (src, trg), = batches(cfg, 1)
    seed_gen = torch.Generator().manual_seed(11)
    ours = model(src, seed_gen if train else None)
    seed = w2v.draw_seed(torch.Generator().manual_seed(11)) if train else None
    theirs = ref.forward(w, src, ref.dims(cfg.to_dict()),
                         drop=ref.Dropout(len(src)), seed=seed)
    assert ours.shape == (cfg.batch_size, cfg.micro_batch_size, 61)
    assert rel(ours, theirs) < 1e-5
    from neurosync_trainer_lite_tpu_torch.models.loss import loss_fn

    assert rel(loss_fn(ours, trg), ref.loss_fn(theirs, trg)) < 1e-5


@pytest.mark.parametrize("frozen", [True, False])
def test_every_trainable_gradient_matches_the_reference(frozen):
    """The frozen feature encoder takes no gradient; unfrozen, its leaves
    train as the rest."""
    cfg = tiny(freeze_feature_encoder=frozen)
    w = weights(cfg)
    d = ref.dims(cfg.to_dict())
    model = model_of(cfg, w).train()
    (src, trg), = batches(cfg, 1)
    from neurosync_trainer_lite_tpu_torch.models.loss import loss_fn

    loss_fn(model(src, torch.Generator().manual_seed(4)), trg).backward()
    P = {k: v.clone().requires_grad_(not ref.frozen(k, d))
         for k, v in w.items()}
    seed = w2v.draw_seed(torch.Generator().manual_seed(4))
    keys = [k for k in P if P[k].requires_grad]
    out = ref.loss_fn(ref.forward(P, src, d, drop=ref.Dropout(len(src)),
                                  seed=seed), trg)
    theirs = dict(zip(keys, torch.autograd.grad(out, [P[k] for k in keys])))
    ours = {k: p.grad for k, p in model.named_parameters() if p.requires_grad}
    assert set(ours) == set(theirs)
    assert frozen != any(k.startswith("feature_extractor.") for k in ours)
    gaps = leaf_gaps(ours, theirs)
    assert max(gaps.values()) < 1e-4, sorted(gaps.items(), key=lambda x: -x[1])[:3]


def test_three_adam_steps_match_the_reference():
    """The step's loss each time, Adam's first moment after one step and
    the parameters after three, against the reference's train_steps."""
    cfg = tiny()
    w = weights(cfg)
    d = ref.dims(cfg.to_dict())
    data = batches(cfg, 3)
    seeds = [ref.step_seed(cfg.seed, i) for i in range(3)]
    theirs = ref.train_steps(w, data, seeds, d, opt_of(cfg), rows=2)
    state = step_mod.init_train_state(
        cfg, 100, device="cpu", state_dict={k: v.clone() for k, v in
                                            w.items()})
    step = step_mod.make_train_step(cfg)
    losses, m1 = [], {}
    for i, (src, trg) in enumerate(data):
        state, loss, _ = step(state, src, trg, step_generator(cfg.seed + 1, i))
        losses.append(float(loss))
        if i == 0:
            opt = state.optimizer.state
            m1 = {k: float(opt[p]["exp_avg"].norm())
                  for k, p in state.model.named_parameters() if p in opt}
    assert np.allclose(losses, theirs["losses"], rtol=1e-5, atol=0)
    named = dict(state.model.named_parameters())
    med = np.median(list(theirs["grad1"].values()))
    keep = [k for k, g in theirs["grad1"].items() if g >= 1e-3 * med]
    for k in keep:
        assert abs(m1[k] - theirs["m1"][k]) <= 1e-4 * theirs["m1"][k], k
        delta = float((named[k].detach() - w[k]).norm())
        assert abs(delta - theirs["delta"][k]) <= 1e-4 * theirs["delta"][k], k


def test_the_frozen_encoder_takes_no_gradient_and_no_adam_state():
    cfg = tiny()
    w = weights(cfg)
    state = step_mod.init_train_state(cfg, 100, device="cpu",
                                      state_dict={k: v.clone() for k, v in
                                                  w.items()})
    step = step_mod.make_train_step(cfg)
    for i, (src, trg) in enumerate(batches(cfg, 2)):
        state, _, _ = step(state, src, trg, step_generator(1, i))
    groups = state.optimizer.param_groups
    in_opt = {id(p) for g in groups for p in g["params"]}
    for k, p in state.model.named_parameters():
        frozen = k.startswith("feature_extractor.")
        assert (id(p) in in_opt) != frozen, k
        assert (p in state.optimizer.state) != frozen, k
        if frozen:
            assert p.grad is None and torch.equal(p.detach(), w[k]), k
    assert step_mod.trainable(state.model) == [
        (k, p) for k, p in state.model.named_parameters()
        if not k.startswith("feature_extractor.")]


# ---------------------------------------------------------------------------
# the pieces


def _ffn_plain_fp32(x, w1, b1, w2, b2, keep, q):
    """The core's composition in fp32 autograd, same mask and scale."""
    h = F.gelu(x.float() @ w1.t() + b1)
    if keep is not None:
        h = torch.where(keep, h * (256.0 / (256 - q)), 0.0)
    return h @ w2.t() + b2


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_gelu_core_matches_plain_autograd(rate):
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 8, 64, generator=g).bfloat16().requires_grad_(True)
    w1 = (torch.randn(256, 64, generator=g) * 0.1).requires_grad_(True)
    b1 = (torch.randn(256, generator=g) * 0.1).requires_grad_(True)
    w2 = (torch.randn(64, 256, generator=g) * 0.1).requires_grad_(True)
    b2 = (torch.randn(64, generator=g) * 0.1).requires_grad_(True)
    q, seed = int(round(rate * 256)), 1234
    ours = w2v._FfnGeluCore.apply(x, w1, b1, w2, b2, seed, q)
    dy = torch.randn(ours.shape, generator=g).bfloat16()
    ours.backward(dy)
    got = [t.grad.clone() for t in (x, w1, b1, w2, b2)]
    for t in (x, w1, b1, w2, b2):
        t.grad = None
    keep = dropout_keep(seed, (3, 8, 256), q, "cpu", -1) if q else None
    xs = x.detach().float().requires_grad_(True)
    want = _ffn_plain_fp32(xs, w1, b1, w2, b2, keep, q)
    want.backward(dy.float())
    ulps = 4 * 2.0 ** -7
    assert rel(ours.float(), want) < ulps
    # with dropout on, the gradients agree only if the backward redrew the
    # forward's mask
    for a, b in zip(got, [xs.grad, w1.grad, b1.grad, w2.grad, b2.grad]):
        assert rel(a.float(), b) < ulps


def test_pre_ln_ordering_is_checked(monkeypatch):
    """The forward check passes for the pre-LN port and fails for the same
    weights in post-LN order."""
    cfg = tiny()
    w = weights(cfg)
    d = ref.dims(cfg.to_dict())
    (src, _), = batches(cfg, 1)
    theirs = ref.forward(w, src, d)
    assert rel(model_of(cfg, w).eval()(src), theirs) < 1e-5

    def post_ln(self, x, seed=None):
        x = self.layer_norm(x + self.attention(x, None))
        return self.final_layer_norm(x + self.feed_forward(x, None))

    monkeypatch.setattr(w2v.EncoderLayer, "forward", post_ln)
    assert rel(model_of(cfg, w).eval()(src), theirs) > 1e-2


def test_positional_conv_is_weight_normed_and_drops_the_last_frame():
    """pos_conv against torch's own weight norm (dim 2) over a Conv1d with
    padding 64, its last output frame dropped, then GELU: values and the
    gradients of x, g, v and the bias."""
    cfg = tiny()
    w = weights(cfg)
    model = model_of(cfg, w)
    module = model.encoder.pos_conv_embed
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 8, 64, generator=g).requires_grad_(True)
    ours = w2v.pos_conv(module, x)
    dy = torch.randn(ours.shape, generator=g)
    ours.backward(dy)
    conv = torch.nn.Conv1d(64, 64, 128, padding=64, groups=16)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, dim=2)
    p = "encoder.pos_conv_embed.conv"
    with torch.no_grad():
        conv.parametrizations.weight.original0.copy_(w[f"{p}.weight_g"])
        conv.parametrizations.weight.original1.copy_(w[f"{p}.weight_v"])
        conv.bias.copy_(w[f"{p}.bias"])
    xs = x.detach().clone().requires_grad_(True)
    full = conv(xs.transpose(1, 2))
    assert full.shape[-1] == 9           # T + 1: the last frame is dropped
    want = F.gelu(full[..., :-1]).transpose(1, 2)
    want.backward(dy)
    assert rel(ours, want) < 1e-5
    assert rel(x.grad, xs.grad) < 1e-5
    pw = conv.parametrizations.weight
    for ours_g, want_g in ((module.conv.weight_g.grad, pw.original0.grad),
                           (module.conv.weight_v.grad, pw.original1.grad),
                           (module.conv.bias.grad, conv.bias.grad)):
        assert rel(ours_g, want_g) < 1e-5
    # dropping the first frame instead is another function
    assert rel(F.gelu(full[..., 1:]).transpose(1, 2), want) > 1e-2


def test_published_frontend_gives_106_frames_interpolated_to_128():
    d = ref.dims(Config(**{**GEOM, "micro_batch_size": 128}).to_dict())
    assert d["samples"] == 34133
    assert ref.encoder_frames(d) == [6825, 3412, 1705, 852, 425, 212, 106]
    cfg = tiny(micro_batch_size=128, conv_dim=(4,) * 7, batch_size=1)
    assert cfg.window_samples == 34133 and w2v.frames_of(34133, cfg) == 128
    model = w2v.init_wav2vec2(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    last = model.feature_extractor.conv_layers[-1]
    last.register_forward_hook(lambda m, i, o: seen.append(o.shape[-1]))
    feats = model.feature_extractor(torch.randn(1, 34133), 128,
                                    torch.float32)
    assert seen == [106] and feats.shape == (1, 128, 4)
    x = torch.randn(2, 3, 106, dtype=torch.float64)
    got = F.interpolate(x, size=128, mode="linear", align_corners=True)
    want = ref.interpolate(x, 128)
    assert rel(got, want) < 1e-12
    assert torch.equal(got[..., 0], x[..., 0])
    assert torch.equal(got[..., -1], x[..., -1])


# ---------------------------------------------------------------------------
# the data layer


def test_waveform_windows_are_cut_in_samples():
    rng = np.random.default_rng(1)
    # clip 0: 50 target frames, audio for 45 (45 · 16000 / 60 = 12000)
    # clip 1: 37 frames, audio for more; 5 frames: too short for a window
    clips = [(np.arange(12000, dtype=np.float32), rng.random((50, 61))),
             (np.arange(20000, dtype=np.float32) + 1e5, rng.random((37, 61))),
             (np.zeros(4000, np.float32), rng.random((5, 61)))]
    ds = WaveformDataset(clips, window=8, sr=SR, frame_rate=60)
    assert ds.samples == 2133
    frames = [45, 37]
    starts = [list(range(n - 8 + 1)) + ([n - 8] if n % 8 else [])
              for n in frames]
    assert ds.table.tolist() == [[c, s] for c in range(2) for s in starts[c]]
    assert ds.table.tolist()[-1] == ds.table.tolist()[-2] == [1, 29]
    src, trg = ds.gather(np.arange(len(ds)))
    for row, (c, s) in enumerate(ds.table):
        first = s * SR // 60
        assert src[row, 0] == clips[c][0][first]
        assert np.array_equal(src[row], clips[c][0][first: first + 2133])
        assert np.array_equal(trg[row], clips[c][1][s: s + 8].astype(
            np.float32))
        assert first + 2133 <= len(clips[c][0])
    assert ds.batch_shapes(3) == ((3, 2133), (3, 8, 61))


def test_center_trim_keeps_the_middle():
    y, f = np.arange(30000.0), np.arange(100.0)[:, None]
    ty, tf = _center_trim(y, f, SR, 60)   # audio covers 112 frames
    assert len(tf) == 100 and len(ty) == -(-100 * SR // 60)
    assert ty[0] == (30000 - len(ty)) // 2
    ty, tf = _center_trim(y[:20000], f, SR, 60)   # 75 frames of audio
    assert len(ty) == 20000 and np.array_equal(tf[:, 0], np.arange(12, 87))


def _write_capture(folder: Path, seconds: float, sr: int, frames: int):
    folder.mkdir(parents=True)
    rng = np.random.default_rng(len(str(folder)))
    pcm = (rng.uniform(-0.5, 0.5, int(seconds * sr)) * 32767).astype("<i2")
    with wave.open(str(folder / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    names = ["Timecode", "BlendshapeCount"] + [f"b{i}" for i in range(61)]
    rows = [",".join(names)]
    for i in range(frames):
        vals = rng.uniform(0, 0.8, 61)
        rows.append(",".join([f"00:00:{i // 60:02}:{i % 60:02}.000", "61"]
                             + [f"{v:.6f}" for v in vals]))
    (folder / f"{folder.name}_iPhone_cal.csv").write_text("\n".join(rows)
                                                          + "\n")


def test_captures_are_decoded_at_16_khz(tmp_path):
    _write_capture(tmp_path / "a", 1.5, 44100, 90)
    _write_capture(tmp_path / "b", 1.0, 16000, 70)   # facial runs longer
    clips = load_waveform_data(str(tmp_path), SR, 60)
    assert [len(y) for y, _ in clips] == [-(-90 * SR // 60), 16000]
    assert [len(f) for _, f in clips] == [90, 60]
    assert all(y.dtype == np.float32 for y, _ in clips)
    assert clips[0][1].max() > 1.0         # blendshapes in ×100 space
    assert not list(tmp_path.glob("*/audio_features.csv"))


def test_cli_trains_the_tiny_model_on_captured_waveforms(tmp_path):
    data = tmp_path / "data"
    _write_capture(data / "clip", 2.0, 44100, 120)
    out = tmp_path / "out"
    flags = ["--device", "cpu", "--architecture", "wav2vec2", "--sr", "16000",
             "--hidden_dim", "64", "--n_layers", "2", "--num_heads", "4",
             "--conv_dim", "32,32,32,32,32,32,32", "--micro_batch_size", "8",
             "--batch_size", "4", "--use_amp", "false", "--n_epochs", "1",
             "--max_steps_per_epoch", "2", "--root_dir", str(data),
             "--model_path", str(out / "model.pth"),
             "--checkpoint_path", str(out / "ck" / "checkpoint"),
             "--plots_dir", str(out / "plots")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "neurosync_trainer_lite_tpu_torch.train",
         *flags], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "max_steps_per_epoch=2 reached" in proc.stdout
    assert "fixed-wav validation is off" in proc.stdout
    sd = torch.load(out / "model.pth", weights_only=True)
    assert "encoder.pos_conv_embed.conv.weight_v" in sd
    assert (out / "ck" / "checkpoint" / "meta.json").exists()


# ---------------------------------------------------------------------------
# what the model refuses


def test_tensor_parallelism_and_serving_refuse_the_model(tmp_path):
    from neurosync_trainer_lite_tpu_torch.inference.api import (
        generate_facial_data_from_bytes)
    from neurosync_trainer_lite_tpu_torch.inference.streaming import (
        BlendshapeStreamer)
    from neurosync_trainer_lite_tpu_torch.parallel.mesh import make_mesh
    from neurosync_trainer_lite_tpu_torch.training.checkpoint import (
        load_model)

    cfg = tiny()
    with pytest.raises(ValueError, match="tensor parallelism"):
        check_tp_split(cfg, 2)
    with pytest.raises(ValueError, match="tensor parallelism"):
        make_mesh(cfg.replace(tp=2), world=2)
    model = w2v.init_wav2vec2(cfg, torch.Generator().manual_seed(0), "cpu")
    torch.save(model.state_dict(), tmp_path / "model.pth")
    for call in (lambda: load_model(str(tmp_path / "model.pth"), cfg, "cpu"),
                 lambda: generate_facial_data_from_bytes(b"", model, cfg,
                                                         device="cpu"),
                 lambda: BlendshapeStreamer(model, cfg, device="cpu")):
        with pytest.raises(ValueError, match="serving runs the 'seq2seq'"):
            call()


# ---------------------------------------------------------------------------
# data parallelism: two gloo ranks against one process


def worker(spec_path: str, rank: int) -> None:
    from neurosync_trainer_lite_tpu_torch.parallel import (
        batch_rows,
        distributed,
        make_mesh,
    )

    torch.set_num_threads(1)
    spec = json.loads(Path(spec_path).read_text())
    cfg = tiny()
    distributed.initialize_distributed(
        init_method=f"file://{spec['store']}", num_processes=2,
        process_id=rank, device="cpu", timeout_s=GROUP_TIMEOUT)
    try:
        mesh = make_mesh(cfg)
        out = _steps(cfg, mesh, batch_rows)
        np.savez(os.path.join(spec["out"], f"r{rank}.npz"), **out)
    finally:
        distributed.destroy()


def _steps(cfg, mesh, batch_rows) -> dict:
    state = step_mod.init_train_state(
        cfg, 100, device="cpu", state_dict=weights(cfg), mesh=mesh)
    step = step_mod.make_train_step(cfg, mesh=mesh)
    rows = batch_rows(mesh, cfg.batch_size)
    losses, grad1 = [], {}
    for i, (src, trg) in enumerate(batches(cfg, 2)):
        state, loss, _ = step(state, src[rows], trg[rows],
                              step_generator(cfg.seed + 1, i))
        losses.append(float(loss))
        if i == 0:
            grad1 = {f"grad1.{k}": np.array(float(p.grad.norm()))
                     for k, p in step_mod.trainable(state.model)}
    return {"losses": np.array(losses), **grad1,
            **{k: p.detach().numpy() for k, p in
               state.model.named_parameters()}}


def test_two_gloo_ranks_step_as_one_process(tmp_path):
    """dp = 2 over gloo (each rank its rows of the global batch, its rows of
    every mask) against one process on the global batch: two steps at
    the configuration's dropout, losses and every parameter within fp32
    round-off (the gradient is a mean of two halves' means)."""
    from neurosync_trainer_lite_tpu_torch.parallel import batch_rows

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"store": str(tmp_path / "store"),
                                "out": str(tmp_path)}))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, "worker", str(spec),
                               str(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    one = _steps(tiny(), None, batch_rows)
    # a leaf of an analytic zero gradient (a key bias) moves by Adam's
    # normalised round-off, which no two sums share: its gradient's norm is
    # held instead of its values
    med = np.median([v for k, v in one.items() if k.startswith("grad1.")])
    for r in range(2):
        got = dict(np.load(tmp_path / f"r{r}.npz"))
        assert np.allclose(got["losses"], one["losses"], rtol=1e-5, atol=0)
        for k, v in one.items():
            if k == "losses" or k.startswith("grad1."):
                assert np.allclose(got[k], v, rtol=1e-4, atol=1e-4 * med), k
            elif one.get(f"grad1.{k}", med) >= 1e-3 * med:
                assert np.allclose(got[k], v, rtol=0,
                                   atol=1e-5 * np.abs(v).max()), k


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_bf16_step_on_the_card_follows_the_reference():
    """One bf16 training step on the card (the LayerNorm kernels, cuDNN's
    convolutions, the GELU core, the lean attention core) against the fp32
    reference on the same card: the loss within 1e-2 relative and every
    kept leaf's gradient within 5% of the median leaf's norm (bf16 carries
    8 bits of mantissa through 2 layers; measured well inside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tiny(use_amp=True, hidden_dim=128, batch_size=8)
    d = ref.dims(cfg.to_dict())
    w = ref.seeded_weights(d, 7, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn(8, cfg.window_samples, device="cuda", generator=g)
    trg = torch.rand(8, 8, 61, device="cuda", generator=g)
    seed = ref.step_seed(cfg.seed, 0)
    theirs = ref.train_steps(w, [(src, trg)], [seed], d, opt_of(cfg), rows=8)
    state = step_mod.init_train_state(cfg, 100, device="cuda",
                                      state_dict={k: v.clone() for k, v in
                                                  w.items()})
    step = step_mod.make_train_step(cfg)
    state, loss, _ = step(state, src, trg, step_generator(cfg.seed + 1, 0))
    assert abs(float(loss) - theirs["losses"][0]) < 1e-2 * theirs["losses"][0]
    opt = state.optimizer.state
    med = np.median(list(theirs["m1"].values()))
    for k, p in state.model.named_parameters():
        if k in theirs["m1"] and theirs["grad1"][k] > 1e-3 * np.median(
                list(theirs["grad1"].values())):
            got = float(opt[p]["exp_avg"].norm())
            assert abs(got - theirs["m1"][k]) <= 0.05 * max(
                theirs["m1"][k], med), k


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2], int(sys.argv[3]))

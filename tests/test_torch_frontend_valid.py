"""The port's batched masked frontend and the multi-session tick's ring
update against the JAX package.

The JAX functions run vmapped over the same rows (fp32 XLA on the CPU); the
port runs them as one batched pass. Both are fp32 and sum in other orders:
2e-5 on valid feature rows (the observed gap is ~3e-6 at feature values up
to ~60), and on garbage rows, which no caller reads, 1e-5 of the row's
largest value: they exist to show that the port clamps every traced start
where jax.lax.dynamic_slice clamps it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neurosync_trainer_lite_tpu.inference import multi_stream as jms
from neurosync_trainer_lite_tpu.ops import frontend as jfe
from neurosync_trainer_lite_tpu_torch.inference import multi_stream as tms
from neurosync_trainer_lite_tpu_torch.ops import frontend as tfe
from neurosync_trainer_lite_tpu_torch.ops import frontend_np as tnp_fe

SR = 88200
FRAME = int(0.01667 * SR)
HALF = FRAME // 2
#: the shortest clip the frontend featurises: MIN_FRAMES (9) intermediate
#: frames, 11 frames at 120 fps
SHORTEST = FRAME + (tnp_fe.MIN_FRAMES - 1) * HALF
BUCKET = tfe.MIN_SAMPLE_BUCKET
TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test files at once, one a worker process, on
    the host's cores: torch's own pool of a thread a core in each worker
    would oversubscribe them many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_valid(y, n):
    fn = jax.jit(jax.vmap(lambda a, b: jfe.extract_features_valid(a, b, SR)))
    return np.asarray(fn(jnp.asarray(y), jnp.asarray(n, jnp.int32)))


@pytest.fixture(scope="module")
def rows():
    """Six rows of one bucket: a padding row (0 samples), the shortest
    valid clip, two longer ones, the longest that leaves the reflected
    tail its room, and one that starts and ends in silence, so that the
    autocorrelation's dead-edge fix fires at the first frame and at the
    last valid one (not at the bucket's last row); plus the JAX package's
    features of them."""
    rng = np.random.default_rng(0)
    lens = np.array([0, SHORTEST, 44100 + 123, 88200 + 7,
                     BUCKET - (HALF + 1), 66_000])
    y = np.zeros((len(lens), BUCKET), np.float32)
    for k, n in enumerate(lens):
        y[k, :n] = rng.standard_normal(n) * 0.3
    # silent through the first frame's reach and from the last valid
    # frame's start (frame t spans samples [(t - 1)·735, (t + 1)·735))
    t120 = tfe.num_frames_120(int(lens[5]), FRAME)
    y[5, : HALF + 1] = 0.0
    y[5, (t120 - 2) * HALF: lens[5]] = 0.0
    return y, lens, _jax_valid(y, lens)


def test_shortest_clip_is_the_frontend_minimum():
    assert not tfe.too_short(SHORTEST, SR)
    assert tfe.too_short(SHORTEST - 1, SR)
    assert tfe.num_frames_120(SHORTEST, FRAME) == tnp_fe.MIN_FRAMES + 2


def test_valid_rows_match_jax_and_the_true_length_frontend(rows):
    y, lens, theirs = rows
    ours = tfe.extract_features_valid(torch.from_numpy(y),
                                      torch.from_numpy(lens), SR).numpy()
    # an odd bucket's last 120 fps frame is dropped: one row fewer than
    # num_frames_60 counts
    assert ours.shape == theirs.shape == (
        len(lens), tfe.num_frames_120(BUCKET, FRAME) // 2, 256)
    assert ours.shape[1] == tfe.num_frames_60(BUCKET, FRAME) - 1
    for k, n in enumerate(lens):
        if n == 0:
            continue
        t60 = tfe.num_frames_60(int(n), FRAME)
        np.testing.assert_allclose(ours[k, :t60], theirs[k, :t60], atol=TOL,
                                   err_msg=f"row {k} ({n} samples) vs JAX")
        alone = tfe.extract_features(torch.from_numpy(y[k, :n].copy()),
                                     SR).numpy()
        assert alone.shape == (t60, 256)
        np.testing.assert_allclose(ours[k, :t60], alone, atol=TOL,
                                   err_msg=f"row {k} vs its true length")
    # the silent row's first and last valid 120 fps frames are dead (every
    # lag < 1e-7) and their neighbours are not: both fixes ran above
    n = int(lens[5])
    c = tfe._device_constants(SR, FRAME, torch.device("cpu"))
    lags = tfe._autocorr_lags(torch.nn.functional.pad(
        torch.from_numpy(y[5:6, None, :n].copy()), (HALF, HALF),
        mode="reflect")[0, 0], FRAME, c).abs().amax(dim=-1)
    assert lags[0] < 1e-7 and lags[-1] < 1e-7
    assert lags[1] > 1e-3 and lags[-2] > 1e-3


def test_garbage_rows_clamp_as_jax_does(rows):
    """Past its valid frames a row is garbage, but the same garbage as
    JAX's: at 0 samples every traced start (t120 - 9, t120 - 2, n - 736) is
    negative and is clamped to 0; at the longest row the odd-tail patch's
    start (t120 // 2) is clamped to the last output row."""
    y, lens, theirs = rows
    ours = tfe.extract_features_valid(torch.from_numpy(y),
                                      torch.from_numpy(lens), SR).numpy()
    assert np.isfinite(ours).all()
    for k in range(len(lens)):
        scale = max(1.0, float(np.abs(theirs[k]).max()))
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0,
                                   atol=1e-5 * scale, err_msg=f"row {k}")


def test_frame_counts_take_tensors():
    n = np.array([0, 1, SHORTEST, 100_000, BUCKET])
    for ours, theirs in ((tfe.num_frames_120, jfe.num_frames_120),
                         (tfe.num_frames_60, jfe.num_frames_60)):
        got = ours(torch.from_numpy(n), FRAME)
        assert got.dtype == torch.int64
        assert got.tolist() == [ours(int(v), FRAME) for v in n] == [
            int(theirs(jnp.int32(v), FRAME)) for v in n]


@pytest.mark.parametrize("dtype", ["int16", "float32", "int32"])
def test_bucketed_extractor_matches_jax(dtype):
    """Integer PCM is widened by its full scale, not peak-normalised."""
    rng = np.random.default_rng(1)
    y = rng.standard_normal(SR) * 0.2
    y = {"int16": (y * 32767).astype(np.int16),
         "int32": (y * 2**31).astype(np.int32),
         "float32": y.astype(np.float32)}[dtype]
    ours = tfe.extract_audio_features_bucketed(y, SR, device="cpu")
    theirs = jfe.extract_audio_features_bucketed(y, SR)
    assert ours.shape == theirs.shape == (tfe.num_frames_60(SR, FRAME), 256)
    np.testing.assert_allclose(ours, theirs, atol=TOL)
    assert tfe.extract_audio_features_bucketed(y[:SHORTEST - 1], SR,
                                               device="cpu") is None


def test_ring_update_and_two_dispatch_tick_match_jax():
    """_tick_program over four gathered rows, two of them padding (idx ==
    K_cap): the per-row roll (a gather at (arange + shift) mod S), the
    append, int16 widening, the rings written back for the live rows only,
    and the feature windows, at T60_cap - f_win and past it (which both
    clamp to T60_cap - f_win)."""
    rng = np.random.default_rng(2)
    k_cap, S, P, f_win = 4, BUCKET, 1 << 14, 64
    buf = (rng.standard_normal((k_cap, S)) * 0.3).astype(np.float32)
    idx = np.array([2, 0, k_cap, k_cap])
    shift = np.array([3 * FRAME, 0, 0, 0])
    buf_len = np.array([90_000, 120_000, 0, 0])
    new_len = np.array([P, 5_000, 0, 0])
    new = np.zeros((4, P), np.int16)
    for i, n in enumerate(new_len):
        new[i, :n] = (rng.standard_normal(n) * 8000).astype(np.int16)
    t60_cap = tfe.num_frames_120(S, FRAME) // 2
    feat_start = np.array([t60_cap - f_win, t60_cap, 0, 0])

    i32 = [jnp.asarray(a, jnp.int32)
           for a in (idx, shift, buf_len, new_len, feat_start)]
    jbuf, jwins = jms._tick_program(
        jnp.asarray(buf), i32[0], jnp.asarray(new), *i32[1:], sr=SR,
        f_win=f_win)
    tbuf = torch.from_numpy(buf.copy())
    twins = tms._tick_program(
        tbuf, *(torch.from_numpy(a) for a in (idx, new, shift, buf_len,
                                               new_len, feat_start)),
        n_live=2, sr=SR, f_win=f_win, feat_dtype=torch.float32)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tbuf.numpy()[[1, 3]], buf[[1, 3]])
    twins, jwins = twins.numpy(), np.asarray(jwins)
    for i in range(2):
        total = buf_len[i] - shift[i] + new_len[i]
        rows = min(f_win, tfe.num_frames_60(int(total), FRAME)
                   - min(feat_start[i], t60_cap - f_win))
        assert rows > 0
        np.testing.assert_allclose(twins[i, :rows], jwins[i, :rows],
                                   atol=TOL, err_msg=f"row {i}")

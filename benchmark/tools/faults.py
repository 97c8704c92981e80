"""Faults planted underneath the timed path, for the check to catch.

Each is a context manager that rebinds one function of the program for
its duration; the benchmark's own runs never enter one. The tests in
benchmark/tests/ and tools/readings.py use them to show that `correct`
comes out false for every fault a cell can have.

- train 'unchanged': a step that computes its loss and gradients and
  returns the parameters as they were;
- train 'half_batch': a step that leaves out half of the batch, the mean
  taken over the rest;
- train 'no_exchange': data-parallel steps whose gradient all-reduce
  between the cards is left out (each rank steps on its own rows);
- train 'wrong_windows': an epoch's batch order shuffled by another seed
  than the loop states;
- train 'dropout_off': every step after the first, so after the epoch's
  first validation, runs with dropout off, as a model left in eval mode by
  the validation would;
- serve 'half_batch': a request whose second half of decoded chunks is
  left out (zeros);
- serve 'altered': a request whose middle frame is altered where it is
  produced (its values negated).
"""

from __future__ import annotations

import contextlib

import numpy as np

FAULTS = {"train": ("unchanged", "half_batch", "no_exchange",
                    "wrong_windows", "dropout_off"),
          "serve": ("half_batch", "altered")}
#: the kind of cell each traffic driver serves
KIND = {"train_loop": "train", "utterances": "serve"}


@contextlib.contextmanager
def _rebind(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _train_fault(kind: str):
    from neurosync_trainer_lite_tpu_torch.training import step as step_mod

    if kind == "no_exchange":
        return _rebind(step_mod, "_reduce_gradients",
                       lambda grads, loss, mesh: loss)
    if kind == "wrong_windows":
        from neurosync_trainer_lite_tpu_torch.data import windowing

        chunks = windowing._iter_index_chunks

        def reordered(idxs, batch_size, *, shuffle, seed, **kw):
            return chunks(idxs, batch_size, shuffle=shuffle,
                          seed=seed + 1 if shuffle else seed, **kw)
        return _rebind(windowing, "_iter_index_chunks", reordered)

    sound = step_mod.make_train_step

    def make(cfg, **kw):
        step = sound(cfg, **kw)

        calls = [0]

        def faulty(state, src, trg, generator):
            calls[0] += 1
            if kind == "dropout_off":
                return step(state, src, trg,
                            generator if calls[0] == 1 else None)
            if kind == "half_batch":
                half = src.shape[0] // 2
                return step(state, src[:half], trg[:half], generator)
            before = [p.detach().clone() for p in state.model.parameters()]
            state, loss, norm = step(state, src, trg, generator)
            for p, b in zip(state.model.parameters(), before):
                p.data.copy_(b)
            return state, loss, norm
        return faulty

    return _rebind(step_mod, "make_train_step", make)


def _serve_fault(kind: str):
    from neurosync_trainer_lite_tpu_torch.inference import device_pipeline

    sound = device_pipeline.blend_decoded_chunks

    def faulty(decoded, lengths, remaining, overlap, num_frames):
        if kind == "half_batch":
            decoded = np.array(decoded)
            decoded[len(decoded) - len(decoded) // 2:] = 0.0
            return sound(decoded, lengths, remaining, overlap, num_frames)
        out = sound(decoded, lengths, remaining, overlap, num_frames)
        out[len(out) // 2] *= -1.0
        return out

    return _rebind(device_pipeline, "blend_decoded_chunks", faulty)


def plant(kind: str, fault: str):
    """The context manager of `fault` for a cell of `kind` ('train' or
    'serve')."""
    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for {kind} cells: "
                         f"{FAULTS[kind]}")
    return (_train_fault if kind == "train" else _serve_fault)(fault)

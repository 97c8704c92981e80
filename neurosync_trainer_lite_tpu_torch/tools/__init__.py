"""The port's runnable probes, the counterparts of the repo root's tools/
(which drive the JAX package). Each runs as

    python -m neurosync_trainer_lite_tpu_torch.tools.<name> [--device cpu] [--tiny] ...

on the CUDA card unless --device names another device, and keeps its JAX
counterpart's flags, defaults, printed lines and JSON record keys:

- serving_soak: unpaced MultiStreamer ticks with session churn;
- serving_knee: intake and decode tick cost at K sessions;
- warmup_probe: time to serve, then a churn soak;
- local_dispatch_probe: the host cost of a tick (--device cpu: the
  in-process CPU, as the JAX probe measures it);
- step_probe: one training configuration's step time (tools/tpu_probe.py);
- data_scale_probe: the data path at the reference's capture scale;
- train_scale_run: the unmodified train_model over such a dataset.

Importing a module here runs nothing: each parses its arguments in main().
"""

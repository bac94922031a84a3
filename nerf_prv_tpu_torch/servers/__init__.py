"""Ready-file daemons and the ``run.py``-compatible NeRF runner, for
clients of the reference's file IPC (``python -m
nerf_prv_tpu_torch.servers.<name>``)."""

"""The benchmark of `streamchat_tpu_torch` on one NVIDIA H100: the harness,
its yardstick (traffic, weights, counts, trace reading) and the plain
reference that decides `correct`. See README.md."""

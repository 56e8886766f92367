"""StreamChat on PyTorch and CUDA: the port of `streamchat_tpu` to one
NVIDIA H100.

The JAX package `streamchat_tpu` stays the reference; this package mirrors
its layout (`ops/`, `models/`, `memory/`, `pipeline/`, `utils/`) and its
public layouts, imports `torch` and never `jax`, and carries hand-written
Hopper kernels under `csrc/` (built by `kernels/build.py`). Importing the
package loads neither the kernels nor any GPU state.
"""

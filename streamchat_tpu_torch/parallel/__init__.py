"""Tensor parallelism over `torch.distributed` (`streamchat_tpu/parallel/`).

The JAX package places one program over a (data, model) `Mesh` and lets
XLA insert the collectives. The port runs one process a rank (`torchrun`,
or `torch.multiprocessing` with the spawn start method); each rank keeps
its slice of the decoder (`sharding.shard_decoder`) and the whole ViT,
projector and embedders, and the decoder's layer loops all-reduce after
the row-parallel projections (`models/decoder.attn_out`, `mlp_out`), the
vocabulary-parallel embedding and the logits. `mesh.make_mesh` lays the
ranks out on the (data, model) mesh (`mesh.Mesh`); `mesh.ModelGroup` is
the model axis as a rank sees it.
"""

from streamchat_tpu_torch.parallel.mesh import (Mesh, ModelGroup, best_mesh_shape, layout,
                                                make_mesh)

__all__ = ["Mesh", "ModelGroup", "best_mesh_shape", "layout", "make_mesh"]

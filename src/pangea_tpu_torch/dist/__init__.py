"""The mesh of ranks and the sharded steps over torch.distributed."""
from .mesh import (Mesh, MeshConfig, MeshStep, choose_mesh,
                   initialize_multihost, make_multik_sharded_classify_fn,
                   make_sharded_classify_fn, place_index)

__all__ = ["Mesh", "MeshConfig", "MeshStep", "choose_mesh",
           "initialize_multihost", "make_multik_sharded_classify_fn",
           "make_sharded_classify_fn", "place_index"]

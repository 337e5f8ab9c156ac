from .mesh import MeshHierarchy, HierarchyBase, refine_mesh
from .transfer import prolong, restrict, inject, get_transfer
from .vcycle import GMGPreconditioner, coarsen_form

__all__ = ["MeshHierarchy", "HierarchyBase", "refine_mesh", "prolong",
           "restrict", "inject", "get_transfer", "GMGPreconditioner",
           "coarsen_form"]

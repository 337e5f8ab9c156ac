"""Load state from the JAX package into the port's objects.

For a finite element problem the state is the mesh coordinates, the
Function dats and the Constant values.  They are handed over as numpy
arrays, so this module imports neither package's array library beyond
torch.  The host layer (meshes, dof numbering) is the same code in both
packages, so dof vectors transfer verbatim; `cell_node_maps` lets the
caller check that numbering bit for bit before the values are trusted.
"""
from __future__ import annotations

import numpy as np

from .function import Function, Constant
from .mesh.geometry import Mesh
from .device import as_tensor


def load_reference_state(mapping, cell_node_maps=None):
    """Assign numpy values to the port's objects.

    mapping         {Function | Constant | Mesh: numpy array}; a Mesh
                    takes its vertex coordinates ((nvert, gdim) or flat),
                    a Function its dof vector (placed on the set device),
                    a Constant its value.
    cell_node_maps  optional {FunctionSpace: reference cell_node_map},
                    each required to equal the port's map exactly; a
                    MixedFunctionSpace takes the list of its subspaces'
                    maps.

    Trace, broken and mixed spaces (the hybridized W = RT x DG, its broken
    counterpart) carry over as any other: a MixedFunction takes the
    concatenated dof vector of its parts, in the order of its subspaces.
    """
    from .mixed import MixedFunctionSpace
    for V, ref in (cell_node_maps or {}).items():
        pairs = (zip(V.subspaces, ref) if isinstance(V, MixedFunctionSpace)
                 else [(V, ref)])
        if isinstance(V, MixedFunctionSpace) \
                and len(ref) != V.num_sub_spaces:
            raise ValueError(f"{len(ref)} maps for the {V.num_sub_spaces} "
                             f"subspaces of {V!r}")
        for Vi, r in pairs:
            ours = np.asarray(Vi.cell_node_map)
            r = np.asarray(r)
            if ours.shape != r.shape or not np.array_equal(ours, r):
                raise ValueError(f"dof numbering of {Vi!r} differs from "
                                 "the reference")
    for obj, value in mapping.items():
        value = np.asarray(value)
        if isinstance(obj, Mesh):
            coords = obj.coordinates
            size = int(np.prod(coords.dat.shape))
            if value.size != size:
                raise ValueError(f"coordinates of size {value.size} for a "
                                 f"mesh with {size}")
            coords.dat = value.astype(np.float64).reshape(-1)
        elif isinstance(obj, Function):
            if value.shape != (obj.function_space().dim,):
                raise ValueError(f"dof vector of shape {value.shape} for "
                                 f"{obj!r}")
            obj.dat = as_tensor(value)
        elif isinstance(obj, Constant):
            if value.shape != obj.shape:
                raise ValueError(f"value of shape {value.shape} for a "
                                 f"Constant of shape {obj.shape}")
            obj.assign(value)
        else:
            raise TypeError(f"cannot load state into {type(obj).__name__}")

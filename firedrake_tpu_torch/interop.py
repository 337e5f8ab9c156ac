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
                    each required to equal the port's map exactly.
    """
    for V, ref in (cell_node_maps or {}).items():
        ours = np.asarray(V.cell_node_map)
        ref = np.asarray(ref)
        if ours.shape != ref.shape or not np.array_equal(ours, ref):
            raise ValueError(f"dof numbering of {V!r} differs from the "
                             "reference")
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

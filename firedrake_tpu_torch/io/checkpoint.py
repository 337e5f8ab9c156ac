"""HDF5 checkpointing: meshes + functions, process-count independent.

Reference: firedrake/checkpointing.py:667 CheckpointFile (PETSc ViewerHDF5
DMPlex topology format v3; save_mesh :735, N-to-M reload) and the legacy
DumbCheckpoint (:64).  Here: h5py directly, in the JAX package's layout,
so a file written by either package loads in the other.  Everything is
stored in GLOBAL numbering; device dats are copied to the host to be
written and back to the set device when read."""
from __future__ import annotations

import numpy as np

from ..device import to_numpy

FILE_CREATE = "w"
FILE_READ = "r"
FILE_UPDATE = "a"

_FORMAT_VERSION = "1.0.0"


class CheckpointFile:
    def __init__(self, filename, mode="r", comm=None):
        import h5py
        self.h5 = h5py.File(filename, mode)
        if mode in ("w", "a"):
            self.h5.attrs["firedrake_tpu_storage_version"] = _FORMAT_VERSION
        self._mesh_cache = {}

    # ------------------------------------------------------------- meshes
    def save_mesh(self, mesh, name=None):
        from ..vertexonly import VertexOnlyMesh
        if isinstance(mesh, VertexOnlyMesh):
            return self._save_vom(mesh, name)
        name = name or mesh.name
        g = self.h5.require_group(f"topologies/{name}")
        g.attrs["cell_type"] = mesh.cell.name
        for key in ("cell_vertices", "coordinates", "facet_markers",
                    "cell_markers"):
            if key in g:
                del g[key]
        g.create_dataset("cell_vertices",
                         data=np.asarray(mesh.topology.cell_vertices))
        g.create_dataset("coordinates",
                         data=np.asarray(mesh._vertex_coords))
        g.create_dataset("facet_markers",
                         data=np.asarray(mesh.facet_markers))
        g.create_dataset("cell_markers",
                         data=np.asarray(mesh.cell_markers))
        # extruded metadata (reference: checkpointing saves the extruded
        # topology's layer structure, checkpointing.py:800+)
        if getattr(mesh, "_extruded", False):
            g.attrs["extruded"] = True
            g.attrs["layers"] = int(mesh._layers)
            base = getattr(mesh, "_base_mesh", None)
            if base is not None:
                g.attrs["base_mesh"] = base.name
                if f"topologies/{base.name}" not in self.h5:
                    self.save_mesh(base)

    def _save_vom(self, vom, name=None):
        name = name or getattr(vom, "name", "vom")
        parent = vom.parent
        if f"topologies/{parent.name}" not in self.h5:
            self.save_mesh(parent)
        g = self.h5.require_group(f"topologies/{name}")
        g.attrs["vertex_only"] = True
        g.attrs["parent"] = parent.name
        if "input_coords" in g:
            del g["input_coords"]
        g.create_dataset("input_coords",
                         data=np.asarray(vom.input_coords))

    def load_mesh(self, name="mesh"):
        if name in self._mesh_cache:
            return self._mesh_cache[name]
        from ..mesh.topology import MeshTopology
        from ..mesh.geometry import Mesh
        g = self.h5[f"topologies/{name}"]
        if g.attrs.get("vertex_only"):
            from ..vertexonly import VertexOnlyMesh
            parent = self.load_mesh(g.attrs["parent"])
            vom = VertexOnlyMesh(parent, np.asarray(g["input_coords"]),
                                 missing_points_behaviour="warn",
                                 name=name)
            self._mesh_cache[name] = vom
            return vom
        cells = np.asarray(g["cell_vertices"])
        coords = np.asarray(g["coordinates"])
        topo = MeshTopology(cells, len(coords), g.attrs["cell_type"], name)
        mesh = Mesh(topo, coords, name=name)
        mesh.facet_markers = np.asarray(g["facet_markers"])
        if "cell_markers" in g:
            mesh.cell_markers = np.asarray(g["cell_markers"])
        if g.attrs.get("extruded"):
            mesh._extruded = True
            mesh._layers = int(g.attrs["layers"])
            if "base_mesh" in g.attrs:
                mesh._base_mesh = self.load_mesh(g.attrs["base_mesh"])
        self._mesh_cache[name] = mesh
        return mesh

    # ---------------------------------------------------------- functions
    def save_function(self, f, idx=None, name=None,
                      timestepping_info=None):
        """timestepping_info: dict of floats (e.g. {"time": t,
        "timestep": dt}) stored per idx (reference:
        checkpointing.py save_function timestepping_info)."""
        from ..function import MixedFunction
        fname = name or f.name
        V = f.function_space()
        mesh = V.mesh_obj
        mname = getattr(mesh, "name", "vom")
        if f"topologies/{mname}" not in self.h5:
            self.save_mesh(mesh)
        if isinstance(f, MixedFunction):
            for i, p in enumerate(f.parts):
                self.save_function(p, idx=idx, name=f"{fname}[{i}]",
                                   timestepping_info=timestepping_info)
            g = self.h5.require_group(
                f"topologies/{mname}/functions/{fname}")
            g.attrs["mixed"] = len(f.parts)
            return
        g = self.h5.require_group(
            f"topologies/{mname}/functions/{fname}")
        g.attrs["family"] = V.scalar_element.family
        g.attrs["degree"] = V.scalar_element.degree
        g.attrs["block_size"] = V.block_size
        key = "dat" if idx is None else f"dat_{idx}"
        if key in g:
            del g[key]
        ds = g.create_dataset(key, data=to_numpy(f.dat))
        if timestepping_info:
            for k, v in timestepping_info.items():
                ds.attrs[k] = float(v)

    def load_function(self, mesh, name, idx=None):
        from ..functionspace import FunctionSpace, VectorFunctionSpace
        from ..function import Function
        from ..mixed import MixedFunctionSpace
        g = self.h5[f"topologies/{mesh.name}/functions/{name}"]
        if "mixed" in g.attrs:
            parts = [self.load_function(mesh, f"{name}[{i}]", idx=idx)
                     for i in range(int(g.attrs["mixed"]))]
            W = MixedFunctionSpace([p.function_space() for p in parts])
            f = Function(W, name=name)
            for fp, p in zip(f.parts, parts):
                fp.dat = p.dat
            return f
        family = g.attrs["family"]
        degree = int(g.attrs["degree"])
        bs = int(g.attrs["block_size"])
        # family strings are the canonical element names; the element
        # factory round-trips them (elements/lagrange.py
        # make_scalar_element)
        if bs == 1:
            V = FunctionSpace(mesh, family, degree)
        else:
            V = VectorFunctionSpace(mesh, family, degree, dim=bs)
        f = Function(V, name=name)
        key = "dat" if idx is None else f"dat_{idx}"
        f.dat = np.asarray(g[key])
        return f

    def get_timestepping_history(self, mesh, name):
        """{"index": [...], <info key>: [...]} for every stored idx
        (reference: checkpointing.py get_timestepping_history)."""
        mname = getattr(mesh, "name", "vom")
        g = self.h5[f"topologies/{mname}/functions/{name}"]
        idxs = sorted(int(k[4:]) for k in g.keys() if k.startswith("dat_"))
        out = {"index": idxs}
        keys = set()
        for i in idxs:
            keys.update(g[f"dat_{i}"].attrs.keys())
        for k in keys:
            out[k] = [g[f"dat_{i}"].attrs.get(k, np.nan) for i in idxs]
        return out

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DumbCheckpoint:
    """Legacy same-layout checkpoint (reference: checkpointing.py:64)."""

    def __init__(self, basename, mode="w", comm=None):
        import h5py
        suffix = "" if basename.endswith(".h5") else ".h5"
        self.h5 = h5py.File(basename + suffix, mode)

    def store(self, f, name=None):
        name = name or f.name
        if name in self.h5:
            del self.h5[name]
        self.h5.create_dataset(name, data=to_numpy(f.dat))

    def load(self, f, name=None):
        name = name or f.name
        f.dat = np.asarray(self.h5[name])
        return f

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

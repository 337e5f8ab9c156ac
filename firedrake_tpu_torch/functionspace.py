"""Function spaces: element -> global dof numbering + cell-node maps.

Reference: firedrake/functionspaceimpl.py:500 and functionspacedata.py:398
(shared per-(mesh, element) data: node sets :92, cell node lists :116,
boundary masks :206; PETSc Section construction dmcommon.pyx:1280).

Global numbering is a pure offset computation over mesh entities:
    dof(entity of dim d, index g, internal k) = offset[d] + g*npe[d] + k
with cell-local views permuted per entity orientation (the reference handles
this with plex orientations, dmcommon.pyx:1193).  The product is ONE static
int32 array ``cell_node_map`` (ncell, ndof_per_cell) — the gather/scatter
index table the TPU executor consumes.
"""
from __future__ import annotations

import itertools
import numpy as np
from functools import cached_property, lru_cache

from .elements import (FiniteElement, VectorElement, TensorElement,
                       make_scalar_element)
from .mesh.geometry import Mesh
from .mesh.topology import _IDX


# --------------------------------------------------------------------- data
class FunctionSpaceData:
    """Shared numbering data per (mesh topology, scalar element).

    Reference: firedrake/functionspacedata.py:398 FunctionSpaceData,
    get_shared_data :524 (cached per mesh)."""

    def __init__(self, mesh: Mesh, element: FiniteElement):
        self.mesh = mesh
        self.element = element
        self.node_perm = None
        self.grid_numbered = False
        if getattr(mesh, "is_vertex_only", False):
            # vertices ARE cells: one P0 node per vertex (reference:
            # mesh.py VertexOnlyMeshTopology — swarm points as cells)
            if element.ndof != 1 or element.degree != 0:
                raise ValueError("VertexOnlyMesh supports only P0DG")
            self.npe_class = {}
            self.npe = {}
            self.offsets = {}
            self.num_nodes = mesh.num_cells
            self.cell_node_map = np.arange(mesh.num_cells,
                                           dtype=_IDX)[:, None]
            return
        topo = mesh.topology
        if getattr(element, "family", "") == "Real":
            # one GLOBAL dof: every cell maps to it (reference:
            # functionspaceimpl.py:1175 RealFunctionSpace)
            self.npe_class = {}
            self.npe = {}
            self.offsets = {}
            self.num_nodes = 1
            self.cell_node_map = np.zeros((topo.num_cells, 1), dtype=_IDX)
            return
        ed = element.entity_dofs
        dims = sorted(ed.keys())
        cell = topo.cell

        def _local_arity(d, e):
            if d == 0:
                return 1
            row = cell.topology[d][e]
            return int((np.asarray(row) >= 0).sum())

        # dofs-per-entity may differ per ARITY CLASS (prisms mix triangle
        # and quadrilateral faces); uniform meshes degenerate to one class
        self.npe_class = {}            # (d, arity) -> ndofs
        for d in dims:
            for e, dofs in ed[d].items():
                a = _local_arity(d, e)
                prev = self.npe_class.get((d, a))
                if prev is None:
                    self.npe_class[(d, a)] = len(dofs)
                else:
                    assert prev == len(dofs), \
                        "inconsistent dofs within an arity class"
        # legacy uniform view (None when classes differ)
        self.npe = {}
        for d in dims:
            vals = {v for (dd, a), v in self.npe_class.items() if dd == d}
            self.npe[d] = vals.pop() if len(vals) == 1 else None
        off = 0
        self.offsets = {}              # (d, arity) -> start offset
        for d in dims:
            for a, cnt in sorted(topo.entity_class_counts(d).items()):
                npe = self.npe_class.get((d, a), 0)
                self.offsets[(d, a)] = off
                off += cnt * npe
        self.num_nodes = off
        self._build_cell_node_map()
        #: grid renumbering on structured meshes (assembly/stencil.py):
        #: node id == gi + gj*gnx on the fine k-lattice, so higher-degree
        #: CG assembly can use the zero-gather stencil path (the locality
        #: role of the reference's dof reordering, firedrake/mesh.py:578)
        self.node_perm = None
        self.grid_numbered = False
        self._maybe_grid_renumber()
        #: column renumbering on extruded meshes (assembly/columns.py):
        #: node id == base_node * Hd + z, the O(base) column metadata of
        #: the reference (extrusion_numbering.pyx:222) — makes the layer
        #: axis a dense strided slice for the TPU fast path (SURVEY §5.7)
        self.column = None
        self.column_numbered = False
        self._maybe_column_renumber()

    def _maybe_column_renumber(self):
        import os
        if os.environ.get("FDTPU_NO_COLUMN_NUMBERING") == "1":
            return
        mesh, elem = self.mesh, self.element
        if not getattr(mesh, "_extruded", False):
            return
        if getattr(mesh, "_var_layers", None) is not None:
            return      # ragged columns: generic numbering/executor
        if getattr(elem, "family", None) != "Lagrange":
            return
        # the JAX package renumbers dofs column-major here for its
        # column executor (assembly/columns.py), which is not ported
        raise NotImplementedError(
            "column-numbered spaces on extruded meshes (assembly/columns.py)"
            " are not ported yet: ROADMAP.md queue 1, item 15")

    def _maybe_grid_renumber(self):
        import os
        if os.environ.get("FDTPU_NO_GRID_NUMBERING") == "1":
            return
        mesh, elem = self.mesh, self.element
        s = getattr(mesh, "_structured", None)
        if s is None or getattr(elem, "family", None) != "Lagrange":
            return
        k = elem.degree
        if k < 2:
            self.grid_numbered = True       # vertex order IS grid order
            return
        from .assembly.stencil import (grid_slot_offsets,
                                       type_vertex_offsets, struct_dims,
                                       _cell_grid_index)
        offs = grid_slot_offsets(elem, type_vertex_offsets(mesh))
        if offs is None:
            return
        dims = struct_dims(s)
        D = len(dims)
        ntypes = len(offs)
        old = self.cell_node_map.astype(np.int64)
        if old.shape[0] != ntypes * int(np.prod(dims)):
            return
        gdims = tuple(k * n + 1 for n in dims)
        if self.num_nodes != int(np.prod(gdims)):
            return
        c = np.arange(old.shape[0])
        t = c % ntypes
        qidx = _cell_grid_index(c // ntypes, dims)
        oarr = np.asarray(offs)                     # (ntypes, nd, D)
        strides = np.cumprod((1,) + gdims[:-1])
        pred = np.zeros_like(old)
        for ax in range(D):
            o = oarr[t][:, :, ax]
            pred += (qidx[ax][:, None] * k + o) * strides[ax]
        perm = np.full(self.num_nodes, -1, dtype=np.int64)
        perm[old.ravel()] = pred.ravel()
        # dofs are identified by geometric node position from every cell,
        # so the map must be a consistent bijection — verify fully
        if (perm < 0).any() or not np.array_equal(perm[old], pred):
            return
        if np.unique(perm).size != self.num_nodes:
            return
        self.cell_node_map = pred.astype(_IDX)
        self.node_perm = perm
        self.grid_numbered = True

    def _build_cell_node_map(self):
        topo = self.mesh.topology
        elem = self.element
        cell = topo.cell
        ncell = topo.num_cells
        cmap = np.zeros((ncell, elem.ndof), dtype=_IDX)
        for d, ents in elem.entity_dofs.items():
            ce = topo.cell_entities(d)                   # (ncell, n_local)
            co = topo.cell_entity_orientations(d)        # (ncell, n_local)
            cidx = topo.entity_class_index(d)
            for e, slots in ents.items():
                if not slots:
                    continue
                if d == 0:
                    a = 1
                else:
                    row = cell.topology[d][e] if d < topo.dim else \
                        np.arange(cell.num_vertices)
                    a = int((np.asarray(row) >= 0).sum())
                npe = self.npe_class[(d, a)]
                perm_needed = not (d == 0 or d == topo.dim or npe == 1)
                if perm_needed:
                    import math
                    nvpe = a
                    n_ori = math.factorial(nvpe)

                    def _perm(o):
                        # heterogeneous entity classes (prism tri/quad
                        # faces) need the per-entity representative;
                        # older element types only take (dim, o)
                        try:
                            return elem.entity_permutation(d, o,
                                                           entity=e)
                        except TypeError:
                            return elem.entity_permutation(d, o)

                    perm_table = np.stack(
                        [np.asarray(_perm(o)) for o in range(n_ori)])
                g = ce[:, e].astype(np.int64)
                gc = cidx[g]                             # within-class idx
                base = self.offsets[(d, a)] + gc * npe
                if perm_needed:
                    p = perm_table[co[:, e]]
                    vals = base[:, None] + p
                else:
                    vals = base[:, None] + np.arange(npe)
                cmap[:, slots] = vals.astype(_IDX)
        self.cell_node_map = cmap

    @property
    def cell_dof_signs(self):
        """(ncell, ndof) ±1 signs for facet-flux dofs (H(div)/H(curl)):
        a cell whose view of the facet has odd orientation parity sees the
        canonical facet normal/tangent flipped (FIAT orientation-sign
        analogue)."""
        if getattr(self, "_signs", None) is not None:
            return self._signs
        import math, itertools
        topo = self.mesh.topology
        elem = self.element
        signs = np.ones((topo.num_cells, elem.ndof))
        if getattr(elem, "facet_dof_sign_flip", False):
            fd = topo.dim - 1
            nvpf = topo.cell.topology[fd].shape[1]
            perms = list(itertools.permutations(range(nvpf)))

            def parity(p):
                p = list(p)
                sgn = 1
                for i in range(len(p)):
                    for j in range(i + 1, len(p)):
                        if p[i] > p[j]:
                            sgn = -sgn
                return sgn

            co = topo.cell_entity_orientations(fd)
            for e, slots in elem.entity_dofs[fd].items():
                if not slots:
                    continue
                # per-entity sign tables: mixed-arity cells (prisms)
                # carry different dof counts per facet class, so the
                # table is built per entity (facet_dof_signs may take
                # the local entity id)
                if hasattr(elem, "facet_dof_signs"):
                    try:
                        table = np.stack(
                            [elem.facet_dof_signs(o, e)
                             for o in range(len(perms))])
                    except TypeError:
                        table = np.stack(
                            [elem.facet_dof_signs(o)
                             for o in range(len(perms))])
                else:
                    table = np.stack(
                        [parity(p) * np.ones(len(slots))
                         for p in perms])
                local = elem.local_facet_sign(e) \
                    if hasattr(elem, "local_facet_sign") else 1.0
                signs[:, slots] = local * table[co[:, e]]
        if getattr(elem, "edge_dof_sign_flip", False):
            # H(curl) tangential edge dofs in 3D: sign = does the cell's
            # listed edge direction match the canonical (sorted global
            # vertex) direction (the edge analogue of facet flux signs)
            co = topo.cell_entity_orientations(1)
            table = np.stack([elem.edge_dof_signs(o) for o in range(2)])
            for e, slots in elem.entity_dofs[1].items():
                if not slots:
                    continue
                signs[:, slots] = table[co[:, e]]
        self._signs = signs
        return signs

    @property
    def has_dof_signs(self):
        return (getattr(self.element, "facet_dof_sign_flip", False)
                or getattr(self.element, "edge_dof_sign_flip", False))

    @property
    def has_dof_transforms(self):
        """Matrix-valued entity transformations (multi-moment tet faces:
        RT/BDM degree >= 2, BDM any degree, N1curl faces — the FIAT
        entity_transformations role).  Mutually exclusive with the
        diagonal sign path."""
        return getattr(self.element, "has_dof_transforms", False)

    @property
    def cell_dof_transforms(self):
        """(ncell, ndof, ndof) per-cell LOCAL <- CANONICAL dof transform
        B: coefficient gathers apply B, local tensors map B^T A B (see
        elements/hdiv.py _tri_face_transform_tables)."""
        if getattr(self, "_dof_T", None) is not None:
            return self._dof_T
        topo = self.mesh.topology
        elem = self.element
        nd = elem.ndof
        T = np.tile(np.eye(nd), (topo.num_cells, 1, 1))
        for d in range(1, topo.dim):
            tab = (elem.entity_transforms(d)
                   if hasattr(elem, "entity_transforms") else None)
            if tab is None:
                continue
            co = topo.cell_entity_orientations(d)
            for e, slots in elem.entity_dofs[d].items():
                if not slots:
                    continue
                sl = np.asarray(slots)
                sign = (elem.local_facet_sign(e)
                        if (d == topo.dim - 1
                            and hasattr(elem, "local_facet_sign"))
                        else 1.0)
                T[:, sl[:, None], sl[None, :]] = sign * tab[co[:, e]]
        self._dof_T = T
        return T

    # ---------------------------------------------------------- boundaries
    @lru_cache(maxsize=None)
    def _facet_closure_template(self, local_facet: int):
        """For a local facet, the list of (entity_dim, cell-local entity id)
        in its closure (vertices, edges (3D), the facet itself)."""
        cell = self.mesh.cell
        d = cell.dim - 1
        out = []
        fverts = set(int(v) for v in cell.facets[local_facet])
        for ed in range(0, d + 1):
            for eid, evs in enumerate(cell.topology[ed]):
                if set(int(v) for v in evs) <= fverts:
                    out.append((ed, eid))
        return out

    def boundary_nodes(self, facet_ids: np.ndarray) -> np.ndarray:
        """Global node ids on the closure of the given facets (reference:
        dmcommon.pyx:1689 facet_closure_nodes; bcs.py:129 DirichletBC.nodes)."""
        topo = self.mesh.topology
        cell = topo.cell
        fc = topo.facet_cells[facet_ids, 0]
        fl = topo.facet_local_id[facet_ids, 0]
        nodes = []
        for lf in np.unique(fl):
            sel = fl == lf
            cells = fc[sel]
            for ed, eid in self._facet_closure_template(int(lf)):
                if ed == 0:
                    a = 1
                else:
                    row = cell.topology[ed][eid]
                    a = int((np.asarray(row) >= 0).sum())
                npe = self.npe_class.get((ed, a), 0)
                if npe == 0:
                    continue
                g = topo.cell_entities(ed)[cells, eid].astype(np.int64)
                gc = topo.entity_class_index(ed)[g]
                base = self.offsets[(ed, a)] + gc * npe
                nodes.append((base[:, None] + np.arange(npe)).ravel())
        if not nodes:
            return np.zeros(0, dtype=_IDX)
        out = np.unique(np.concatenate(nodes))
        if self.node_perm is not None:
            out = np.sort(self.node_perm[out])
        return out.astype(_IDX)


_fsdata_cache: dict = {}


def get_shared_data(mesh: Mesh, element: FiniteElement) -> FunctionSpaceData:
    key = (id(mesh), hash(element))
    if key not in _fsdata_cache:
        _fsdata_cache[key] = FunctionSpaceData(mesh, element)
    return _fsdata_cache[key]


# -------------------------------------------------------------------- space
class FunctionSpace:
    """A (scalar/vector/tensor) function space over a mesh.

    Reference: firedrake/functionspaceimpl.py:500 (FunctionSpace),
    :486 (WithGeometry — we hold the mesh directly)."""

    def __init__(self, mesh: Mesh, family, degree: int | None = None,
                 name: str | None = None, vector_dim: int | None = None,
                 tensor_shape: tuple | None = None, variant=None,
                 vfamily=None, vdegree=None):
        self.mesh_obj = mesh
        if hasattr(family, "resolve"):
            # element spec objects (tensor-product elements; not ported)
            family = family.resolve()
        if isinstance(family, FiniteElement):
            elem = family
            if (tensor_shape is not None
                    and not isinstance(elem, TensorElement)):
                elem = TensorElement(elem, tensor_shape)
            elif (vector_dim is not None
                    and not isinstance(elem, VectorElement)):
                elem = VectorElement(elem, vector_dim)
            scalar = elem.sub if isinstance(elem, VectorElement) else elem
        else:
            if vfamily is not None:
                # extruded tensor-product spelling: CG/DG x CG/DG
                # collapses to the prism/quad/hex lattice element when
                # horizontal == vertical (reference: firedrake
                # functionspace.py make_scalar_element TensorProduct)
                fnorm = {"CG": "Lagrange", "Q": "Lagrange",
                         "Lagrange": "Lagrange", "DG": "DG",
                         "DQ": "DG",
                         "Discontinuous Lagrange": "DG"}.get(family,
                                                             family)
                vnorm = {"CG": "Lagrange", "Lagrange": "Lagrange",
                         "DG": "DG",
                         "Discontinuous Lagrange": "DG"}.get(vfamily,
                                                             vfamily)
                vd = vdegree if vdegree is not None else degree
                if not (fnorm == vnorm and vd == degree):
                    raise NotImplementedError(
                        "tensor-product spaces with differing "
                        "horizontal/vertical family or degree")
            scalar = make_scalar_element(mesh.cell.name, family, degree,
                                         variant=variant)
            if tensor_shape is not None:
                elem = TensorElement(scalar, tensor_shape)
            elif vector_dim is not None:
                elem = VectorElement(scalar, vector_dim)
            else:
                elem = scalar
        self.element = elem
        self.scalar_element = scalar
        self.name = name or f"FS({scalar.family},{scalar.degree})"
        self.sdata = get_shared_data(mesh, scalar)
        if isinstance(elem, (VectorElement, TensorElement)):
            self.block_size = elem.ncomp
            self.value_shape = elem.value_shape
        else:
            self.block_size = 1
            self.value_shape = elem.value_shape
        self._subspaces = None     # mixed support in functionspace layer

    # ------------------------------------------------------------- queries
    def mesh(self):
        return self.mesh_obj

    @property
    def num_nodes(self):
        return self.sdata.num_nodes

    @property
    def dim(self):
        """Total global dof count (reference: V.dim())."""
        return self.num_nodes * self.block_size

    @property
    def node_count(self):
        return self.num_nodes

    @property
    def dof_count(self):
        return self.dim

    @cached_property
    def cell_node_map(self) -> np.ndarray:
        """(ncell, ndof_scalar) int32 — scalar node indices per cell."""
        return self.sdata.cell_node_map

    @cached_property
    def cell_dof_map(self) -> np.ndarray:
        """(ncell, ndof_scalar*bs) indices into the flat dof vector, matching
        the element's interleaved (node-major, component-minor) layout."""
        bs = self.block_size
        cnm = self.cell_node_map.astype(np.int64)
        if bs == 1:
            return cnm.astype(_IDX)
        expanded = cnm[:, :, None] * bs + np.arange(bs)[None, None, :]
        return expanded.reshape(cnm.shape[0], -1).astype(_IDX)

    def boundary_nodes(self, subdomain) -> np.ndarray:
        facets = self.mesh_obj.boundary_facets(subdomain)
        return self.sdata.boundary_nodes(facets)

    @property
    def has_dof_signs(self):
        return self.sdata.has_dof_signs

    @cached_property
    def cell_dof_signs(self) -> np.ndarray:
        """(ncell, ndof*bs) ±1 (expanded over components)."""
        signs = self.sdata.cell_dof_signs
        if self.block_size == 1:
            return signs
        return np.repeat(signs, self.block_size, axis=1)

    @property
    def has_dof_transforms(self):
        return self.sdata.has_dof_transforms

    @cached_property
    def cell_dof_transforms(self) -> np.ndarray:
        """(ncell, ndof, ndof) per-cell local<-canonical transform
        (block_size is always 1 for the vector-valued H(div)/H(curl)
        elements that need this)."""
        assert self.block_size == 1
        return self.sdata.cell_dof_transforms

    # UFL-compat helpers
    def ufl_element(self):
        return self.element

    @property
    def shape(self):
        return self.value_shape

    @property
    def value_size(self):
        import numpy as _np
        return int(_np.prod(self.value_shape)) if self.value_shape else 1

    def split(self):
        return (self,)

    def sub(self, i: int):
        """Component subspace of a Vector/TensorFunctionSpace — used for
        component-wise DirichletBCs (reference: functionspaceimpl.py
        WithGeometry.sub / ComponentFunctionSpace)."""
        if self.block_size == 1:
            assert i == 0
            return self
        assert 0 <= i < self.block_size
        return ComponentFunctionSpace(self, i)

    @property
    def num_sub_spaces(self):
        return 1

    def __eq__(self, other):
        return (isinstance(other, FunctionSpace)
                and self.mesh_obj is other.mesh_obj
                and self.element == other.element)

    def __hash__(self):
        return hash((id(self.mesh_obj), hash(self.element)))

    def __mul__(self, other):
        """V * Q builds a MixedFunctionSpace in the reference
        (functionspaceimpl.py WithGeometry.__mul__)."""
        raise NotImplementedError("mixed spaces (V * Q) are not ported "
                                  "yet: ROADMAP.md queue 1, item 14")

    def __repr__(self):
        return (f"FunctionSpace({self.mesh_obj.name}, "
                f"{self.element!r}, dim={self.dim})")


class ComponentFunctionSpace:
    """V.sub(i) for vector/tensor spaces: delegates to V but records the
    component for DirichletBC expansion."""

    def __init__(self, parent: FunctionSpace, component: int):
        self.parent_space = parent
        self.component = component

    def __getattr__(self, name):
        return getattr(self.parent_space, name)

    def __repr__(self):
        return f"{self.parent_space!r}.sub({self.component})"


def VectorFunctionSpace(mesh, family, degree=None, dim=None, name=None,
                        variant=None):
    d = dim if dim is not None else mesh.geometric_dimension
    return FunctionSpace(mesh, family, degree, name=name, vector_dim=d,
                         variant=variant)


def TensorFunctionSpace(mesh, family, degree=None, shape=None, name=None,
                        variant=None):
    g = mesh.geometric_dimension
    shape = shape if shape is not None else (g, g)
    return FunctionSpace(mesh, family, degree, name=name, tensor_shape=shape,
                         variant=variant)


class RestrictedFunctionSpace(FunctionSpace):
    """Function space with the dofs on ``boundary_set`` REMOVED from the
    global system (reference: functionspaceimpl.py:932
    RestrictedFunctionSpace — strong bcs baked into the space so the
    assembled operators are genuinely smaller/SPD).

    Removed dofs map to a SENTINEL index one past the end; scatters
    drop out-of-bounds targets and the sparsity construction assigns
    sentinel positions, so assembly needs no special-casing."""

    def __init__(self, V: FunctionSpace, boundary_set=(), name=None):
        if isinstance(boundary_set, (int, str)):
            boundary_set = (boundary_set,)
        self.mesh_obj = V.mesh_obj
        self.element = V.element
        self.scalar_element = V.scalar_element
        self.block_size = V.block_size
        self.value_shape = V.value_shape
        self.sdata = V.sdata
        self.boundary_set = tuple(boundary_set)
        self._V = V
        self.name = name or f"Restricted({V.name})"
        self._subspaces = None
        removed = np.unique(np.concatenate(
            [V.sdata.boundary_nodes(V.mesh_obj.boundary_facets(sub))
             for sub in boundary_set])) if boundary_set else \
            np.zeros(0, dtype=np.int64)
        keep = np.ones(V.num_nodes, dtype=bool)
        keep[removed] = False
        self._nfree = int(keep.sum())
        perm = np.full(V.num_nodes, self._nfree, dtype=np.int64)
        perm[keep] = np.arange(self._nfree)
        self._node_perm = perm
        # shadow the base cached_properties via instance attributes
        self.cell_node_map = perm[V.cell_node_map].astype(np.int64)

    @property
    def num_nodes(self):
        return self._nfree

    def boundary_nodes(self, subdomain):
        nodes = self._node_perm[self._V.boundary_nodes(subdomain)]
        return nodes[nodes < self._nfree]

    @property
    def restriction_sig(self):
        return f"|restricted{sorted(map(str, self.boundary_set))}"

    def __repr__(self):
        return self.name

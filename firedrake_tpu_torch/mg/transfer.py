"""Grid transfer: prolong / restrict / inject between hierarchy levels.

Reference: firedrake/mg/kernels.py:155/:256/:347 (TSFC-generated transfer
kernels executed as parloops, mg/interface.py:37,116,193) and
mg/mgimpl.pyx coarse<->fine maps.  The tables are built on the host in
numpy, as in the JAX package; the transfers are plain torch functions:

  prolong:  fine nodal values = coarse basis at child-mapped fine nodes
  restrict: exact transpose of prolong (dual/residual transfer), using
            fine-dof multiplicity weighting for the cellwise transpose
  inject:   coarse nodal values = fine function at coarse node points

On structured hierarchies (StructuredTransfer) each is a handful of
strided slices and strided slice-adds, with no index arrays.

Between the levels of a NonNestedHierarchy (NonNestedTransfer) the
transfers are cross-mesh interpolation matrices: prolongation locates the
fine nodes in the coarse mesh, injection the coarse nodes in the fine
mesh, and restriction applies the prolongation's transpose, kept as a
matrix of its own so that its sums run in a fixed order.
TransferManager moves non-nodal spaces through an embedding DG space.

Not ported yet: the adaptive transfers.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import as_tensor

__all__ = ["LevelTransfer", "StructuredTransfer", "NonNestedTransfer",
           "TransferManager", "get_transfer", "prolong", "restrict",
           "inject"]


def _geometric_child_maps(mc, mf, type_of=None):
    """Per-type, per-child affine reference maps (A, b) with child_ref
    = A s + b, computed from actual vertex coordinates and VERIFIED
    against every coarse cell of the type (refinement is uniform within
    a type; orientation forcing at mesh build permutes vertices
    identically across same-type cells).  type_of: per-coarse-cell
    refinement variant (tets choose the shortest octahedron diagonal),
    None = single type."""
    tdim = mc.cell.dim
    Xc = mc._vertex_coords[mc.topology.cell_vertices]   # (nc, nv, g)
    Xf = mf._vertex_coords[mf.topology.cell_vertices]
    c2f = np.asarray(mf._c2f_cells)                     # (nc, nchild)
    v0 = Xc[:, 0]
    Ac = np.stack([Xc[:, k + 1] - Xc[:, 0] for k in range(tdim)],
                  axis=-1)                              # (nc, g, t)
    Aci = np.linalg.inv(Ac)
    # children of every coarse cell pulled back to coarse ref coords
    q = np.einsum("ctg,cnvg->cnvt", Aci,
                  Xf[c2f] - v0[:, None, None, :])       # (nc,nch,nv,t)
    if type_of is None:
        type_of = np.zeros(len(q), dtype=np.int64)
    ntypes = int(type_of.max()) + 1
    out_types = []
    for t in range(ntypes):
        qt = q[type_of == t]
        if not len(qt):
            # type unused on this mesh: placeholder identity maps (the
            # per-type tables are never gathered for an empty type)
            out_types.append([(np.eye(tdim), np.zeros(tdim))]
                             * c2f.shape[1])
            continue
        if not np.allclose(qt, qt[0][None], atol=1e-10):
            raise RuntimeError("refinement is not cell-uniform within "
                               "a type; cannot build transfer maps")
        maps = []
        for verts in qt[0]:                             # (nv, tdim)
            A = np.stack([verts[k + 1] - verts[0] for k in range(tdim)],
                         axis=1)
            maps.append((A, verts[0]))
        out_types.append(maps)
    return out_types


class LevelTransfer:
    """Transfer ops between Vc (coarse) and Vf (fine = refined mesh),
    through per-type prolongation tables and the coarse->fine cell map.

    Structured hierarchies carry PER-TYPE child reference maps
    (mf._child_maps — the two triangles of each grid quad refine
    differently); classic refinement has one type."""

    def __init__(self, Vc, Vf):
        self.Vc, self.Vf = Vc, Vf
        mc, mf = Vc.mesh_obj, Vf.mesh_obj
        assert getattr(mf, "_coarse_mesh", None) is mc, \
            "fine mesh is not a refinement of the coarse mesh"
        elem = Vc.scalar_element
        assert elem == Vf.scalar_element
        cmaps_by_type = getattr(mf, "_child_maps", None)
        if cmaps_by_type is None:
            # derive the child affine maps geometrically from the two
            # meshes (and verify them on every cell): the mesh constructor
            # forces positive orientation by swapping vertices, which the
            # tabulated child_reference_maps do not know about
            cmaps_by_type = _geometric_child_maps(
                mc, mf, getattr(mf, "_c2f_type_of", None))
        ntypes = len(cmaps_by_type)
        self.ntypes = ntypes
        nodes = elem.nodes                               # (nd, tdim)
        nd = elem.ndof
        P_t, child_t, I_t = [], [], []
        for cmaps in cmaps_by_type:
            P_t.append(np.stack([elem.tabulate(nodes @ A.T + b, 0)[0]
                                 for (A, b) in cmaps]))  # (nchild, nd, nd)
            # injection: for each coarse node, owning child + basis vals
            child_of = np.zeros(nd, dtype=np.int64)
            I = np.zeros((nd, nd))
            for n, p in enumerate(nodes):
                for k, (A, b) in enumerate(cmaps):
                    q = np.linalg.solve(A, p - b)
                    if mc.cell.contains_points(q[None])[0]:
                        child_of[n] = k
                        I[n] = elem.tabulate(q[None], 0)[0][0]
                        break
                else:
                    raise RuntimeError("coarse node not in any child")
            child_t.append(child_of)
            I_t.append(I)
        self.P = [as_tensor(P) for P in P_t]
        self.child_of = [as_tensor(c) for c in child_t]
        self.I = [as_tensor(I) for I in I_t]

        c2f = np.asarray(mf._c2f_cells)                  # (ncoarse, nchild)
        self.bs = Vc.block_size
        self.nd = nd
        cmap = np.asarray(Vc.cell_dof_map)
        fmap = np.asarray(Vf.cell_dof_map)
        # per coarse type: structured grids interleave (cell=ntypes*q+t);
        # tet refinement records each cell's variant instead
        type_of = getattr(mf, "_c2f_type_of", None)
        if type_of is None:
            type_of = np.arange(c2f.shape[0]) % ntypes
        self.cmap_t = [as_tensor(cmap[type_of == t].astype(np.int64))
                       for t in range(ntypes)]
        self.fmap_t = [as_tensor(fmap[c2f[type_of == t]].astype(np.int64))
                       for t in range(ntypes)]   # (ncq, nchild, nd*bs)
        # fine dof multiplicity (for the cellwise transpose in restrict)
        mult = np.zeros(Vf.dim)
        np.add.at(mult, fmap.reshape(-1), 1.0)
        self.fine_mult = as_tensor(np.where(mult > 0, mult, 1.0))

    def _blocked(self, dofs):
        # (..., nd*bs) -> (..., nd, bs)
        return dofs.reshape(dofs.shape[:-1] + (self.nd, self.bs))

    def prolong_fn(self, cdat):
        out = cdat.new_zeros(self.Vf.dim)
        for t in range(self.ntypes):
            cd = self._blocked(cdat[self.cmap_t[t]])     # (nc, nd, bs)
            vals = torch.einsum("kij,njb->nkib", self.P[t], cd)
            out[self.fmap_t[t].reshape(-1)] = vals.reshape(-1)
        return out

    def restrict_fn(self, fdual):
        fw = fdual / self.fine_mult
        out = fdual.new_zeros(self.Vc.dim)
        for t in range(self.ntypes):
            fd = self._blocked(fw[self.fmap_t[t]])       # (nc, k, nd, bs)
            vals = torch.einsum("kij,nkib->njb", self.P[t], fd)
            out.index_add_(0, self.cmap_t[t].reshape(-1), vals.reshape(-1))
        return out

    def inject_fn(self, fdat):
        out = fdat.new_zeros(self.Vc.dim)
        for t in range(self.ntypes):
            fd = self._blocked(fdat[self.fmap_t[t]])     # (nc, k, nd, bs)
            sel = fd[:, self.child_of[t]]                # (nc, ndc, nd, bs)
            vals = torch.einsum("njib,ji->njb", sel, self.I[t])
            out[self.cmap_t[t].reshape(-1)] = vals.reshape(-1)
        return out


def _grid_transfer_classes(mesh, elem):
    """Residue-class stencil table for grid transfers at any degree.

    A grid-numbered degree-k space on a 2x-refined structured mesh is
    NESTED in the fine space; the fine node at fine-lattice position f
    evaluates the coarse function at coarse-quad position f/(2k), so
    prolongation decomposes into (2k)^D residue classes.  For class
    r = f mod 2k the weights are the coarse basis values at the point
    r/(2k) of the containing cell type; slots off a shared lattice plane
    (r_ax == 0) have zero weight there (Lagrange trace property), which
    keeps every class a pure strided-slice program.

    Returns (k, D, classes) with classes[r] = [(slot_offset, weight)]."""
    from ..assembly.stencil import type_vertex_offsets, grid_slot_offsets
    tverts = type_vertex_offsets(mesh)
    offs = grid_slot_offsets(elem, tverts)
    k = elem.degree
    D = len(tverts[0][0])
    classes = {}
    for r in itertools.product(range(2 * k), repeat=D):
        pt = np.asarray(r, dtype=np.float64) / (2 * k)
        found = None
        for t, verts in enumerate(tverts):
            V = np.asarray(verts, dtype=np.float64)
            if len(V) == D + 1:
                E = (V[1:] - V[:1]).T
                lam = np.linalg.solve(E, pt - V[0])
                if lam.min() < -1e-12 or lam.sum() > 1 + 1e-12:
                    continue
                ref = lam
            else:
                ref = pt                        # unit-cube reference
            found = (t, ref)
            break
        assert found is not None, f"class {r} in no cell type"
        t, ref = found
        tab = elem.tabulate(np.asarray(ref)[None], 0)[0][0]   # (nd,)
        ent = []
        for s_i, w in enumerate(tab):
            if abs(w) < 1e-12:
                continue
            off = offs[t][s_i]
            # trace property: on-plane classes only couple on-plane slots
            assert all(off[ax] == 0 for ax in range(D) if r[ax] == 0), \
                (r, off, w)
            ent.append((off, float(w)))
        classes[r] = ent
    return k, D, classes


class StructuredTransfer:
    """Zero-gather grid transfers for grid-numbered P_k spaces on a
    structured hierarchy (any dimension, any degree).  Per residue class
    r of the fine lattice: prolong writes a weighted sum of stride-k
    slices of the coarse grid into the stride-2k slice of the fine grid
    at r; restrict adds the weighted stride-2k slice of the fine grid into
    stride-k slices of the coarse grid (the exact transpose); inject
    reads every second fine node.  The JAX package spells the same
    slices as lax.slice/lax.pad inside jitted closures."""

    def __init__(self, Vc, Vf):
        from ..assembly.stencil import struct_dims
        self.Vc, self.Vf = Vc, Vf
        sc = Vc.mesh_obj._structured
        sf = Vf.mesh_obj._structured
        self.dims = struct_dims(sc)             # coarse cell counts
        assert struct_dims(sf) == tuple(2 * n for n in self.dims)
        self.bs = Vc.block_size
        self.k, self.D, self.classes = _grid_transfer_classes(
            Vc.mesh_obj, Vc.scalar_element)
        k, dims = self.k, self.dims
        self.cshape = tuple(reversed([k * n + 1 for n in dims]))
        self.fshape = tuple(reversed([2 * k * n + 1 for n in dims]))
        rev = tuple(reversed(range(self.D)))
        # per class: the fine slice it owns, and per weight the coarse
        # slice it reads (prolong) or adds into (restrict)
        self._plan = []
        for r, ents in self.classes.items():
            fine = tuple(slice(r[ax], None, 2 * k) for ax in rev)
            coarse = [(tuple(slice(0, None, k) if r[ax] == 0 else
                             slice(off[ax], off[ax] + k * (dims[ax] - 1) + 1,
                                   k) for ax in rev), w)
                      for off, w in ents]
            self._plan.append((fine, coarse))

    def _planes(self, dat, shape):
        if self.bs == 1:
            return [dat.reshape(shape)]
        return [dat[d::self.bs].reshape(shape) for d in range(self.bs)]

    def _join(self, planes):
        if self.bs == 1:
            return planes[0].reshape(-1)
        return torch.stack([p.reshape(-1) for p in planes],
                           dim=-1).reshape(-1)

    def _pro_plane(self, C):
        F = C.new_zeros(self.fshape)
        for fine, coarse in self._plan:
            acc = None
            for sl, w in coarse:
                v = w * C[sl]
                acc = v if acc is None else acc + v
            F[fine] = acc
        return F

    def _res_plane(self, F):
        C = F.new_zeros(self.cshape)
        for fine, coarse in self._plan:
            Fr = F[fine]
            for sl, w in coarse:
                C[sl] += w * Fr
        return C

    def prolong_fn(self, cdat):
        return self._join([self._pro_plane(C)
                           for C in self._planes(cdat, self.cshape)])

    def restrict_fn(self, fdual):
        return self._join([self._res_plane(F)
                           for F in self._planes(fdual, self.fshape)])

    def inject_fn(self, fdat):
        inj = tuple(slice(None, None, 2) for _ in range(self.D))
        return self._join([F[inj] for F in self._planes(fdat, self.fshape)])


def _structured_ok(Vc, Vf):
    from ..assembly.stencil import struct_dims
    mc, mf = Vc.mesh_obj, Vf.mesh_obj
    sc = getattr(mc, "_structured", None)
    sf = getattr(mf, "_structured", None)
    if sc is None or sf is None or getattr(mf, "_coarse_mesh", None) \
            is not mc:
        return False
    if struct_dims(sf) != tuple(2 * n for n in struct_dims(sc)):
        return False
    ec = Vc.scalar_element
    if getattr(ec, "family", None) != "Lagrange":
        return False
    return (getattr(Vc.sdata, "grid_numbered", False)
            and getattr(Vf.sdata, "grid_numbered", False)
            and ec == Vf.scalar_element)


_transfer_cache = {}


class NonNestedTransfer:
    """Transfers between levels of a NonNestedHierarchy: prolongation is
    cross-mesh node interpolation (fine nodes evaluate the coarse function
    wherever they land), restriction its transpose, injection the reverse
    interpolation (the JAX package's mg/transfer.py NonNestedTransfer;
    reference: firedrake/mg/mesh.py:442).  Vector spaces apply the scalar
    matrices component by component."""

    def __init__(self, Vc, Vf):
        from ..interpolation import cross_mesh_scalar_matrix
        if getattr(Vc.scalar_element, "mapping", "identity") != "identity":
            raise NotImplementedError("non-nested transfer: nodal spaces")
        self.bs = Vc.block_size
        self._P = cross_mesh_scalar_matrix(Vc, Vf)   # fine <- coarse
        self._PT = self._P.transpose()               # coarse <- fine duals
        self._I = cross_mesh_scalar_matrix(Vf, Vc)   # coarse <- fine

    def _apply(self, A, x):
        if self.bs == 1:
            return A.matvec(x)
        xm = x.reshape(-1, self.bs)
        return torch.stack([A.matvec(xm[:, k].contiguous())
                            for k in range(self.bs)], dim=1).reshape(-1)

    def prolong_fn(self, cdat):
        return self._apply(self._P, cdat)

    def restrict_fn(self, fdual):
        return self._apply(self._PT, fdual)

    def inject_fn(self, fdat):
        return self._apply(self._I, fdat)


def get_transfer(Vc, Vf):
    """The transfer between two consecutive levels' spaces, cached by
    (coarse mesh, fine mesh, element, device).  A non-nested level is
    tested first: its meshes may also be structured."""
    from ..device import get_device
    key = (id(Vc.mesh_obj), id(Vf.mesh_obj), hash(Vc.element),
           str(get_device()))
    if key not in _transfer_cache:
        if getattr(Vf.mesh_obj, "_nonnested_coarse", None) \
                is Vc.mesh_obj:
            _transfer_cache[key] = NonNestedTransfer(Vc, Vf)
        elif _structured_ok(Vc, Vf):
            _transfer_cache[key] = StructuredTransfer(Vc, Vf)
        elif (getattr(Vf.mesh_obj, "_c2f_cells", None) is None
                and getattr(Vf.mesh_obj, "parent_cells", None)
                is not None):
            raise NotImplementedError(
                "transfers on adaptively bisected hierarchies are not "
                "ported yet: ROADMAP.md queue 1, item 18 (mg/adaptive.py)")
        else:
            _transfer_cache[key] = LevelTransfer(Vc, Vf)
    return _transfer_cache[key]


# ------------------------------------------------ public firedrake surface
def prolong(coarse, fine):
    """prolong(coarse_function, fine_function) (reference:
    mg/interface.py:37)."""
    t = get_transfer(coarse.function_space(), fine.function_space())
    fine.dat = t.prolong_fn(as_tensor(coarse.dat))
    return fine


def restrict(fine_dual, coarse_dual):
    t = get_transfer(coarse_dual.function_space(),
                     fine_dual.function_space())
    coarse_dual.dat = t.restrict_fn(as_tensor(fine_dual.dat))
    return coarse_dual


def inject(fine, coarse):
    t = get_transfer(coarse.function_space(), fine.function_space())
    coarse.dat = t.inject_fn(as_tensor(fine.dat))
    return coarse


class TransferManager:
    """Reference: firedrake/mg/embedded.py TransferManager.  Spaces whose
    elements are not nodal Lagrange move through an equivalent vector DG
    space: interpolate into it, transfer, project back.  Nodal spaces (CG
    and DG, vector and tensor) go straight through the level transfers."""

    def _is_nodal(self, V):
        fam = V.scalar_element.family
        return fam in ("Lagrange", "Discontinuous Lagrange")

    def _embedding_space(self, V):
        from ..functionspace import VectorFunctionSpace
        deg = V.scalar_element.degree
        d = V.mesh_obj.geometric_dimension
        return VectorFunctionSpace(V.mesh_obj, "DG", deg, dim=d)

    def _via_embedding(self, op, src, dst):
        from ..function import Function
        from ..interpolation import interpolate_onto
        from ..projection import project
        gs = Function(self._embedding_space(src.function_space()))
        interpolate_onto(src, gs)
        gd = Function(self._embedding_space(dst.function_space()))
        op(gs, gd)
        project(gd, dst)
        return dst

    def prolong(self, coarse, fine):
        if self._is_nodal(coarse.function_space()):
            return prolong(coarse, fine)
        return self._via_embedding(prolong, coarse, fine)

    def inject(self, fine, coarse):
        if self._is_nodal(fine.function_space()):
            return inject(fine, coarse)
        return self._via_embedding(inject, fine, coarse)

    def restrict(self, fine_dual, coarse_dual):
        if self._is_nodal(fine_dual.function_space()):
            return restrict(fine_dual, coarse_dual)
        raise NotImplementedError("embedded restriction of duals: use "
                                  "nodal residual spaces")

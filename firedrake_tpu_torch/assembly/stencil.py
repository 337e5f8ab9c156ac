"""Structured-mesh stencil assembly: the zero-gather path of the main
path.

On structured utility meshes (RectangleMesh/BoxMesh & friends) every
cell->dof relation is a fixed grid offset, so assembly needs no index
arrays: coefficient/coordinate gathers are strided slices of the dof
grid, and matrix accumulation is a handful of strided slice-adds into
per-offset stencil channels (reference role: the per-form gather/scatter
wrapper PyOP2 generates).

Dimension-generic: 2D (tri_left/tri_right/quad) and 3D (tet6 = the
Freudenthal/Kuhn 6-tet cube subdivision, hex).  Per-cell-type vertex
offsets are DERIVED from the mesh's own (post-orientation-forcing)
cell_vertices.

The assembled operator is a `StencilMatrix`: data stored as
(nchannels, *grid) per-offset planes (grid axes reversed: (gz, gy, gx));
SpMV is shifted elementwise multiply-adds.

Requirements checked by `build_stencil_plan` (None when unmet; the
general gather route is not ported yet):
  * mesh built by a structured constructor (mesh._structured metadata),
  * all integrals are cell integrals over "everywhere",
  * test/trial/coefficient spaces are Lagrange with grid-affine dof
    numbering, no dof signs/transforms.
"""
from __future__ import annotations

import os

import numpy as np
import torch


# --------------------------------------------------------------- grid maps
_KIND_NTYPES = {"quad": 1, "tri_left": 2, "tri_right": 2,
                "hex": 1, "tet6": 6}


def struct_dims(s):
    """Per-axis cell counts (nx, ny[, nz]) of structured metadata."""
    if "nz" in s:
        return (s["nx"], s["ny"], s["nz"])
    return (s["nx"], s["ny"])


def type_vertex_offsets(mesh):
    """Per cell type, the unit-cube (dx, dy[, dz]) offsets of its
    vertices in the mesh's OWN local order (so orientation-forcing
    vertex swaps at mesh build are reflected), derived from cells
    0..ntypes-1 (the cube/quad at the grid origin; mesh/utility.py
    orders cells c = ntypes*q + t).  None when underivable."""
    cached = mesh.__dict__.get("_grid_tverts", "missing")
    if cached != "missing":
        return cached
    out = _derive_tverts(mesh)
    mesh.__dict__["_grid_tverts"] = out
    return out


def _derive_tverts(mesh):
    s = getattr(mesh, "_structured", None)
    if s is None:
        return None
    dims = struct_dims(s)
    D = len(dims)
    ntypes = _KIND_NTYPES.get(s["kind"])
    if ntypes is None:
        return None
    cv = np.asarray(mesh.topology.cell_vertices[:ntypes], dtype=np.int64)
    offs = []
    for t in range(ntypes):
        o = []
        for v in cv[t]:
            rem = int(v)
            co = []
            for ax in range(D):
                co.append(rem % (dims[ax] + 1))
                rem //= (dims[ax] + 1)
            if rem != 0:
                return None
            o.append(tuple(co))
        offs.append(o)
    arr = np.asarray(offs)
    if arr.min() < 0 or arr.max() > 1:
        return None
    return offs


def grid_slot_offsets(elem, tverts):
    """Per cell type, the fine-grid offset tuple of every local dof of a
    Lagrange element (nodes must sit on the k-lattice), or None."""
    if tverts is None:
        return None
    D = len(tverts[0][0])
    nodes = np.asarray(elem.nodes, dtype=np.float64)
    if nodes.ndim != 2 or nodes.shape[1] != D:
        return None
    k = elem.degree
    offs = []
    for vertsts in tverts:
        pos = _map_ref_points(vertsts, nodes)
        if pos is None:
            return None
        fo = np.rint(k * pos).astype(np.int64)
        if not np.allclose(k * pos, fo, atol=1e-9):
            return None                                  # non-lattice nodes
        offs.append([tuple(map(int, p)) for p in fo])
    return offs


def _map_ref_points(verts, pts):
    """Image of reference points under the cell's vertex map: affine for
    a simplex (D+1 verts), multilinear for a hypercube (2^D verts)."""
    V = np.asarray(verts, dtype=np.float64)
    D = V.shape[1]
    pts = np.asarray(pts, dtype=np.float64)
    if len(V) == D + 1:                                  # affine simplex
        E = (V[1:] - V[:1]).T                            # (D, D)
        return V[0][None] + pts @ E.T
    if len(V) == 2 ** D:                                 # multilinear cube
        out = np.zeros((len(pts), D))
        for c in range(len(V)):
            w = np.ones(len(pts))
            for ax in range(D):
                w = w * (pts[:, ax] if V[c, ax] > 0.5 else 1.0 - pts[:, ax])
            out += w[:, None] * V[c][None]
        return out
    return None


def parity_class_weights(tverts, p):
    """P1 interpolation weights of the fine-grid point at half-integer
    parity class p (in {0,1}^D, quad units p/2) over coarse vertex
    offsets: [(offset_tuple, weight)].  Drives structured refinement
    and grid transfers; any containing cell type gives the same values
    (P1 continuity across shared entities)."""
    D = len(p)
    pt = np.asarray(p, dtype=np.float64) / 2.0
    for verts in tverts:
        V = np.asarray(verts, dtype=np.float64)
        if len(V) == D + 1:
            E = (V[1:] - V[:1]).T
            lam = np.linalg.solve(E, pt - V[0])
            if lam.min() < -1e-12 or lam.sum() > 1 + 1e-12:
                continue
            w = np.concatenate([[1.0 - lam.sum()], lam])
        else:
            w = np.ones(len(V))
            for c in range(len(V)):
                for ax in range(D):
                    w[c] *= pt[ax] if V[c, ax] > 0.5 else 1.0 - pt[ax]
        out = {}
        for c in range(len(V)):
            if abs(w[c]) > 1e-14:
                key = tuple(int(round(x)) for x in V[c])
                out[key] = out.get(key, 0.0) + w[c]
        return sorted(out.items())
    raise AssertionError(f"parity class {p} not inside any cell type")


class _SpaceGrid:
    """Grid-affine dof layout of a function space on a structured mesh:
    node id = sum_ax gi_ax * prod(gdims[:ax]), with per-cell-type
    fine-grid slot offsets."""

    def __init__(self, gdims, k, offs, bs):
        self.gdims = tuple(gdims)          # (gnx, gny[, gnz]) axis order
        self.k, self.offs, self.bs = k, offs, bs

    @property
    def plane_shape(self):                 # device plane: reversed axes
        return tuple(reversed(self.gdims))


def _space_grid(V, s):
    """_SpaceGrid for V on structured metadata s, or None."""
    elem = V.scalar_element
    if getattr(elem, "family", None) != "Lagrange":
        return None
    if getattr(V, "has_dof_signs", False) or \
            getattr(V, "has_dof_transforms", False):
        return None
    k = elem.degree
    if k != 1 and not getattr(V.sdata, "grid_numbered", False):
        return None
    tverts = type_vertex_offsets(V.mesh_obj)
    offs = grid_slot_offsets(elem, tverts)
    if offs is None:
        return None
    dims = struct_dims(s)
    gdims = tuple(k * n + 1 for n in dims)
    sg = _SpaceGrid(gdims, k, offs, V.block_size)
    if not _verify_grid(V, s, sg):
        return None
    return sg


def _cell_grid_index(q, dims):
    """Decompose mesh quad/cube index q (x slowest, last axis fastest —
    mesh/utility.py meshgrid 'ij' ravel order) into per-axis indices."""
    idx = [None] * len(dims)
    rem = q
    for ax in reversed(range(len(dims))):
        idx[ax] = rem % dims[ax]
        rem = rem // dims[ax]
    return idx


def _verify_grid(V, s, sg):
    """Full vectorized check that cell_node_map matches the grid
    prediction (guards against any cell/vertex renumbering).  Cache
    keyed by the map's identity: RestrictedFunctionSpace shares sdata
    with its base space but carries a different (renumbered) map."""
    cnm_id = id(V.cell_node_map)
    cache = getattr(V.sdata, "_grid_ok", None)
    if cache is not None and cache[0] == cnm_id:
        return cache[1]
    dims = struct_dims(s)
    D = len(dims)
    ntypes = len(sg.offs)
    cnm = V.cell_node_map                                # (ncell, nd)
    ok = cnm.shape[0] == ntypes * int(np.prod(dims))
    if ok:
        c = np.arange(cnm.shape[0])
        t = c % ntypes
        qidx = _cell_grid_index(c // ntypes, dims)       # per-axis (ncell,)
        offs = np.asarray(sg.offs)                       # (nt, nd, D)
        strides = np.cumprod((1,) + sg.gdims[:-1])       # (D,)
        pred = np.zeros_like(cnm, dtype=np.int64)
        for ax in range(D):
            o = offs[t][:, :, ax]                        # (ncell, nd)
            pred += (qidx[ax][:, None] * sg.k + o) * strides[ax]
        ok = bool(np.array_equal(cnm.astype(np.int64), pred))
    V.sdata._grid_ok = (cnm_id, ok)
    return ok


# ------------------------------------------------------------------ plan
class StencilPlan:
    """Static slice schedule for one form on a structured mesh."""

    def __init__(self, asm, s, test_g, trial_g, coeff_g):
        self.mesh = asm.mesh
        self.s = s
        self.dims = struct_dims(s)               # (nx, ny[, nz])
        self.D = len(self.dims)
        tverts = type_vertex_offsets(asm.mesh)
        self.ntypes = len(tverts)
        self.test_g = test_g
        self.trial_g = trial_g
        self.coeff_g = coeff_g                   # {count: _SpaceGrid}
        self.rank = asm.rank
        # coordinates are vector P1 on the vertex grid
        self.coord_g = _SpaceGrid(tuple(n + 1 for n in self.dims), 1,
                                  tverts, asm.mesh.geometric_dimension)
        if self.rank == 2:
            self._plan_channels()

    def _plan_channels(self):
        """Channel = fine-grid offset (col - row).  Contributions grouped
        per channel: (t, i, j, row_off_tuple)."""
        chans = {}
        nd_r = len(self.test_g.offs[0])
        nd_c = len(self.trial_g.offs[0])
        for t in range(self.ntypes):
            for i in range(nd_r):
                oR = self.test_g.offs[t][i]
                for j in range(nd_c):
                    oC = self.trial_g.offs[t][j]
                    ch = tuple(oC[ax] - oR[ax] for ax in range(self.D))
                    chans.setdefault(ch, []).append((t, i, j, oR))
        self.channels = sorted(chans)            # list of offset tuples
        self.contribs = [chans[ch] for ch in self.channels]
        self.diag_channel = self.channels.index((0,) * self.D)

    # --------------------------------------------------- device programs
    def _planes(self, dat, sg):
        """Flat dof vector -> list of bs component planes (reversed-axis
        shape)."""
        bs = sg.bs
        shape = sg.plane_shape
        if bs == 1:
            return [dat.reshape(shape)]
        return [dat[d::bs].reshape(shape) for d in range(bs)]

    def _grid_slices(self, off, k):
        """The dof-grid positions of the cell plane at fine offset `off`,
        stride k (reversed-axis order)."""
        return tuple(slice(off[ax], off[ax] + k * (self.dims[ax] - 1) + 1, k)
                     for ax in reversed(range(self.D)))

    def _slot(self, plane, off, k):
        """Dof-grid plane -> flat (C,) cell-slot values via a strided
        slice (the zero-gather replacement for dof-map gathers)."""
        return plane[self._grid_slices(off, k)].reshape(-1)

    def gather_cell_inputs(self, t, coords_dat, coeff_dats, ci):
        """Kernel inputs for cell type t: coords (ndofc, g, C), coeffs
        tuple of (nslot, C) — all built from strided slices."""
        cg = self.coord_g
        planes = self._planes(coords_dat, cg)
        ce = torch.stack([
            torch.stack([self._slot(planes[d], off, cg.k)
                         for d in range(cg.bs)])
            for off in cg.offs[t]])
        ws = []
        for c in ci.coefficients:
            sg = self.coeff_g[c.count]
            p = self._planes(coeff_dats[c.count], sg)
            ws.append(torch.stack([
                self._slot(p[d], off, sg.k)
                for off in sg.offs[t] for d in range(sg.bs)]))
        return ce, tuple(ws)

    def _cell_plane_shape(self):
        return tuple(reversed(self.dims))

    def _add_planes(self, out, contribs, t, loc, sg):
        """out += each contribution of cell type t, slice-added in order."""
        cshape = self._cell_plane_shape()
        for (tt, i, j, oR) in contribs:
            if tt == t:
                out[self._grid_slices(oR, sg.k)] += loc[i, j].reshape(cshape)
        return out

    # One cell type at a time: `out` is None for type 0, then the running
    # sum.  Every output entry receives its contributions in the order of
    # the whole-form loop (types ascending, then local dofs), so the sum
    # is bit-equal, and only one type's element tensors are alive.
    def accumulate_rank2(self, out, t, loc):
        """loc: (ni, nj, C) local tensors of type t -> (nch, *plane)."""
        sg = self.test_g
        if out is None:
            out = loc.new_zeros((len(self.channels),) + sg.plane_shape)
        for ch, contribs in enumerate(self.contribs):
            self._add_planes(out[ch], contribs, t, loc, sg)
        return out

    def accumulate_rank1(self, out, t, loc):
        """loc: (ni, 1, C) -> the flat dof vector."""
        sg = self.test_g
        if out is None:
            out = loc.new_zeros(sg.plane_shape)
        contribs = [(t, i, 0, sg.offs[t][i]) for i in range(loc.shape[0])]
        return self._add_planes(out.reshape(sg.plane_shape), contribs, t,
                                loc, sg).reshape(-1)

    def accumulate_diag(self, out, t, loc):
        """Only the (0,...,0) channel — the operator diagonal as a flat
        dof vector, without materializing the other channels."""
        sg = self.test_g
        if out is None:
            out = loc.new_zeros(sg.plane_shape)
        return self._add_planes(out.reshape(sg.plane_shape),
                                self.contribs[self.diag_channel], t, loc,
                                sg).reshape(-1)


def build_stencil_plan(asm):
    """StencilPlan for a FormAssembler, or None when inapplicable
    (FDTPU_NO_STENCIL=1 turns the route off, as in the JAX package)."""
    if os.environ.get("FDTPU_NO_STENCIL") == "1":
        return None
    mesh = asm.mesh
    s = getattr(mesh, "_structured", None)
    if s is None or asm.rank not in (1, 2):
        return None
    if getattr(mesh, "_extruded", False) or \
            getattr(mesh, "is_vertex_only", False):
        return None
    tverts = type_vertex_offsets(mesh)
    if tverts is None:
        return None
    test_g = _space_grid(asm.test.space, s)
    if test_g is None or asm.test.space.block_size != 1:
        return None
    trial_g = None
    if asm.rank == 2:
        trial_g = _space_grid(asm.trial.space, s)
        # channels are offsets on one dof grid: rows and columns share it
        if trial_g is None or asm.trial.space.block_size != 1 \
                or trial_g.gdims != test_g.gdims:
            return None
    coeff_g = {}
    for ci in asm._compiled:
        if ci.integral_type != "cell":
            return None
        if ci.subdomain_id not in ("everywhere", None):
            return None
        for c in ci.coefficients:
            if c.count not in coeff_g:
                cs = getattr(c, "space", None)
                if cs is None or getattr(cs, "mesh_obj", None) is not mesh:
                    return None
                cg = _space_grid(cs, s)
                if cg is None:
                    return None
                coeff_g[c.count] = cg
    return StencilPlan(asm, s, test_g, trial_g, coeff_g)


# --------------------------------------------------------------- matrix
class StencilMatrix:
    """Assembled operator on a structured dof grid: per-offset channel
    planes (nch, *grid).  Fills the Matrix role (matvec/diagonal/
    with_dirichlet/to_scipy) with shift-based, gather-free kernels
    (reference semantics: firedrake/matrix.py:48 over pyop2 Mat)."""

    def __init__(self, plan: StencilPlan, channels, row_space=None,
                 col_space=None, bcs=()):
        self.plan = plan
        self.channels = channels                  # (nch, *plane) device
        self.offsets = plan.channels              # [offset tuples]
        self.row_space = row_space
        self.col_space = col_space
        self.bcs = tuple(bcs)
        self.gdims = plan.test_g.gdims            # (gnx, gny[, gnz])
        self.D = plan.D

    @property
    def plane_shape(self):
        return tuple(reversed(self.gdims))

    @property
    def shape(self):
        n = int(np.prod(self.gdims))
        return (n, n)

    @property
    def dtype(self):
        return self.channels.dtype

    def _margins(self):
        """Per (reversed) axis, the max |offset| over channels."""
        return tuple(max(abs(o[ax]) for o in self.offsets)
                     for ax in reversed(range(self.D)))

    def _shifted(self, P, m, off, sign=1):
        """View of the margin-padded plane P shifted by `off`."""
        return P[tuple(slice(m[a] + sign * off[ax],
                             m[a] + sign * off[ax] + g)
                       for a, (ax, g) in enumerate(
                           zip(reversed(range(self.D)), self.plane_shape)))]

    def _pad(self, X, m):
        Xp = X.new_zeros(tuple(g + 2 * mm
                               for g, mm in zip(X.shape, m)))
        Xp[tuple(slice(mm, mm + g) for g, mm in zip(X.shape, m))] = X
        return Xp

    # ---------------------------------------------------------------- ops
    def matvec(self, x):
        X = x.reshape(self.plane_shape)
        m = self._margins()
        Xp = self._pad(X, m)
        y = None
        for ch, off in enumerate(self.offsets):
            sl = self._shifted(Xp, m, off)
            if y is None:
                y = self.channels[ch] * sl
            else:
                y.addcmul_(self.channels[ch], sl)
        return y.reshape(-1)

    __matmul__ = matvec

    def transpose_matvec(self, y):
        """(A^T y)[p] = sum_off A[off][p - off] * y[p - off]: each channel
        plane and y shifted back by the channel's offset, still
        gather-free (the JAX package's StencilMatrix.transpose_matvec)."""
        m = self._margins()
        Yp = self._pad(y.reshape(self.plane_shape), m)
        Cp = self._pad(self.channels, (0,) + m)
        out = None
        for ch, off in enumerate(self.offsets):
            a = self._shifted(Cp[ch], m, off, -1)
            v = self._shifted(Yp, m, off, -1)
            if out is None:
                out = a * v
            else:
                out.addcmul_(a, v)
        return out.reshape(-1)

    def diagonal(self):
        return self.channels[self.plan.diag_channel].reshape(-1)

    def copy(self):
        return StencilMatrix(self.plan, self.channels, self.row_space,
                             self.col_space, self.bcs)

    def entries(self, rows, cols):
        """A[rows, cols] for int64 index tensors of one shape, gathered on
        the channels' device: the channel of the grid offset col - row,
        read at the row's grid point; 0 off the stencil."""
        m = self._margins()[::-1]                 # per axis, x first
        span = [2 * mm + 1 for mm in m]
        table = np.full(int(np.prod(span)), -1, dtype=np.int64)
        for ch, off in enumerate(self.offsets):
            key = 0
            for ax in reversed(range(self.D)):
                key = key * span[ax] + off[ax] + m[ax]
            table[key] = ch
        table = torch.as_tensor(table, device=self.channels.device)
        key = torch.zeros_like(rows)
        inside = torch.ones(rows.shape, dtype=torch.bool,
                            device=rows.device)
        stride = int(np.prod(self.gdims))
        for ax in reversed(range(self.D)):        # node = sum gi * stride
            g = self.gdims[ax]
            stride //= g
            d = (cols // stride) % g - (rows // stride) % g
            inside &= d.abs() <= m[ax]
            key = key * span[ax] + d.clamp(-m[ax], m[ax]) + m[ax]
        ch = table[key]
        ok = inside & (ch >= 0)
        vals = self.channels.reshape(len(self.offsets), -1)[
            ch.clamp(min=0), rows]
        return torch.where(ok, vals, torch.zeros((), dtype=vals.dtype,
                                                 device=vals.device))

    # ----------------------------------------------------------------- bcs
    def with_dirichlet(self, bc_rows, symmetric=True):
        n = int(np.prod(self.gdims))
        idx = torch.as_tensor(np.asarray(bc_rows, dtype=np.int64),
                              device=self.channels.device)
        mask = torch.zeros(n, dtype=self.channels.dtype,
                           device=self.channels.device)
        mask[idx] = 1.0
        mask = mask.reshape(self.plane_shape)
        keep_r = 1.0 - mask
        m = self._margins()
        Mp = self._pad(mask, m)
        planes = []
        for ch, off in enumerate(self.offsets):
            a = self.channels[ch] * keep_r
            if symmetric:
                a = a * (1.0 - self._shifted(Mp, m, off))
            if ch == self.plan.diag_channel:
                a = a + mask                      # unit diagonal on bc rows
            planes.append(a)
        return StencilMatrix(self.plan, torch.stack(planes), self.row_space,
                             self.col_space, self.bcs)

    # -------------------------------------------------------------- export
    def _index_pairs(self):
        """Host (rows, cols, ch-indices) triplets of in-band entries.
        chs stacks (channel, *reversed-axis grid indices)."""
        grids = np.meshgrid(*[np.arange(g) for g in self.plane_shape],
                            indexing="ij")        # reversed-axis order
        strides = np.cumprod((1,) + self.gdims[:-1])   # per axis
        rows_l, cols_l, chs_l = [], [], []
        for ch, off in enumerate(self.offsets):
            ok = np.ones(self.plane_shape, dtype=bool)
            row = np.zeros(self.plane_shape, dtype=np.int64)
            col = np.zeros(self.plane_shape, dtype=np.int64)
            for ax_i, ax in enumerate(reversed(range(self.D))):
                gi = grids[ax_i]
                cidx = gi + off[ax]
                ok &= (cidx >= 0) & (cidx < self.gdims[ax])
                row += gi * strides[ax]
                col += np.clip(cidx, 0, self.gdims[ax] - 1) * strides[ax]
            rows_l.append(row[ok])
            cols_l.append(col[ok])
            chs_l.append(np.concatenate(
                [np.full((1, ok.sum()), ch)]
                + [g[ok][None] for g in grids], axis=0))
        return (np.concatenate(rows_l), np.concatenate(cols_l),
                np.concatenate(chs_l, axis=1))

    def to_scipy(self):
        from scipy.sparse import coo_matrix
        rows, cols, chs = self._index_pairs()
        dat = self.channels.detach().cpu().numpy()
        vals = dat[tuple(chs)]
        n = int(np.prod(self.gdims))
        return coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()

    def to_dense(self):
        return self.to_scipy().toarray()

    @property
    def nnz(self):
        """CSR-equivalent nonzero count (pattern entries actually touched
        by assembly), for flop accounting."""
        if getattr(self.plan, "_nnz", None) is None:
            total = 0
            k = self.plan.test_g.k
            dims = self.plan.dims
            for contribs in self.plan.contribs:
                touched = np.zeros(self.plane_shape, dtype=bool)
                for (t, i, j, oR) in contribs:
                    sl = tuple(
                        slice(oR[ax], oR[ax] + k * (dims[ax] - 1) + 1, k)
                        for ax in reversed(range(self.D)))
                    touched[sl] = True
                total += int(touched.sum())
            self.plan._nnz = total
        return self.plan._nnz

    def __repr__(self):
        return (f"StencilMatrix({self.shape}, nch={len(self.offsets)}, "
                f"grid={self.plane_shape})")

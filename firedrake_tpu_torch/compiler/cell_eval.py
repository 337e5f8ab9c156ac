"""K1: cell-kernel evaluation for the main path's form family.

Replaces ``firedrake_tpu/compiler/pallas_eval.py`` (``pallas_cell_eval``
and its dispatcher ``run_cell_kernel``).  The TPU kernel evaluates any
traced cell-last kernel inside one ``pallas_call``; on Hopper the work
per cell is small dense algebra of odd sizes (3, 6, 4 or 10 dofs), which
a thread per cell with unrolled loops fits, so the kernel here
(``csrc/cell_eval.cu``, CUDA C++) computes a fixed form family instead
of replaying a trace, in one of three variants (``FamilySpec.mode``):
forms without coefficients contract reference tensors precomputed here
with each cell's geometry (REF), actions whose only coefficient is the
operand z contract the same tensors with the cell's z values (ACT), and
other forms with coefficients sum over quadrature points (QUAD).  The
family:

* affine simplices (triangles, tetrahedra) with P1 coordinates;
* scalar Lagrange P1/P2 test and trial spaces, and Discontinuous Lagrange
  P1/P2 where its tabulation equals Lagrange's node for node;
* integrands that are sums of ``c * prod(w) * inner(grad u, grad v)``,
  ``c * prod(w) * u * v`` (rank 2), ``c * prod(w) * v`` or the action
  term ``c * prod(w) * inner(grad z, grad v)`` (rank 1), where ``c`` is a
  product of literals and at most two scalar Constants (four in the
  integral), ``prod(w)`` a product of scalar Lagrange Functions on the
  same mesh (at most two in the integral, z included) and ``z`` a
  Function on the test space's element.

This covers the README's Helmholtz problem, Dirichlet Poisson and the
matrix-free operators' actions (assembly/matfree.py): ``action(a, z)``
of ``inner(grad u, grad v) + u * v`` is the action term plus the load
term ``z * v``.
``family_spec`` recognises the family from a ``CompiledIntegral``;
forms outside it go through the torch ``BatchedLowerer`` (counted in
``lowerer_evals``), which exists by form, not as a fallback on failure.

Inputs and output are those of the TPU kernel: coordinates
(ndofc, gdim, C), coefficient slot values (nslot_k, C), the Constants'
values; output (ni, nj, C) in the kernel dtype (float64, or float32
under FDTPU_PREC).  On a CPU tensor ``cell_eval`` runs ``cell_eval_plain``,
the same formula in torch; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..language.core import (Sum, Product, ScalarValue, ConstantBase,
                             Coefficient, Argument, Grad)
from ..language.tensor_algebra import Inner, Dot
from .batched import _detC, _invC
from .lowering import _cell_rule, _tables_at, einsum
from . import nvcc

#: launches of the CUDA kernel (counted where it launches, nowhere else)
kernel_launches = 0
#: the same launches by variant, indexed by FamilySpec.mode (REF, QUAD, ACT)
launches_by_mode = [0, 0, 0]
#: forms outside the family evaluated through the torch BatchedLowerer
lowerer_evals = 0

MASS, GRADGRAD, LOAD, ACTION = 0, 1, 2, 3
MAX_TERMS = 4
MAX_COEFFS = 2
MAX_CONSTS = 4
#: Constants in one term
PER_TERM = 2
# the kernel's three variants and the term-kind bits of ref_kernel and
# act_kernel (csrc/cell_eval.cu)
REF, QUAD, ACT = 0, 1, 2
_REF_MASS, _REF_GRAD = 1, 2
_SPEC_INTS = 47
_HEAD = MAX_TERMS + 12

_SRC = nvcc.source("cell_eval.cu")


# ------------------------------------------------------------- the family
class FamilySpec:
    """One cell integral of the family: its terms and host tables.

    terms: tuple of (kind, literal, const_idx, coeff_idx) where the
    indices point into ci.constants / ci.coefficients; zidx: the index of
    the action terms' operand z (None without action terms), which an
    ACTION term's coeff_idx leaves out.

    mode: REF for forms without coefficients (and equal test and trial
    spaces): the kernel contracts precomputed reference tensors with the
    cell's geometry; ACT for actions whose terms are c * inner(grad z,
    grad v) and c * z * v: the same contraction, applied to the cell's z
    values; QUAD otherwise: the kernel sums over quadrature points."""

    def __init__(self, ci, tdim, terms, zidx=None):
        self.tdim = tdim
        self.terms = tuple(terms)
        self.zidx = zidx
        self.ni, self.nj = ci.local_shape()
        if ci.qrule is not None:
            pts = np.asarray(ci.qrule.points, dtype=float)
            wts = np.asarray(ci.qrule.weights, dtype=float)
        else:
            pts, wts = _cell_rule(ci.mesh.cell.name, ci.degree)
        self.nq = len(wts)
        from ..elements import make_scalar_element
        celem = make_scalar_element(ci.mesh.cell.name, "Lagrange", 1)
        tt = _tables_at(ci.test.space.element, pts, 1)
        tabs = {"wq": np.asarray(wts),
                "cgrad": _tables_at(celem, pts, 1)[1][0],
                "bt": tt[0], "dt": tt[1]}
        if ci.trial is not None:
            ts = _tables_at(ci.trial.space.element, pts, 1)
            tabs["bs"], tabs["ds"] = ts[0], ts[1]
        self.wdof = []
        for k, c in enumerate(ci.coefficients):
            tabs[f"w{k}"] = _tables_at(c.space.element, pts, 0)[0]
            self.wdof.append(c.space.element.ndof)
        self.host_tables = tabs
        if zidx is not None:
            self.mode = ACT if all(
                cidx == ((zidx,) if kind == LOAD else ())
                for kind, _, _, cidx in self.terms) else QUAD
        else:
            self.mode = REF if (not any(cidx for *_, cidx in self.terms)
                                and self.nj in (1, self.ni)) else QUAD
        self.kernel_ints, self.kernel_doubles = self._kernel_spec()
        self._dev_tables = {}
        self._dev_quad = {}
        self._launch_args = {}

    # --- tables on the device, built once per (dtype, device)
    def tables(self, dtype, device):
        key = (dtype, str(device))
        if key not in self._dev_tables:
            self._dev_tables[key] = {
                k: torch.as_tensor(v, dtype=dtype, device=device)
                for k, v in self.host_tables.items()}
        return self._dev_tables[key]

    _QUAD_ORDER = ("wq", "bt", "bs", "dt", "ds", "w0", "w1")

    def quad_tables(self, dtype, device):
        """Flat table tensor of the QUAD variant, in _QUAD_ORDER."""
        key = (dtype, str(device))
        if key not in self._dev_quad:
            flat = np.concatenate([
                np.asarray(self.host_tables[k], dtype=np.float64).ravel()
                for k in self._QUAD_ORDER if k in self.host_tables])
            self._dev_quad[key] = torch.as_tensor(flat, dtype=dtype,
                                                  device=device)
        return self._dev_quad[key]

    def reference_tensors(self):
        """(kinds, values) of the REF and ACT variants: for each entry
        (i, j) of the upper triangle (rank 2 and ACT, whose A_e is the
        test element's on both sides) or each i (rank 1), the reference mass
        value sum_q w_q phi_i phi_j if the form has mass terms, then the
        stiffness values sum_q w_q (dphi_i/dX_t dphi_j/dX_s + [t != s]
        dphi_i/dX_s dphi_j/dX_t) for t <= s if it has grad.grad terms."""
        tb = self.host_tables
        w = np.asarray(tb["wq"])
        if self.mode == REF and self.nj == 1:
            return _REF_MASS, np.einsum("q,qi->i", w, tb["bt"])[:, None]
        kinds = 0
        for kind, *_ in self.terms:
            kinds |= (_REF_GRAD if kind in (GRADGRAD, ACTION)
                      else _REF_MASS)
        # an action's operand lies on the test element: both tables are
        # the test space's
        bs, ds = (tb["bt"], tb["dt"]) if self.mode == ACT else (tb["bs"],
                                                                tb["ds"])
        iu, ju = np.triu_indices(self.ni)
        cols = []
        if kinds & _REF_MASS:
            M = np.einsum("q,qi,qj->ij", w, tb["bt"], bs)
            cols.append(M[iu, ju][:, None])
        if kinds & _REF_GRAD:
            D = np.einsum("q,qit,qjs->ijts", w, tb["dt"], ds)
            for t in range(self.tdim):
                for s in range(t, self.tdim):
                    R = D[:, :, t, s] + (D[:, :, s, t] if s != t else 0.0)
                    cols.append(R[iu, ju][:, None])
        return kinds, np.concatenate(cols, axis=1)

    def _kernel_spec(self):
        """(int32 spec, float64 values) of csrc/cell_eval.cu's Args."""
        ints = np.zeros(_SPEC_INTS, dtype=np.int32)
        ints[0] = self.mode
        ints[2], ints[3], ints[4] = len(self.terms), self.nq, len(self.wdof)
        ints[5:5 + len(self.wdof)] = self.wdof
        lits = np.zeros(MAX_TERMS)
        for t, (kind, lit, kidx, cidx) in enumerate(self.terms):
            row = ints[7 + 7 * t:14 + 7 * t]
            row[0], row[1], row[4] = kind, len(kidx), len(cidx)
            row[2:2 + len(kidx)] = kidx
            row[5:5 + len(cidx)] = cidx
            lits[t] = lit
        n = 0
        for k, name in enumerate(self._QUAD_ORDER):
            ints[35 + k] = n
            n += np.size(self.host_tables.get(name, ()))
        ref = np.zeros(0)
        if self.mode in (REF, ACT):
            ints[1], ref = self.reference_tensors()
        ints[42] = ref.size
        ints[43:46] = self.tdim, self.ni, self.nj
        ints[46] = -1 if self.zidx is None else self.zidx
        cgrad = np.zeros(12)
        cgrad[:np.size(self.host_tables["cgrad"])] = np.ravel(
            self.host_tables["cgrad"])
        return ints, np.concatenate([lits, cgrad, ref.ravel()])

    def launch_args(self, dtype, device):
        """The launch's arguments that depend on the form, the dtype and
        the device only, in fdt_cell_eval's order."""
        key = (dtype, device)
        if key not in self._launch_args:
            tab = (self.quad_tables(dtype, device).data_ptr()
                   if self.mode == QUAD else None)
            ints, dbl = self.kernel_ints, self.kernel_doubles
            self._launch_args[key] = (
                int(dtype == torch.float64), tab, ints.ctypes.data,
                len(ints), dbl.ctypes.data, len(dbl))
        return self._launch_args[key]

    def term_scales(self, consts, dtype, device):
        """(MAX_TERMS,) tensor: literal * product of the term's Constants,
        computed on the device (no host read of Constant values); the
        plain version's, the kernel multiplies them itself."""
        vals = []
        for kind, lit, kidx, _ in self.terms:
            v = torch.full((), lit, dtype=dtype, device=device)
            for k in kidx:
                v = v * consts[k].to(dtype).reshape(())
            vals.append(v)
        vals += [torch.zeros((), dtype=dtype, device=device)] * (
            MAX_TERMS - len(vals))
        return torch.stack(vals)


_LAGRANGE_LIKE = {}


def _lagrange_like(elem):
    """Whether a Discontinuous Lagrange element tabulates as the Lagrange
    element of its cell and degree, node for node (the kernel's tables
    come from the element, its loops from the dof count): checked once
    per element at the points of a degree-4 rule."""
    key = (elem.cell.name, elem.degree, hash(elem))
    if key not in _LAGRANGE_LIKE:
        from ..elements import make_scalar_element
        cg = make_scalar_element(elem.cell.name, "Lagrange", elem.degree)
        pts = _cell_rule(elem.cell.name, 4)[0]
        a, b = elem.tabulate(pts, 1), cg.tabulate(pts, 1)
        _LAGRANGE_LIKE[key] = elem.ndof == cg.ndof and all(
            np.array_equal(a[d], b[d]) for d in (0, 1))
    return _LAGRANGE_LIKE[key]


def _scalar_lagrange(space, mesh):
    elem = getattr(space, "element", None)
    family = getattr(elem, "family", None)
    return (getattr(space, "mesh_obj", None) is mesh
            and family in ("Lagrange", "Discontinuous Lagrange")
            and getattr(elem, "degree", 0) in (1, 2)
            and (family == "Lagrange" or _lagrange_like(elem))
            and tuple(space.value_shape) == ()
            and space.block_size == 1
            and getattr(elem, "mapping", "identity") == "identity"
            and not getattr(space, "has_dof_signs", False)
            and not getattr(space, "has_dof_transforms", False))


def _summands(e):
    """The summands of e, with scalar products distributed over sums: the
    derivative of u*u*v arrives as (du*u + u*du)*v."""
    if type(e) is Sum:
        return _summands(e.operands[0]) + _summands(e.operands[1])
    if type(e) is Product and e.operands[0].shape == () \
            and e.operands[1].shape == ():
        sa, sb = (_summands(o) for o in e.operands)
        if len(sa) > 1 or len(sb) > 1:
            return [Product(a, b) for a in sa for b in sb]
    return [e]


def _factors(e):
    if type(e) is Product and e.operands[0].shape == () \
            and e.operands[1].shape == ():
        return _factors(e.operands[0]) + _factors(e.operands[1])
    return [e]


def _grad_of(e):
    """("arg", number) if e is grad(argument), ("coeff", count) if e is
    grad of a scalar coefficient (one derivative), else None."""
    if type(e) is not Grad:
        return None
    o = e.operands[0]
    if isinstance(o, Argument):
        return "arg", o.number
    if isinstance(o, Coefficient) and o.shape == ():
        return "coeff", o.count
    return None


def _match_term(term, ci, rank):
    """(kind, literal, const_idx, coeff_idx, z) of one summand, or None;
    z is the coefficient index of an action term's grad z."""
    lit = 1.0
    kidx, cidx, args, grads, z = [], [], [], 0, None
    consts = {c.count: i for i, c in enumerate(ci.constants)}
    coeffs = {c.count: i for i, c in enumerate(ci.coefficients)}
    for f in _factors(term):
        if type(f) is ScalarValue and not isinstance(f.value, complex):
            lit *= float(f.value)
        elif isinstance(f, ConstantBase) and f.shape == ():
            kidx.append(consts[f.count])
        elif isinstance(f, Coefficient) and f.shape == ():
            cidx.append(coeffs[f.count])
        elif isinstance(f, Argument) and f.shape == ():
            args.append(f.number)
        elif type(f) in (Inner, Dot):
            g = [_grad_of(o) for o in f.operands]
            if None in g:
                return None
            g.sort()                      # ("arg", n) before ("coeff", k)
            if g == [("arg", 0), ("arg", 1)]:
                grads += 1
            elif g[0] == ("arg", 0) and g[1][0] == "coeff" and z is None:
                z = coeffs[g[1][1]]
            else:
                return None
        else:
            return None
    if len(cidx) > MAX_COEFFS or len(kidx) > PER_TERM:
        return None
    if rank == 2 and grads == 1 and z is None and not args:
        kind = GRADGRAD
    elif rank == 2 and grads == 0 and z is None and sorted(args) == [0, 1]:
        kind = MASS
    elif rank == 1 and grads == 0 and z is None and args == [0]:
        kind = LOAD
    elif rank == 1 and grads == 0 and z is not None and not args:
        kind = ACTION
    else:
        return None
    return kind, lit, tuple(kidx), tuple(cidx), z


def family_spec(ci):
    """FamilySpec if the CompiledIntegral is in K1's family, else None
    (cached on the integral)."""
    if "_family_spec" not in ci.__dict__:
        ci._family_spec = _build_spec(ci)
    return ci._family_spec


def _build_spec(ci):
    mesh = ci.mesh
    tdim = mesh.topological_dimension
    if ci.integral_type != "cell" or mesh.cell.name not in (
            "triangle", "tetrahedron"):
        return None
    if mesh.geometric_dimension != tdim \
            or getattr(mesh, "_coord_family", "Lagrange") != "Lagrange" \
            or getattr(mesh, "_coord_degree", 1) != 1:
        return None
    if ci.test is None or not _scalar_lagrange(ci.test.space, mesh):
        return None
    if ci.trial is not None and not _scalar_lagrange(ci.trial.space, mesh):
        return None
    if len(ci.coefficients) > MAX_COEFFS or not all(
            _scalar_lagrange(c.space, mesh) for c in ci.coefficients):
        return None
    if len(ci.constants) > MAX_CONSTS or any(c.shape != ()
                                             for c in ci.constants):
        return None
    rank = 1 if ci.trial is None else 2
    # terms of one kind over the same Constants and coefficients are one
    # term whose literal is the sum of theirs (du*u*v + u*du*v is
    # 2*u*du*v)
    merged, zs = {}, set()
    for s in _summands(ci.integrand):
        t = _match_term(s, ci, rank)
        if t is None:
            return None
        kind, lit, kidx, cidx, z = t
        key = (kind, tuple(sorted(kidx)), tuple(sorted(cidx)))
        merged[key] = merged.get(key, 0.0) + lit
        if z is not None:
            zs.add(z)
    terms = [(kind, lit, kidx, cidx)
             for (kind, kidx, cidx), lit in merged.items()]
    if len(terms) > MAX_TERMS or len(zs) > 1:
        return None
    zidx = zs.pop() if zs else None
    # the action's operand lies on the test element (the kernel reads its
    # gradient from the test tables)
    if zidx is not None and ci.coefficients[zidx].space.element.degree \
            != ci.test.space.element.degree:
        return None
    return FamilySpec(ci, tdim, terms, zidx)


# ------------------------------------------------------ the plain version
def _compute_dtype(dtype):
    if dtype == torch.float64:
        return torch.float64
    if dtype in (torch.float32, torch.bfloat16):
        return torch.float32     # bf16 storage, f32 compute
    raise TypeError(f"cell_eval takes float64/float32/bfloat16, got {dtype}")


def cell_eval_plain(spec, ce, ws, consts):
    """The family's formula in torch: the kernel's signature and result
    (float64, or float32 for reduced inputs)."""
    dt = _compute_dtype(ce.dtype)
    dev = ce.device
    tb = spec.tables(dt, dev)
    ce = ce.to(dt)
    J = einsum("kgc,kt->gtc", ce, tb["cgrad"])              # (g, t, C)
    adet = torch.abs(_detC(J, 0, 1))                        # (C,)
    scale = tb["wq"][:, None] * adet[None, :]               # (nq, C)
    wv = [einsum("jc,qj->qc", w.to(dt), tb[f"w{k}"])
          for k, w in enumerate(ws)]
    cterm = spec.term_scales(consts, dt, dev)
    out = torch.zeros((spec.ni, spec.nj, ce.shape[-1]), dtype=dt,
                      device=dev)
    Jinv = None
    for t, (kind, _, _, cidx) in enumerate(spec.terms):
        f = cterm[t] * scale
        for k in cidx:
            f = f * wv[k]
        if kind in (GRADGRAD, ACTION) and Jinv is None:
            Jinv = _invC(J, 0, 1)                           # (t, g, C)
        if kind == MASS:
            out += einsum("qc,qi,qj->ijc", f, tb["bt"], tb["bs"])
        elif kind == GRADGRAD:
            gv = einsum("qit,tgc->qigc", tb["dt"], Jinv)
            gu = einsum("qjt,tgc->qjgc", tb["ds"], Jinv)
            out += einsum("qc,qigc,qjgc->ijc", f, gv, gu)
        elif kind == ACTION:
            # K = J^-1 J^-T applied to the reference gradient of z (the
            # test element's tables on the cell's z values), contracted
            # with the test gradients: no (q, i, g, C) intermediate
            z = ws[spec.zidx].to(dt)
            Kz = einsum("tgc,sgc,qsc->qtc", Jinv, Jinv,
                        einsum("qjs,jc->qsc", tb["dt"], z))
            out += einsum("qit,qtc->ic", tb["dt"], f[:, None] * Kz)[:, None]
        else:
            out += einsum("qc,qi->ic", f, tb["bt"])[:, None]
    return out


# --------------------------------------------------------- the CUDA kernel
_lib = None
#: fdt_cell_eval's pointer arguments: coordinates, two coefficients, the
#: QUAD tables, the output, the Constants
_Ptrs = ctypes.c_void_p * (5 + MAX_CONSTS)
#: compiler output of the last build (ptxas register/spill report)
build_log = ""


def build():
    """Compile csrc/cell_eval.cu for sm_90a into a shared library (once per
    source version) and load it.  Returns the build seconds (0 when the
    library was already built)."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    lib = nvcc.load(_SRC)
    secs, build_log = nvcc.build_logs.get(_SRC, (0.0, build_log))
    fn = lib.fdt_cell_eval
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    _lib = lib
    return secs


def _launch(spec, ce, ws, consts):
    """One kernel launch; the only tensor operation is the output's
    allocation (inputs already of the kernel's dtype and contiguous, as
    the assembler passes them, are used as they are)."""
    global kernel_launches
    dt = _compute_dtype(ce.dtype)
    C = ce.shape[-1]
    if ce.shape != (spec.tdim + 1, spec.tdim, C):
        raise ValueError(f"cell_eval: coordinates {tuple(ce.shape)} are not "
                         f"({spec.tdim + 1}, {spec.tdim}, C)")
    if len(ws) != len(spec.wdof) or any(
            w.shape != (n, C) for w, n in zip(ws, spec.wdof)):
        raise ValueError("cell_eval: coefficient inputs do not match the "
                         "form")
    dev = ce.device
    if any(x.device != dev for x in ws) or any(
            k.device != dev or k.numel() != 1 for k in consts):
        raise ValueError("cell_eval: coefficients and scalar Constants "
                         "must be on the coordinates' device")
    if _lib is None:
        build()
    if ce.dtype != dt or not ce.is_contiguous():
        ce = ce.to(dt).contiguous()
    ws = [w if w.dtype == dt and w.is_contiguous() else w.to(dt).contiguous()
          for w in ws]
    consts = [k if k.dtype == dt else k.to(dt) for k in consts]
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(spec, ce, ws, consts)
    out = ce.new_empty((spec.ni, spec.nj, C))
    is_double, tab, ints, nints, dbl, ndbl = spec.launch_args(dt, dev)
    ptrs = _Ptrs(ce.data_ptr(), ws[0].data_ptr() if ws else None,
                 ws[1].data_ptr() if len(ws) > 1 else None, tab,
                 out.data_ptr(), *[k.data_ptr() for k in consts])
    rc = _lib.fdt_cell_eval(is_double, ptrs, C, ints, nints, dbl, ndbl,
                            nvcc.current_stream(dev))
    if rc != 0:
        raise RuntimeError(f"cell_eval kernel launch failed: code {rc}")
    kernel_launches += 1
    launches_by_mode[spec.mode] += 1
    return out


def cell_eval(spec, ce, ws, consts):
    """K1: element tensors (ni, nj, C) of a family form.  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if ce.device.type == "cpu":
        return cell_eval_plain(spec, ce, ws, consts)
    if ce.device.type != "cuda":
        raise RuntimeError(f"cell_eval: no kernel for {ce.device}")
    return _launch(spec, ce, ws, consts)


# -------------------------------------------------------------- dispatcher
def _chunked(kb, ce, ws, consts, chunk):
    """Evaluate kb over cell-axis chunks (bounds the (ni, nj, nq, chunk)
    intermediate of the lowerer); the last chunk's start clamps to
    C - chunk, so overlapping cells are recomputed identically."""
    C = ce.shape[-1]
    if not chunk or chunk >= C:
        return kb(ce, ws, consts)
    buf = None
    for i in range(-(-C // chunk)):
        c0 = min(i * chunk, C - chunk)
        loc = kb(ce[..., c0:c0 + chunk],
                 tuple(w[..., c0:c0 + chunk] for w in ws), consts)
        if buf is None:
            buf = torch.empty(loc.shape[:-1] + (C,), dtype=loc.dtype,
                              device=loc.device)
        buf[..., c0:c0 + chunk] = loc
    return buf


def run_cell_kernel(ci, ce, ws, consts, chunk=None):
    """Element tensors of one cell integral: K1 for family forms, the
    torch BatchedLowerer (chunked along the cell axis) otherwise.  Callers
    wrap this in trace_ctx(prec), as in the JAX package."""
    global lowerer_evals
    spec = family_spec(ci)
    if spec is not None:
        return cell_eval(spec, ce, ws, consts)
    lowerer_evals += 1
    return _chunked(ci.cell_kernel_batched(), ce, ws, consts, chunk)

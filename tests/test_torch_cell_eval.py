"""K1 (compiler/cell_eval.py) against the JAX package.

For each form of tests/unit/test_pallas_eval.py, K1's plain version and
the port's BatchedLowerer are held against the JAX cell_kernel_batched
and, in float32, pallas_cell_eval(..., interpret=True) — the TPU kernel
run as the JAX package's own tests run it on the CPU.

Tolerances: float64 rtol 1e-12 with atol 1e-12 * max|ref| (entries that
cancel to zero differ at roundoff of the largest entry); float32 the
bound of test_pallas_eval.py:43-44 (rtol 2e-6, atol 1e-7) applied in the
max norm, max|ours - ref| <= atol + rtol * max|ref|: the two frameworks
sum in different orders, and an entry that nearly cancels differs by a few
float32 ulps of the largest entry, which an elementwise rtol rejects.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import firedrake_tpu as J
import firedrake_tpu_torch as T
from firedrake_tpu.compiler.pallas_eval import pallas_cell_eval
from firedrake_tpu_torch.assemble import FormAssembler as TFA
from firedrake_tpu_torch.compiler import cell_eval as K
from firedrake_tpu_torch.compiler.precision import trace_ctx


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    T.set_device("cpu")
    yield
    torch.set_num_threads(n)


def _p1_poisson_mass(fd):
    V = fd.FunctionSpace(fd.UnitSquareMesh(5, 4), "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    return fd.inner(fd.grad(u), fd.grad(v)) * fd.dx + u * v * fd.dx


def _p2_coefficient_constant(fd):
    V = fd.FunctionSpace(fd.UnitSquareMesh(4, 4), "CG", 2)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    w = fd.Function(V)
    w.dat = np.linspace(0.5, 1.5, V.dim)
    return fd.Constant(3.0) * w * fd.inner(fd.grad(u), fd.grad(v)) * fd.dx


def _tet(fd):
    V = fd.FunctionSpace(fd.UnitCubeMesh(3, 3, 3), "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    return fd.inner(fd.grad(u), fd.grad(v)) * fd.dx


def _mass(fd):
    V = fd.FunctionSpace(fd.UnitSquareMesh(5, 4), "CG", 1)
    u, v = fd.TrialFunction(V), fd.TestFunction(V)
    return u * v * fd.dx


def _load(fd):
    V = fd.FunctionSpace(fd.UnitSquareMesh(5, 4), "CG", 2)
    v = fd.TestFunction(V)
    f = fd.Function(V)
    f.dat = np.cos(np.arange(V.dim, dtype=float))
    return -2.0 * f * f * v * fd.dx


FORMS = {"p1_poisson_mass": (_p1_poisson_mass, (0, 1)),
         "p2_coefficient_constant": (_p2_coefficient_constant, (0, 1)),
         "tet": (_tet, (3,)),
         "mass": (_mass, (0,)),
         "load_p2": (_load, (0, 1))}


def _cases(name, dtype):
    """Per integral and cell type: the JAX kernel (jitted once per
    integral), its inputs, and the port's integral and inputs.  Both
    packages see the same arrays: the port's strided-slice gathers, which
    test_torch_assemble holds bit-equal to the JAX package's."""
    from firedrake_tpu.compiler.kernels import CompiledIntegral as CJ
    make, types = FORMS[name]
    fj, ft = make(J), make(T)
    ta = TFA(ft)
    tc, tco, tcv = ta._inputs()
    tc = tc.to(dtype)
    tco = {k: v.to(dtype) for k, v in tco.items()}
    tcv = {k: v.to(dtype) for k, v in tcv.items()}
    args = fj.arguments()
    out = []
    for it, ct in zip(fj.integrals(), ta._compiled):
        cj = CJ(it, args[0], args[1] if len(args) > 1 else None,
                fj.mesh())
        kb = cj.cell_kernel_batched()
        kbj = jax.jit(kb)
        for t in types:
            ce, ws = ta._stencil.gather_cell_inputs(t, tc, tco, ct)
            cv = tuple(tcv[c.count] for c in ct.constants)
            jin = (jnp.asarray(ce.numpy()),
                   tuple(jnp.asarray(w.numpy()) for w in ws),
                   tuple(jnp.asarray(c.numpy()) for c in cv))
            out.append((kb, kbj, jin, ct, ce, ws, cv))
    return out


@pytest.mark.parametrize("name", FORMS)
def test_f64_plain_and_lowerer_match_jax(name):
    for kb, kbj, jin, ci, ce, ws, cv in _cases(name, torch.float64):
        ref = np.asarray(kbj(*jin))
        spec = K.family_spec(ci)
        assert spec is not None, name
        plain = K.cell_eval(spec, ce, ws, cv).numpy()
        low = ci.cell_kernel_batched()(ce, ws, cv).numpy()
        atol = 1e-12 * np.abs(ref).max()
        np.testing.assert_allclose(plain, ref, rtol=1e-12, atol=atol)
        np.testing.assert_allclose(low, ref, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("name", FORMS)
def test_f32_plain_and_lowerer_match_pallas(name):
    for kb, kbj, jin, ci, ce, ws, cv in _cases(name, torch.float32):
        with jax.enable_x64(False):
            direct = np.asarray(jax.jit(kb)(*jin))
            fused = np.asarray(pallas_cell_eval(kb, *jin, interpret=True))
        spec = K.family_spec(ci)
        plain = K.cell_eval(spec, ce, ws, cv)
        with trace_ctx(torch.float32):
            low = ci.cell_kernel_batched()(ce, ws, cv)
        assert plain.dtype == low.dtype == torch.float32
        for ours in (plain.numpy(), low.numpy()):
            for ref in (direct, fused):
                err = np.abs(ours - ref).max()
                assert err <= 2e-6 * np.abs(ref).max() + 1e-7, err


def test_family_accepts_main_path_forms():
    mesh = T.UnitSquareMesh(3, 3)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    f = T.Function(V)
    forms = {
        "helmholtz": ((T.inner(T.grad(u), T.grad(v)) + T.inner(u, v))
                      * T.dx, [(K.GRADGRAD, 1.0), (K.MASS, 1.0)]),
        "load": (T.inner(f, v) * T.dx, [(K.LOAD, 1.0)]),
        "scaled": (-2.0 * T.Constant(3.0) * f * f * u * v * T.dx,
                   [(K.MASS, -2.0)]),
        "dot": (T.dot(T.grad(v), T.grad(u)) * T.dx, [(K.GRADGRAD, 1.0)]),
    }
    for name, (form, expect) in forms.items():
        asm = TFA(form)
        (ci,) = asm._compiled
        spec = K.family_spec(ci)
        assert spec is not None, name
        assert [(k, lit) for k, lit, _, _ in spec.terms] == expect, name


@pytest.mark.parametrize("which", ["sin", "coord", "three_coeffs",
                                   "grad_coeff", "vector"])
def test_family_rejects_other_forms(which):
    mesh = T.UnitSquareMesh(3, 3)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    x = T.SpatialCoordinate(mesh)
    f = T.Function(V)
    W = T.VectorFunctionSpace(mesh, "CG", 1)
    uw, vw = T.TrialFunction(W), T.TestFunction(W)
    form = {"sin": lambda: T.sin(x[0]) * u * v * T.dx,
            "coord": lambda: x[0] * u * v * T.dx,
            "three_coeffs": lambda: f * f * f * u * v * T.dx,
            "grad_coeff": lambda: T.inner(T.grad(f), T.grad(v)) * u * T.dx,
            "vector": lambda: T.inner(T.grad(uw), T.grad(vw)) * T.dx,
            }[which]()
    from firedrake_tpu_torch.compiler.kernels import CompiledIntegral
    (it,) = form.integrals()
    args = form.arguments()
    ci = CompiledIntegral(it, args[0], args[1], mesh)
    assert K.family_spec(ci) is None


def test_outside_family_goes_through_lowerer_and_is_counted():
    mesh = T.UnitSquareMesh(3, 3)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    x = T.SpatialCoordinate(mesh)
    before = (K.lowerer_evals, K.kernel_launches)
    A = T.assemble(T.sin(x[0]) * u * v * T.dx)
    assert K.lowerer_evals == before[0] + 2          # one per cell type
    assert K.kernel_launches == before[1]            # CPU: no launch
    Aj = J.assemble(J.sin(J.SpatialCoordinate(
        J.UnitSquareMesh(3, 3))[0]) * J.TrialFunction(
        J.FunctionSpace(J.UnitSquareMesh(3, 3), "CG", 1)) * J.TestFunction(
        J.FunctionSpace(J.UnitSquareMesh(3, 3), "CG", 1)) * J.dx)
    assert A.channels.shape == tuple(np.asarray(Aj.channels).shape)


def test_plain_version_on_cpu_does_not_count_launches():
    mesh = T.UnitSquareMesh(2, 2)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    before = K.kernel_launches
    T.assemble(u * v * T.dx)
    assert K.kernel_launches == before


def test_chunked_lowerer_equals_unchunked():
    mesh = T.UnitSquareMesh(6, 5)
    V = T.FunctionSpace(mesh, "CG", 1)
    u, v = T.TrialFunction(V), T.TestFunction(V)
    x = T.SpatialCoordinate(mesh)
    asm = TFA(T.sin(x[0]) * u * v * T.dx)
    (ci,) = asm._compiled
    coords, coeffs, consts = asm._inputs()
    ce, ws = asm._stencil.gather_cell_inputs(0, coords, coeffs, ci)
    full = K.run_cell_kernel(ci, ce, ws, ())
    chunked = K.run_cell_kernel(ci, ce, ws, (), chunk=7)
    # per-cell arithmetic is the same; einsum may block a shorter cell
    # axis differently, so the sums agree to roundoff
    torch.testing.assert_close(chunked, full, rtol=1e-14, atol=0)


def _emulate_kernel(spec, ce, ws, consts):
    """csrc/cell_eval.cu's arithmetic in numpy, reading only what the
    kernel reads: the int32 spec, the float64 values (literals, reference
    gradients, reference tensors) and the QUAD table by its offsets."""
    ints, dbl = spec.kernel_ints, spec.kernel_doubles
    d, ni, nj = spec.tdim, spec.ni, spec.nj
    ce, ws = ce.numpy(), [w.numpy() for w in ws]
    consts = [float(c) for c in consts]
    cgrad = dbl[4:4 + (d + 1) * d].reshape(d + 1, d)
    Jc = np.einsum("kgc,kt->cgt", ce, cgrad)
    Ji = np.linalg.inv(Jc)                                  # (c, t, g)
    adet = np.abs(np.linalg.det(Jc))
    Kf = np.einsum("ctg,csg->cts", Ji, Ji)
    terms = []
    for t in range(ints[2]):
        kind, nk, k0, k1, nw, w0, w1 = ints[7 + 7 * t:14 + 7 * t]
        s = dbl[t] * np.prod([consts[k] for k in (k0, k1)[:nk]])
        terms.append((kind, s, (w0, w1)[:nw]))
    out = np.zeros((ni, nj, ce.shape[-1]))
    grads = (K.GRADGRAD, K.ACTION)
    act = ints[0] == K.ACT
    if ints[0] in (K.REF, K.ACT):
        rank1 = nj == 1 and not act
        ref = dbl[16:].reshape(ni if rank1 else ni * (ni + 1) // 2, -1)
        cm = sum(s for kind, s, _ in terms if kind not in grads)
        cg = sum(s for kind, s, _ in terms if kind in grads)
        ks = [Kf[:, t, s] for t in range(d) for s in range(t, d)]
        pairs = ([(i, 0) for i in range(ni)] if rank1 else
                 [(i, j) for i in range(ni) for j in range(i, ni)])
        z = ws[ints[46]] if act else None
        for p, (i, j) in enumerate(pairs):
            col, a = 0, 0.0
            if ints[1] & 1:
                a, col = cm * adet * ref[p, 0], 1
            if ints[1] & 2:
                a = a + cg * adet * sum(r * k for r, k in
                                        zip(ref[p, col:], ks))
            if act:                          # y = A_e z_e, A_e symmetric
                out[i, 0] += a * z[j]
                if j != i:
                    out[j, 0] += a * z[i]
                continue
            out[i, j] = a
            if nj > 1:
                out[j, i] = a
        return out
    tab = spec.quad_tables(torch.float64, "cpu").numpy()
    o_wq, o_bt, o_bs, o_dt, o_ds, o_w0, o_w1 = ints[35:42]
    nq, wdof = ints[3], ints[5:7]
    wq = tab[o_wq:o_wq + nq]
    bt = tab[o_bt:o_bt + nq * ni].reshape(nq, ni)
    wv = [np.einsum("qj,jc->qc", tab[o:o + nq * wdof[k]].reshape(nq, -1),
                    ws[k]) for k, o in enumerate((o_w0, o_w1)[:ints[4]])]
    fm, fg = np.zeros((nq, ce.shape[-1])), np.zeros((nq, ce.shape[-1]))
    for kind, s, widx in terms:
        f = s * np.prod([wv[k] for k in widx], axis=0) if widx else s
        if kind in grads:
            fg = fg + f
        else:
            fm = fm + f
    fm, fg = fm * wq[:, None] * adet, fg * wq[:, None] * adet
    dt = tab[o_dt:o_dt + nq * ni * d].reshape(nq, ni, d)
    if nj == 1:
        out = np.einsum("qc,qi->ic", fm, bt)
        if ints[46] >= 0:                    # action terms: grad z at q
            kz = np.einsum("cts,qjs,jc->qtc", Kf, dt, ws[ints[46]])
            out = out + np.einsum("qc,qit,qtc->ic", fg, dt, kz)
        return out[:, None]
    bs = tab[o_bs:o_bs + nq * nj].reshape(nq, nj)
    ds = tab[o_ds:o_ds + nq * nj * d].reshape(nq, nj, d)
    return (np.einsum("qc,qi,qj->ijc", fm, bt, bs)
            + np.einsum("qc,qit,cts,qjs->ijc", fg, dt, Kf, ds))


KERNEL_FORMS = [f"{c}_p{d}_{k}" for c in ("tri", "tet") for d in (1, 2)
                for k in ("gradgrad_mass", "consts", "two_coeffs",
                          "load_two_coeffs", "load_const", "action",
                          "action_coeff")]


def _kernel_forms():
    out = {}
    for cube, deg in ((False, 1), (False, 2), (True, 1), (True, 2)):
        mesh = (T.UnitCubeMesh(2, 2, 2) if cube else T.UnitSquareMesh(3, 4))
        V = T.FunctionSpace(mesh, "CG", deg)
        W = T.FunctionSpace(mesh, "CG", 3 - deg)
        u, v = T.TrialFunction(V), T.TestFunction(V)
        f, g = T.Function(V), T.Function(W)
        rng = np.random.default_rng(deg + 2 * cube)
        f.dat = rng.uniform(0.5, 1.5, V.dim)
        g.dat = rng.uniform(0.5, 1.5, W.dim)
        k1, k2 = T.Constant(1.5), T.Constant(-0.25)
        tag = f"{'tet' if cube else 'tri'}_p{deg}"
        out[f"{tag}_gradgrad_mass"] = (
            (T.inner(T.grad(u), T.grad(v)) + T.inner(u, v)) * T.dx, K.REF)
        out[f"{tag}_consts"] = (
            (k1 * k2 * T.inner(T.grad(u), T.grad(v)) - 2.0 * k1 * u * v)
            * T.dx, K.REF)
        out[f"{tag}_two_coeffs"] = (
            (k1 * f * g * T.inner(T.grad(u), T.grad(v)) + k2 * g * u * v)
            * T.dx, K.QUAD)
        out[f"{tag}_load_two_coeffs"] = (
            (k1 * k2 * f * g * v + 3.0 * f * v) * T.dx, K.QUAD)
        out[f"{tag}_load_const"] = (k2 * v * T.dx, K.REF)
        z = T.Function(V)
        z.dat = rng.standard_normal(V.dim)
        out[f"{tag}_action"] = (T.action(
            (k1 * T.inner(T.grad(u), T.grad(v)) - 2.0 * u * v) * T.dx, z),
            K.ACT)
        out[f"{tag}_action_coeff"] = (T.action(
            (k2 * g * T.inner(T.grad(u), T.grad(v)) + 3.0 * u * v) * T.dx,
            z), K.QUAD)
    return out


@pytest.mark.parametrize("name", KERNEL_FORMS)
def test_kernel_arithmetic_matches_plain(name):
    """The kernel's three variants, emulated from the arrays it is handed,
    equal the plain version within 1e-12 max|ref| (float64): this checks
    the reference tensors, the spec layout and the table offsets on the
    CPU, for P1/P2 on triangles and tets, two Constants and two
    coefficients."""
    form, mode = _kernel_forms()[name]
    asm = TFA(form)
    coords, coeffs, consts = asm._inputs()
    for ci in asm._compiled:
        spec = K.family_spec(ci)
        assert spec is not None and spec.mode == mode, name
        cv = tuple(consts[c.count] for c in ci.constants)
        ce, ws = asm._stencil.gather_cell_inputs(0, coords, coeffs, ci)
        ref = K.cell_eval_plain(spec, ce, ws, cv).numpy()
        ours = _emulate_kernel(spec, ce, ws, cv)
        assert np.abs(ours - ref).max() <= 1e-12 * np.abs(ref).max()

"""firedrake_tpu_torch: the PyTorch/CUDA port of firedrake_tpu.

Same module layout and public names as the JAX package, so a script
switches backend by its import line.  Imports torch, never jax.  Everything
runs on the CUDA card unless the caller asks for the CPU with
``set_device("cpu")`` before building Functions.

Ported so far: the main path of the README problem — structured meshes,
Lagrange spaces, stencil assembly with the hand-written cell kernel
(compiler/cell_eval.py), Dirichlet conditions and CG with Jacobi — the
gather route (unstructured meshes, ds/dS facet integrals, 0-forms, CSR
matrices; assembly/sparsity.py, assembly/matrix.py), norm and errornorm,
and geometric multigrid on structured hierarchies (mg/), with Chebyshev or
Richardson smoothing, Jacobi or vertex-star patch smoothers (patch solves
through the batched-inverse kernel, ops/batched_inverse.py), an LU
coarse solve and matrix-free levels (assembly/matfree.py); the Krylov
layer (CG, GMRES, FGMRES, BiCGStab, MINRES, Richardson, Chebyshev),
Newton with line search (assembled or matrix-free Jacobian), EquationBC,
nullspaces, LinearSolver and L2 projection; DG advection (par_loop,
VertexBasedLimiter, fml) and VTK output; mixed spaces (MixedFunctionSpace,
block assembly into a BlockMatrix, mixed.py) with the H(div)/H(curl)
elements RT, BDM, BDFM, RTCF, RTCE and N1curl (Piola maps, dof signs);
Slate (slate.py: element-local tensors, inverses and solves through the
batched-inverse kernel), the HDiv trace and broken elements, and the
hybridization and static-condensation (SCPC) solver options; extruded
meshes (column-numbered Lagrange spaces assembled by the column plan into
a ColumnMatrix, assembly/columns.py; prism facet integrals by facet
class; HDiv(TensorProductElement(...)) prism elements, elements/
tensor_product.py), sum-factorised Q_k on quads and hexes
(compiler/spectral.py) and quad, hex, extruded and semi-coarsened
hierarchies.
"""
from .language import *            # noqa: F401,F403  (UFL surface)
from .mesh.utility import *        # noqa: F401,F403
from .mesh.topology import MeshTopology
from .functionspace import (FunctionSpace, VectorFunctionSpace,
                            TensorFunctionSpace, RestrictedFunctionSpace)
from .mixed import MixedFunctionSpace
from .function import Function, Cofunction, Constant, MixedFunction
from .elements.finite_element import BrokenElement
from .elements.tensor_product import (FiniteElement, EnrichedElement,
                                      TensorProductElement, HDiv)
from .bcs import DirichletBC, EquationBC, homogenize
from .assemble import assemble, get_assembler, FormAssembler
from .assembly.sparsity import Sparsity
from .assembly.matrix import Matrix, MatView
from .norms import norm, errornorm
from .interpolation import interpolate
from .solving import (solve, LinearVariationalProblem,
                      LinearVariationalSolver, NonlinearVariationalProblem,
                      NonlinearVariationalSolver, LinearSolver)
from .projection import project, Projector
from .slate import (Tensor, AssembledVector, assemble_slate,
                    DiagonalTensor, Reciprocal, Factorization)
from .adapt import refine_marked, adapt
from .nullspace import VectorSpaceBasis, MixedVectorSpaceBasis
from .solvers.snes import AuxiliaryOperatorSNES
from .mg import MeshHierarchy, HierarchyBase, prolong, restrict, inject
from .mg.mesh import (ExtrudedMeshHierarchy, SemiCoarsenedExtrudedHierarchy,
                      NonNestedHierarchy)
from .io import VTKFile, File
from .parloops import par_loop, READ, WRITE, RW, INC, MIN, MAX
from . import fml
from .slope_limiter import VertexBasedLimiter
from .device import set_device, get_device
from math import pi

#: the reference's label for untagged facets (firedrake/mesh.py:87);
#: dS(UNMARKED)/ds(UNMARKED) select facets with no marker
UNMARKED = -1

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
hybridization and static-condensation (SCPC) solver options; fieldsplit
(additive, multiplicative, Schur), composite PCs, the python PCs
(AssembledPC, AuxiliaryOperatorPC, MassInvPC, PCDPC) and the Vanka patch
smoother (solvers/composition.py, solvers/pcs.py); extruded
meshes (column-numbered Lagrange spaces assembled by the column plan into
a ColumnMatrix, assembly/columns.py; prism facet integrals by facet
class; HDiv(TensorProductElement(...)) prism elements, elements/
tensor_product.py), sum-factorised Q_k on quads and hexes
(compiler/spectral.py) and quad, hex, extruded and semi-coarsened
hierarchies; p-multigrid, FAS and the line, star, FDM and facet-split
PCs; BDDC (solvers/bddc.py), deflated Newton (deflation.py) and the
eigensolvers (eigensolver.py: host ARPACK or a device LOBPCG); the
``Mesh()`` factory and the gmsh, Exodus II, CGNS and netgen readers
(mesh/io_*.py, netgen_mesh.py), point evaluation (pointeval.py,
``Function.at``), VertexOnlyMesh (vertexonly.py) and HDF5 checkpoints
(io/checkpoint.py); interpolation matrices (``Interpolator``,
interpolation.py), HiptmairPC and GTMGPC, non-nested hierarchies and
TransferManager (mg/), and supermesh projection (supermesh.py).
"""
from .language import *            # noqa: F401,F403  (UFL surface)
from .mesh.utility import *        # noqa: F401,F403
from .mesh.topology import MeshTopology
from .mesh.geometry import Mesh as _MeshClass
from .vertexonly import VertexOnlyMesh
from .pointeval import PointNotInDomainError
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
from .interpolation import interpolate, Interpolator
from .solving import (solve, LinearVariationalProblem,
                      LinearVariationalSolver, NonlinearVariationalProblem,
                      NonlinearVariationalSolver, LinearSolver)
from .projection import project, Projector
from .slate import (Tensor, AssembledVector, assemble_slate,
                    DiagonalTensor, Reciprocal, Factorization)
from .adapt import refine_marked, adapt
from .nullspace import VectorSpaceBasis, MixedVectorSpaceBasis
from .solvers.snes import AuxiliaryOperatorSNES
from .solvers.pcs import (PCBase, AssembledPC, AuxiliaryOperatorPC,
                          MassInvPC, PCDPC)
from .mg import MeshHierarchy, HierarchyBase, prolong, restrict, inject
from .mg.transfer import TransferManager
from .supermesh import assemble_mixed_mass_matrix
from .mg.mesh import (ExtrudedMeshHierarchy, SemiCoarsenedExtrudedHierarchy,
                      NonNestedHierarchy)
from .io import (VTKFile, File, CheckpointFile, DumbCheckpoint,
                 FILE_CREATE, FILE_READ, FILE_UPDATE)
from .parloops import par_loop, READ, WRITE, RW, INC, MIN, MAX
from . import fml
from .slope_limiter import VertexBasedLimiter
from .deflation import Deflation, DeflatedSNES
from .eigensolver import LinearEigenproblem, LinearEigensolver
from .device import set_device, get_device
from math import pi

#: the reference's label for untagged facets (firedrake/mesh.py:87);
#: dS(UNMARKED)/ds(UNMARKED) select facets with no marker
UNMARKED = -1


def Mesh(arg, name=None, **kwargs):
    """Mesh factory (reference: firedrake/mesh.py:3275): pass a mesh
    object, a vector coordinate Function (curved / higher-order
    geometry), a mesh file path — gmsh .msh (ASCII v2.2/v4.1), Exodus II
    .e/.exo, or CGNS .cgns (reference reads all three via DMPlex,
    firedrake/mesh.py:376-461) — or a netgen mesh."""
    if isinstance(arg, _MeshClass):
        return arg
    if isinstance(arg, Function):
        from .mesh.geometry import make_mesh_from_coordinates
        return make_mesh_from_coordinates(arg, name=name)
    if isinstance(arg, str):
        if arg.endswith(".msh"):
            from .mesh.io_msh import read_msh
            return read_msh(arg, name=name)
        if arg.endswith((".e", ".exo", ".exo2", ".gen")):
            from .mesh.io_exodus import read_exodus
            return read_exodus(arg, name=name)
        if arg.endswith(".cgns"):
            from .mesh.io_cgns import read_cgns
            return read_cgns(arg, name=name)
        raise NotImplementedError(
            f"mesh format of {arg!r} (.msh/.exo/.cgns supported)")
    if hasattr(arg, "Coordinates") and (hasattr(arg, "Elements2D")
                                        or hasattr(arg, "Elements3D")):
        # netgen/NGSolve mesh (reference: firedrake/netgen.py)
        from .netgen_mesh import mesh_from_netgen
        return mesh_from_netgen(arg, name=name or "netgenmesh")
    raise TypeError(type(arg))

from .kernel import (WRAPPERS, apply_cuda, apply_face_cuda, cheb_cuda, cheb_face_cuda,
                     jacobi_cuda, jacobi_face_cuda, residual_cuda, residual_face_cuda)
from .ops import apply_op, cheb_sweep, jacobi_sweep, residual_op
from .ref import (apply_op_ref, cheb_sweep_ref, face_diag, face_stencil, full_diag,
                  jacobi_sweep_ref, poisson_diag, poisson_stencil, residual_op_ref)

__all__ = [
    "WRAPPERS", "apply_cuda", "apply_face_cuda", "apply_op", "apply_op_ref", "cheb_cuda",
    "cheb_face_cuda", "cheb_sweep", "cheb_sweep_ref", "face_diag", "face_stencil", "full_diag",
    "jacobi_cuda", "jacobi_face_cuda", "jacobi_sweep", "jacobi_sweep_ref", "poisson_diag",
    "poisson_stencil", "residual_cuda", "residual_face_cuda", "residual_op", "residual_op_ref",
]

"""Bitmask flags for results.

The port's own copy of ``ngmix_tpu/flags.py``. Results carry int32
flag tensors on the device and are rendered to strings on the host.
"""
import numpy as np

NO_ATTEMPT = 2**0
CEN_SHIFT = 2**1
NONPOS_FLUX = 2**2
NONPOS_SIZE = 2**3
LOW_DET = 2**4
MAXITER = 2**5
NONPOS_VAR = 2**6
GMIX_RANGE_ERROR = 2**7
NONPOS_SHAPE_VAR = 2**8

# LM fitting diagnostics
LM_SINGULAR_MATRIX = 2**9
LM_NEG_COV_EIG = 2**10
LM_NEG_COV_DIAG = 2**11
LM_FUNC_NOTFINITE = 2**12
EIG_NOTFINITE = 2**13

DIV_ZERO = 2**14
ZERO_DOF = 2**15

# a batched iterative solver returned a lane that is neither converged
# nor at maxfev
SOLVER_INCOMPLETE = 2**16

# aliases kept for API compatibility
EM_RANGE_ERROR = GMIX_RANGE_ERROR
EM_MAXITER = MAXITER
BAD_VAR = NONPOS_VAR

NAME_MAP = {
    NO_ATTEMPT: "no attempt",
    CEN_SHIFT: "center shifted too far",
    NONPOS_FLUX: "flux <= 0",
    NONPOS_SIZE: "T <= 0",
    LOW_DET: "determinant near zero",
    MAXITER: "max iterations reached",
    NONPOS_VAR: "non-positive (definite) variance",
    NONPOS_SHAPE_VAR: "non-positive shape variance",
    GMIX_RANGE_ERROR: "GMixRangeError raised",
    LM_SINGULAR_MATRIX: "singular matrix in LM",
    LM_NEG_COV_EIG: "negative covariance eigenvalue in LM",
    LM_NEG_COV_DIAG: "negative covariance diagional value in LM",
    LM_FUNC_NOTFINITE: "function not finite in LM",
    EIG_NOTFINITE: "eigenvalues of covariance cannot be found in LM",
    DIV_ZERO: "divide by zero",
    ZERO_DOF: "degrees of freedom for it is zero (no chi^2/dof possible)",
    SOLVER_INCOMPLETE: "solver loop exited with unconverged lanes "
                       "(compiled-loop early exit; wrong-code tripwire)",
}


def get_flags_str(val, name_map=None):
    """Render a flag value as a '|'-separated description string."""
    if name_map is None:
        name_map = NAME_MAP

    val = int(val)
    if val < 0:
        raise ValueError(f"Flag value {val} must be non-negative.")
    val &= 0xFFFFFFFF

    nstrs = []
    for pow_ in range(32):
        fval = 1 << pow_
        if val & fval:
            nstrs.append(name_map.get(fval, "bit 2**%d" % pow_))
    return "|".join(nstrs)



def get_flags_str_array(vals, name_map=None):
    """get_flags_str of every value of an array, in its shape"""
    return np.array([get_flags_str(int(v), name_map) for v in np.ravel(vals)]).reshape(
        np.shape(vals))

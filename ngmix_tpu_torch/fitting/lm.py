"""Batched Levenberg-Marquardt driven by normal-equation reductions.

The port of the batched LM of ``ngmix_tpu/fitting/lm.py``: ``LMConf``,
the bounds maps, the iteration helpers, ``run_lm_normal_batched`` and
its epilogue. Same algorithm, stopping rules and flag semantics as the
reference (lmdif-style ftol / xtol / maxfev, an active set for
saturated bounded dims, a chi^2/dof-scaled covariance through the
unrolled Cholesky of ``ops.small_linalg``).

Where the reference runs each straggler-compaction level as a
``lax.while_loop``, this port runs a host loop. Each iteration reads
one number from the device, the count of active lanes, which decides
both "any lane active" and "more lanes active than the next level
holds". The per-lane algebra is elementwise (sums over the parameter
axis are unrolled in a fixed order), and the normal equations come from
a kernel whose per-lane result does not depend on the batch, so a lane
computes the same bits whichever lanes share its level: compaction
changes the schedule, never the results.

``run_lm`` is the reference's residual form for one object, the
solver of the host ``Fitter`` where K3 cannot run the fit: the same
iteration over a residual vector and its ``torch.func.jacfwd``
Jacobian (``run_lm_batch`` runs it lane by lane).

``run_gn_refine_batched`` is the reference's fixed-iteration damped
Gauss-Newton refiner from a near-optimal start (the sheared metacal
types from the noshear optimum, and the full-width evaluation that ends
a variable-projection solve).
"""
from typing import NamedTuple

import numpy as np
import torch

from ..defaults import CDEF, PDEF
from ..flags import (
    EIG_NOTFINITE,
    LM_FUNC_NOTFINITE,
    LM_NEG_COV_DIAG,
    LM_NEG_COV_EIG,
    LM_SINGULAR_MATRIX,
    MAXITER,
    SOLVER_INCOMPLETE,
    ZERO_DOF,
)
from ..ops.small_linalg import chol_inverse, chol_is_spd, chol_solve


class LMConf(NamedTuple):
    """static LM configuration"""

    maxfev: int = 4000
    ftol: float = 1.0e-5
    xtol: float = 1.0e-5
    lambda0: float = 1.0e-3
    lambda_up: float = 10.0
    lambda_down: float = 10.0
    lambda_min: float = 1.0e-12
    lambda_max: float = 1.0e12
    # the reference's analytic flux column of its AD normal equations;
    # the port's normal equations are in closed form already, so the
    # option leaves the solve unchanged
    flux_col: bool = False
    # variable projection of the flux (batch._exp_lm_measure): the flux
    # is solved exactly at every evaluation and the LM iterates the shape
    # columns only; needs an unbounded flux and no prior. The
    # multi-band fit ignores it, as the reference's does
    varpro: bool = False


# ----------------------------------------------------------------------
# bounds maps: the reference's sqrt forms for one-sided bounds and a
# logistic map for two-sided boxes, x = lo + (hi - lo) sigmoid(y)

# two-sided internal coordinates live in [-_Y_CLIP, _Y_CLIP] = ln(1e12)
_Y_CLIP = 27.631021


def clip_internal(y, lo, hi):
    """clip two-sided dims of an internal vector to the e2i range;
    identity for one-sided and unbounded dims"""
    both = torch.isfinite(lo) & torch.isfinite(hi)
    return torch.where(both, torch.clamp(y, -_Y_CLIP, _Y_CLIP), y)


def i2e(y, lo, hi):
    """internal (unconstrained) -> external (constrained)"""
    has_lo = torch.isfinite(lo)
    has_hi = torch.isfinite(hi)
    s = torch.sqrt(y * y + 1.0)
    lo_s = torch.where(has_lo, lo, 0.0)
    hi_s = torch.where(has_hi, hi, 0.0)
    both = lo_s + (hi_s - lo_s) * torch.sigmoid(y)
    lower = lo_s - 1.0 + s
    upper = hi_s + 1.0 - s
    return torch.where(
        has_lo & has_hi,
        both,
        torch.where(has_lo, lower, torch.where(has_hi, upper, y)),
    )


def e2i(x, lo, hi):
    """external (constrained) -> internal (unconstrained)"""
    has_lo = torch.isfinite(lo)
    has_hi = torch.isfinite(hi)
    lo_s = torch.where(has_lo, lo, 0.0)
    hi_s = torch.where(has_hi, hi, 1.0)
    span = torch.where(has_lo & has_hi, hi_s - lo_s, 1.0)
    # each side's distance is clipped so on-bound inputs map to a finite
    # internal coordinate (|y| <= ln(1e12))
    t = torch.maximum(x - lo_s, 1.0e-12 * span)
    u = torch.maximum(hi_s - x, 1.0e-12 * span)
    both = torch.log(t) - torch.log(u)
    lower = torch.sqrt(torch.clamp((x - lo_s + 1.0) ** 2 - 1.0, min=0.0))
    upper = torch.sqrt(torch.clamp((hi_s - x + 1.0) ** 2 - 1.0, min=0.0))
    return torch.where(
        has_lo & has_hi,
        both,
        torch.where(has_lo, lower, torch.where(has_hi, upper, x)),
    )


def i2e_grad(y, lo, hi):
    """d external / d internal"""
    has_lo = torch.isfinite(lo)
    has_hi = torch.isfinite(hi)
    s = torch.sqrt(y * y + 1.0)
    lo_s = torch.where(has_lo, lo, 0.0)
    hi_s = torch.where(has_hi, hi, 0.0)
    # sigmoid(y) sigmoid(-y), so neither factor rounds to an exact 0 or
    # 1 until |y| ~ 100
    both = (hi_s - lo_s) * torch.sigmoid(y) * torch.sigmoid(-y)
    return torch.where(
        has_lo & has_hi,
        both,
        torch.where(
            has_lo, y / s, torch.where(has_hi, -y / s, torch.ones_like(y))
        ),
    )


# ----------------------------------------------------------------------
# iteration helpers, batched over leading dims

def _lane_sum(x):
    """sum over the last axis, unrolled left to right, so a lane's
    result does not depend on the batch it sits in"""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


def _row_sum(x):
    """sum over the prior rows, axis 1 of [B, R, ...], unrolled in a
    fixed order as _lane_sum"""
    s = x[:, 0]
    for i in range(1, x.shape[1]):
        s = s + x[:, i]
    return s


def _solve_damped(JtJ, Jtr, lam):
    """solve (JtJ + lam diag(JtJ)) dx = -Jtr (Marquardt scaling) for
    JtJ [..., n, n], Jtr [..., n] and lam a scalar or [...]; nan where
    the damped matrix is not positive definite"""
    npars = JtJ.shape[-1]
    diag = torch.diagonal(JtJ, dim1=-2, dim2=-1)
    diag = torch.where(diag > 0, diag, 1.0)
    lam = torch.as_tensor(lam, dtype=JtJ.dtype, device=JtJ.device)
    eye = torch.eye(npars, dtype=JtJ.dtype, device=JtJ.device)
    A = JtJ + (lam[..., None] * diag)[..., None] * eye
    return chol_solve(A, -Jtr)


def _pinned_dims(y, Jtr, cost, ftol, lo, hi):
    """active-set mask [..., n]: dims effectively on a finite bound
    whose cost gradient points further outward, and whose whole
    remaining improvement (by the linear model) is below the ftol
    resolution. Freezing them makes the free dims target the
    conditional optimum; the reference's docstring has the derivation.
    Never true for an unbounded dim."""
    g = i2e_grad(y, lo, hi)
    x = i2e(y, lo, hi)
    both = torch.isfinite(lo) & torch.isfinite(hi)
    near = torch.where(
        both,
        torch.abs(y) >= 9.2103404,  # ln(1e4): within 1e-4 of the span
        torch.abs(y) <= 1.4142e-2,  # sqrt(2e-4): within 1e-4 ext units
    )
    toward_lo = (Jtr * g > 0) & torch.isfinite(lo)
    toward_hi = (Jtr * g < 0) & torch.isfinite(hi)
    d_out = torch.where(
        toward_lo, x - lo, torch.where(toward_hi, hi - x, torch.inf)
    )
    g_safe = torch.clamp(torch.abs(g), min=torch.finfo(g.dtype).tiny)
    available = 2.0 * torch.abs(Jtr) * d_out / g_safe
    return (
        near
        & (toward_lo | toward_hi)
        & (available < (ftol * cost)[..., None])
    )


def _mask_normal(JtJ, Jtr, pinned):
    """zero the pinned rows and columns of the normal equations, with a
    unit diagonal so the Cholesky stays SPD; the solve then returns
    dy = 0 for pinned dims and the conditional step for the free ones"""
    free = (~pinned).to(JtJ.dtype)
    JtJ_m = JtJ * free[..., :, None] * free[..., None, :]
    eye = torch.eye(Jtr.shape[-1], dtype=JtJ.dtype, device=JtJ.device)
    JtJ_m = JtJ_m + torch.where(pinned[..., None], eye, 0.0)
    return JtJ_m, Jtr * free


# ----------------------------------------------------------------------
# the residual form: one object's LM over a residual function

def get_def_stuff(npars):
    """the pars, covariance and errors of a failed fit (numpy)"""
    pars = np.zeros(npars) + PDEF
    cov = np.zeros((npars, npars)) + CDEF
    err = np.zeros(npars) + CDEF
    return pars, cov, err


def run_lm(resid_fn, data, guess, lo, hi, conf: LMConf, n_prior_pars=0,
           k_space=False, n_eff=None):
    """minimize sum(resid_fn(x, data)^2) over x [npars] with box bounds:
    the reference's residual-form LM (ngmix_tpu/fitting/lm.py: run_lm).

    resid_fn(pars, data) -> residuals [nres] is a tensor function that
    torch.func.jacfwd can differentiate (no in-place writes to its
    inputs, no reads to the host, no branches on tensor values); the
    Jacobian in internal coordinates is its jacfwd through i2e. The
    loop runs on the host with one read from the device an iteration
    (the stopping test); each iteration is the reference's while_loop
    body: the pinned dims, the masked and damped Cholesky step, the
    clipped trial point and its evaluation, the accept test, the
    ftol / xtol / stuck rules and the damping update. On a CUDA device
    the iteration is captured once into a CUDA graph and replayed.

    guess [npars]; lo, hi [npars] (+-inf for open sides); n_prior_pars:
    the residual's leading prior rows, kept out of the chi^2/dof scale;
    n_eff: the rows that count for the dof (prior rows included), the
    residual's length by default; k_space: the residual holds the real
    and the imaginary parts of complex residuals, so the dof is half the
    non-prior rows less npars. Returns a dict of tensors: pars,
    pars_err, pars_cov, pars_cov0, flags, nfev, ier, cost and s_sq, with
    the reference's flag semantics and order.
    """
    guess = torch.as_tensor(guess)
    npars = guess.shape[-1]
    dtype, dev = guess.dtype, guess.device
    lo = torch.broadcast_to(torch.as_tensor(lo, dtype=dtype, device=dev), guess.shape)
    hi = torch.broadcast_to(torch.as_tensor(hi, dtype=dtype, device=dev), guess.shape)

    def resid_twice(y):
        r = resid_fn(i2e(y, lo, hi), data)
        return r, r

    jac = torch.func.jacfwd(resid_twice, has_aux=True)

    def resid_and_jac(y):
        J, r = jac(y)
        return r, J

    def cost_of(r):
        return torch.sum(r * r)

    def solve_damped(JtJ, Jtr, lam):
        """_solve_damped for one object in a few launches (the unrolled
        Cholesky is ~600 tiny operations at 10 parameters): nan where
        the damped matrix is not positive definite"""
        diag = torch.diagonal(JtJ)
        A = JtJ + torch.diag(lam * torch.where(diag > 0, diag, 1.0))
        L, info = torch.linalg.cholesky_ex(A)
        dy = torch.cholesky_solve(-Jtr[:, None], L)[:, 0]
        return torch.where(info == 0, dy, torch.nan)

    def step(s):
        """one iteration from the state s: the new state and stop, the
        iteration's convergence verdict"""
        y, r, J, cost, lam, pinned = (s[k] for k in ("y", "r", "J", "cost", "lam", "pinned"))
        JtJ = J.T @ J
        Jtr = J.T @ r
        new_pinned = _pinned_dims(y, Jtr, cost, conf.ftol, lo, hi)
        # a pin transition resets the damping and voids convergence
        pin_changed = torch.any(new_pinned != pinned)
        pinned = new_pinned
        lam_eff = torch.where(pin_changed, conf.lambda0, lam)
        JtJ_m, Jtr_m = _mask_normal(JtJ, Jtr, pinned)
        dy = solve_damped(JtJ_m, Jtr_m, lam_eff)
        step_ok = torch.all(torch.isfinite(dy))
        dy = torch.where(step_ok, dy, 0.0)

        y_try = clip_internal(y + dy, lo, hi)
        dy = y_try - y
        r_try, J_try = resid_and_jac(y_try)
        cost_try = cost_of(r_try)
        cost_try = torch.where(torch.isfinite(cost_try), cost_try, torch.inf)
        accept = step_ok & (cost_try < cost)

        # predicted reduction of the quadratic model
        pred = -torch.dot(dy, 2.0 * Jtr) - torch.dot(dy, JtJ @ dy)
        pred = torch.clamp(pred, min=1.0e-300)
        actual = cost - cost_try
        small_cost = accept & ((actual <= conf.ftol * cost) & (pred <= conf.ftol * cost))
        # xtol over the free dims only
        ynorm = torch.sqrt(torch.sum((y * (~pinned).to(dtype)) ** 2))
        small_step = accept & (torch.sqrt(torch.sum(dy * dy)) <= conf.xtol * (ynorm + conf.xtol))
        stuck = (~accept) & (lam_eff >= conf.lambda_max)
        return {
            "y": torch.where(accept, y_try, y),
            "r": torch.where(accept, r_try, r),
            "J": torch.where(accept, J_try, J),
            "cost": torch.where(accept, cost_try, cost),
            "lam": torch.where(accept,
                               torch.clamp(lam_eff / conf.lambda_down, min=conf.lambda_min),
                               torch.clamp(lam_eff * conf.lambda_up, max=conf.lambda_max * 10.0)),
            "pinned": pinned,
            "small_cost": small_cost,
            "small_step": small_step,
            "stop": (small_cost | small_step | stuck) & ~pin_changed,
        }

    y = e2i(guess, lo, hi)
    r, J = resid_and_jac(y)
    false = torch.tensor(False, device=dev)
    s = {"y": y, "r": r, "J": J, "cost": cost_of(r),
         "lam": torch.tensor(conf.lambda0, dtype=dtype, device=dev),
         "pinned": torch.zeros(npars, dtype=torch.bool, device=dev),
         "small_cost": false, "small_step": false, "stop": false}
    # on the card the step replays a captured CUDA graph: the Jacobian's
    # transforms are thousands of small launches an iteration
    advance = _stepper(step, s, graph=dev.type == "cuda")
    nfev, done = 1, False
    while not done and nfev < conf.maxfev:
        s = advance()
        nfev += 1
        # the iteration's one read from the device
        done = bool(s["stop"])
    y, r, J, cost = s["y"], s["r"], s["J"], s["cost"]
    small_cost, small_step = s["small_cost"], s["small_step"]
    return _residual_epilogue(y, r, J, lo, hi, conf, nfev, done, small_cost, small_step,
                              n_prior_pars, n_eff, cost, k_space)


def _stepper(step, s, graph):
    """a function that advances the state s (a dict of tensors) by one
    step(s) and returns the new state. With graph (CUDA tensors, a step
    that launches no kernel of ours and reads nothing to the host) the
    step is captured once into a CUDA graph and each call replays it and
    copies its result into the step's inputs: one launch for the
    thousands of small ones of an eager step, and the same kernels in
    the same order, so the same state. One step runs first on a side
    stream, outside the capture, so that the capture meets a warm
    allocator and the model tables already on the device"""
    if not graph:
        cur = [s]

        def advance():
            cur[0] = step(cur[0])
            return cur[0]
        return advance
    static = {k: v.clone() for k, v in s.items()}
    side = torch.cuda.Stream(device=static["y"].device)
    side.wait_stream(torch.cuda.current_stream(side.device))
    with torch.cuda.stream(side):
        step(static)
    torch.cuda.current_stream(side.device).wait_stream(side)
    cuda_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(cuda_graph):
        out = step(static)

    def replay():
        cuda_graph.replay()
        for k, v in out.items():
            static[k].copy_(v)
        return static
    return replay


def _residual_epilogue(y, r, J, lo, hi, conf, nfev, done, small_cost, small_step,
                       n_prior_pars, n_eff, cost, k_space=False):
    """run_lm's result from its final state: the external covariance by
    undoing the bounds chain rule on J (J_ext = J / g), scaled by the
    chi^2/dof of the non-prior rows (half of them, less npars, for
    k_space), and the reference's flags"""
    npars = y.shape[-1]
    dtype, dev = y.dtype, y.device
    pars = i2e(y, lo, hi)
    grad = i2e_grad(y, lo, hi)
    g_safe = torch.where(grad == 0.0, torch.finfo(dtype).tiny, grad)
    J_ext = J / g_safe[None, :]
    pcov0 = chol_inverse(J_ext.T @ J_ext)
    singular = ~torch.all(torch.isfinite(pcov0))

    nres = r.shape[-1] if n_eff is None else int(n_eff)
    if k_space:
        dof = (nres - n_prior_pars) // 2 - npars
    else:
        dof = nres - n_prior_pars - npars
    zero_dof = dof == 0
    s_sq = torch.sum(r[n_prior_pars:] ** 2) / max(dof, 1)
    pcov = pcov0 * s_sq

    eye = torch.eye(npars, dtype=dtype, device=dev)
    matsel = torch.where(singular, eye, pcov)
    mat_finite = torch.all(torch.isfinite(matsel))
    neg_eig = mat_finite & ~chol_is_spd(matsel)
    neg_diag = torch.any(torch.diagonal(pcov) < 0)
    eig_notfinite = ~mat_finite
    func_notfinite = ~torch.all(torch.isfinite(r))
    maxed = nfev >= conf.maxfev

    flags = 0
    if bool(func_notfinite):
        flags |= LM_FUNC_NOTFINITE
    if bool(singular & ~func_notfinite):
        flags |= LM_SINGULAR_MATRIX
    if zero_dof:
        flags |= ZERO_DOF
    cov_bad = bool(singular) or zero_dof
    if not cov_bad and bool(neg_eig & ~eig_notfinite):
        flags |= LM_NEG_COV_EIG
    if not cov_bad and bool(neg_diag & ~eig_notfinite):
        flags |= LM_NEG_COV_DIAG
    if not cov_bad and bool(eig_notfinite):
        flags |= EIG_NOTFINITE
    if maxed and not done and flags == 0:
        flags |= MAXITER

    cov_ok = not (cov_bad or bool(neg_eig | neg_diag | eig_notfinite))
    perr = (torch.sqrt(torch.abs(torch.diagonal(pcov))) if cov_ok
            else torch.full((npars,), CDEF, dtype=dtype, device=dev))
    pars_out = torch.full_like(pars, PDEF) if bool(func_notfinite) else pars
    pcov_out = pcov if cov_ok else torch.full((npars, npars), CDEF, dtype=dtype, device=dev)
    ier = 1 if bool(small_cost) else 2 if bool(small_step) else 5
    return {
        "pars": pars_out,
        "pars_err": perr,
        "pars_cov": pcov_out,
        "pars_cov0": pcov0,
        "flags": torch.tensor(flags, dtype=torch.int32, device=dev),
        "nfev": torch.tensor(nfev, dtype=torch.int32, device=dev),
        "ier": torch.tensor(ier, dtype=torch.int32, device=dev),
        "cost": cost,
        "s_sq": s_sq,
    }


def _tree_index(tree, i):
    """lane i of every tensor of a nested tuple, NamedTuple, list or
    dict (None stays None)"""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_index(v, i) for v in tree))
    return type(tree)(_tree_index(v, i) for v in tree)


def run_lm_batch(resid_fn, data, guess, lo, hi, conf: LMConf, n_prior_pars=0,
                 k_space=False, n_eff=None):
    """run_lm over a batch, lane by lane: data (a nested structure of
    tensors) and guess carry a leading [B] dim, n_eff (if given) is a
    [B] row count; returns run_lm's fields stacked along [B]"""
    outs = [run_lm(resid_fn, _tree_index(data, i), guess[i], lo, hi, conf,
                   n_prior_pars=n_prior_pars, k_space=k_space,
                   n_eff=None if n_eff is None else int(n_eff[i]))
            for i in range(guess.shape[0])]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ----------------------------------------------------------------------
# the solver loop

def _take(tree, idx):
    """the lanes idx of every tensor of a nested tuple or dict"""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return tuple(_take(v, idx) for v in tree)


def _active(s, conf):
    return (~s["done"]) & (s["nfev"] < conf.maxfev)


def _count_active(s, conf):
    """the number of active lanes: the loop's one read from the device
    per iteration"""
    return int(torch.count_nonzero(_active(s, conf)))


def _lm_step(s, data, eval_normal, lo, hi, conf, at_floor=False):
    """one LM iteration of every lane of a level; inactive lanes keep
    their state. at_floor: end a lane whose trial cost equals its cost
    while the model predicts less than ftol of it (MINPACK lmdif's ftol
    test), as the reference's residual-form run_lm stops; the host
    fitters' kernel routes set it. Off (the reference's batched LM), the
    lane rejects its steps until lambda passes lambda_max"""
    active = _active(s, conf)
    pinned = _pinned_dims(s["y"], s["Jtr"], s["cost"], conf.ftol, lo, hi)
    # a pin transition invalidates the escalated damping and any
    # convergence verdict of this iteration
    pin_changed = torch.any(pinned != s["pinned"], dim=-1)
    lam_eff = torch.where(pin_changed, conf.lambda0, s["lam"])
    JtJ_m, Jtr_m = _mask_normal(s["JtJ"], s["Jtr"], pinned)
    dy = _solve_damped(JtJ_m, Jtr_m, lam_eff)
    step_ok = torch.all(torch.isfinite(dy), dim=-1)
    dy = torch.where(step_ok[:, None], dy, 0.0)

    y_try = clip_internal(s["y"] + dy, lo, hi)
    dy = y_try - s["y"]
    cost_try, cost_pix_try, Jtr_try, JtJ_try = eval_normal(y_try, data)
    cost_try = torch.where(torch.isfinite(cost_try), cost_try, torch.inf)

    accept = step_ok & (cost_try < s["cost"])

    # predicted reduction of the quadratic model
    JtJ_dy = _lane_sum(s["JtJ"] * dy[:, None, :])
    pred = -_lane_sum(dy * (2.0 * s["Jtr"])) - _lane_sum(dy * JtJ_dy)
    pred = torch.clamp(pred, min=1.0e-300)
    actual = s["cost"] - cost_try

    small_cost = accept & (
        (actual <= conf.ftol * s["cost"]) & (pred <= conf.ftol * s["cost"])
    )
    if at_floor:
        small_cost = small_cost | step_ok & (actual == 0) & (pred <= conf.ftol * s["cost"])
    # xtol over the free dims only
    yf = s["y"] * (~pinned).to(dy.dtype)
    ynorm = torch.sqrt(_lane_sum(yf * yf))
    small_step = accept & (
        torch.sqrt(_lane_sum(dy * dy)) <= conf.xtol * (ynorm + conf.xtol)
    )
    stuck = (~accept) & (lam_eff >= conf.lambda_max)

    new_lam = torch.where(
        accept,
        torch.clamp(lam_eff / conf.lambda_down, min=conf.lambda_min),
        torch.clamp(lam_eff * conf.lambda_up, max=conf.lambda_max * 10.0),
    )

    upd = active & accept
    return {
        "y": torch.where(upd[:, None], y_try, s["y"]),
        "cost": torch.where(upd, cost_try, s["cost"]),
        "cost_pix": torch.where(upd, cost_pix_try, s["cost_pix"]),
        "Jtr": torch.where(upd[:, None], Jtr_try, s["Jtr"]),
        "JtJ": torch.where(upd[:, None, None], JtJ_try, s["JtJ"]),
        "lam": torch.where(active, new_lam, s["lam"]),
        "nfev": s["nfev"] + active.to(torch.int32),
        "done": s["done"]
        | (active & (small_cost | small_step | stuck) & ~pin_changed),
        "ier_small_step": torch.where(active, small_step, s["ier_small_step"]),
        "ier_small_cost": torch.where(active, small_cost, s["ier_small_cost"]),
        "pinned": torch.where(active[:, None], pinned, s["pinned"]),
    }


def _capacities(compact_capacity, B):
    if compact_capacity is None:
        caps = []
    elif isinstance(compact_capacity, int):
        caps = [compact_capacity]
    else:
        caps = list(compact_capacity)
    return sorted({int(k) for k in caps if 0 < int(k) < B}, reverse=True)


def compaction_levels(nfev, compact_capacity):
    """(lanes, iterations) of each compaction level that
    run_lm_normal_batched ran, widest first, worked out from the nfev
    [B] it returned and the compact_capacity it was given: an active
    lane gains one nfev per iteration, so after t iterations the lanes
    with nfev > t + 1 are the active ones"""
    steps = torch.sort((nfev.reshape(-1) - 1).cpu()).values
    B = steps.numel()

    def n_act(t):
        return B - int(torch.searchsorted(steps, t, right=True))

    levels, width, t = [], B, 0
    for K in _capacities(compact_capacity, B):
        if n_act(t) == 0:
            break
        t0 = t
        while n_act(t) > K:
            t += 1
        levels.append((width, t - t0))
        width = K
    t0 = t
    while n_act(t) > 0:
        t += 1
    levels.append((width, t - t0))
    return levels


def run_lm_normal_batched(normal_fn, data, guess, lo, hi, conf: LMConf,
                          nres, k_space=False, compact_capacity=None, gather_fn=None,
                          prior_fn=None):
    """Batched LM driven by normal-equation reductions: the finished
    solver state of run_lm_normal_state through _normal_epilogue.

    ``normal_fn(x_ext [B, npars], data) -> (cost [B], Jtr [B, npars],
    JtJ [B, npars, npars])`` in external coordinates; ``data`` is a
    nested tuple of tensors with leading dim [B], which the solver
    gathers at each compaction level. guess [B, npars]; lo, hi [npars]
    with +-inf for unbounded sides. ``nres`` is the pixel row count, an
    int or a [B] tensor of unmasked counts (the chi^2/dof scale).

    compact_capacity: straggler compaction, None, an int K or a
    descending tuple. Each level iterates until the active lanes fit in
    the next capacity, then gathers them, and the loop-invariant data
    once, into a batch of that size; the results are scattered back at
    the end. Results are bitwise equal to the uncompacted run.

    gather_fn(data, idx) -> data gathers the data of the lanes idx [K]
    at a compaction level, for data whose lane axis is not the leading
    axis of every tensor (the multi-band fit's epoch rows, E a lane);
    the default takes idx on the leading axis of every tensor.

    prior_fn(x_ext [B, npars]) -> (rows [B, R], Jp [B, R, npars]) adds
    a prior's pseudo-residual rows to the objective (a joint prior's
    fill_fdiff_jacobian), in external coordinates before the bounds
    chain rule: cost += sum rows^2, Jtr += Jp^T rows, JtJ += Jp^T Jp.
    The covariance scales by the pixel cost alone (cost_pix / dof);
    k_space halves the dof (nres // 2 - npars), as for complex residuals.
    """
    lo = torch.as_tensor(lo, dtype=guess.dtype, device=guess.device)
    hi = torch.as_tensor(hi, dtype=guess.dtype, device=guess.device)
    state = run_lm_normal_state(normal_fn, data, guess, lo, hi, conf,
                                compact_capacity=compact_capacity,
                                gather_fn=gather_fn, prior_fn=prior_fn)
    return _normal_epilogue(state, lo, hi, conf, nres, k_space)


def _internal_normal_fn(normal_fn, lo, hi, prior_fn=None):
    """eval_normal(y, data) -> (cost, cost_pix, Jtr, JtJ) in internal
    coordinates: the pixels' normal equations at i2e(y), the prior rows
    added in external coordinates, then the bounds chain rule J_int =
    J_ext diag(g)"""

    def eval_normal(y, d):
        x = i2e(y, lo, hi)
        cost_pix, Jtr, JtJ = normal_fn(x, d)
        cost = cost_pix
        if prior_fn is not None:
            rows, Jp = prior_fn(x)
            # sums over the rows first, unrolled, then into the pixels'
            # (an inf row makes Jtr nan: Jp is 0 there, as in the
            # reference)
            cost = cost_pix + _lane_sum(rows * rows)
            Jtr = Jtr + _row_sum(Jp * rows[..., None])
            JtJ = JtJ + _row_sum(Jp[..., :, None] * Jp[..., None, :])
        g = i2e_grad(y, lo, hi)
        return cost, cost_pix, Jtr * g, JtJ * g[..., :, None] * g[..., None, :]

    return eval_normal


def run_lm_normal_state(normal_fn, data, guess, lo, hi, conf: LMConf,
                        compact_capacity=None, gather_fn=None, prior_fn=None,
                        graph=False, at_floor=False):
    """the solver loop of run_lm_normal_batched (same arguments but
    nres): the finished per-lane state y, cost (with the prior rows),
    cost_pix (the pixels' alone), Jtr, JtJ (internal coordinates), lam,
    nfev, done, ier_small_step, ier_small_cost and pinned, which
    _normal_epilogue turns into the result. graph=True (CUDA tensors, a
    normal_fn that launches no kernel of ours and reads nothing to the
    host): the iterations after the last compaction level replay one
    captured step (_stepper). at_floor: _lm_step's stop at the cost
    floor (off, as the reference's batched LM)"""
    B, npars = guess.shape
    dtype, dev = guess.dtype, guess.device
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)

    eval_normal = _internal_normal_fn(normal_fn, lo, hi, prior_fn)

    y0 = e2i(guess, lo, hi)
    cost0, cost_pix0, Jtr0, JtJ0 = eval_normal(y0, data)
    state = {
        "y": y0,
        "cost": cost0,
        "cost_pix": cost_pix0,
        "Jtr": Jtr0,
        "JtJ": JtJ0,
        "lam": torch.full((B,), conf.lambda0, dtype=dtype, device=dev),
        "nfev": torch.ones((B,), dtype=torch.int32, device=dev),
        "done": torch.zeros((B,), dtype=torch.bool, device=dev),
        "ier_small_step": torch.zeros((B,), dtype=torch.bool, device=dev),
        "ier_small_cost": torch.zeros((B,), dtype=torch.bool, device=dev),
        "pinned": torch.zeros((B, npars), dtype=torch.bool, device=dev),
    }

    outer = []  # (state before the gather, gathered lane index) per level
    cur_state, cur_data = state, data
    n_act = _count_active(cur_state, conf)
    for K in _capacities(compact_capacity, B):
        if n_act == 0:
            break
        while n_act > K:
            cur_state = _lm_step(cur_state, cur_data, eval_normal, lo, hi, conf, at_floor)
            n_act = _count_active(cur_state, conf)
        # stable partition, active lanes first in their original order;
        # the inactive rows that fill the level are frozen by the
        # active mask
        inactive = (~_active(cur_state, conf)).to(torch.int32)
        idx = torch.argsort(inactive, stable=True)[:K]
        outer.append((cur_state, idx))
        cur_data = (_take if gather_fn is None else gather_fn)(cur_data, idx)
        cur_state = _take(cur_state, idx)

    if n_act > 0:
        advance = _stepper(
            lambda st: _lm_step(st, cur_data, eval_normal, lo, hi, conf, at_floor), cur_state,
            graph)
        while n_act > 0:
            cur_state = advance()
            n_act = _count_active(cur_state, conf)
    # scatter each level's results back; lanes left behind at a gather
    # were inactive there, so their frozen values are final
    for prev_state, idx in reversed(outer):
        cur_state = {
            k: prev_state[k].index_copy(0, idx, v) for k, v in cur_state.items()
        }
    return cur_state


def _normal_epilogue(out, lo, hi, conf, nres, k_space=False):
    """pars, covariance and flags from a finished solver state: the
    covariance through the unrolled Cholesky scaled by the pixels'
    chi^2/dof (cost_pix / (nres - npars), or cost_pix / (nres // 2 -
    npars) for k_space, whose nres rows are the real and imaginary parts
    of complex residuals; prior rows never enter it), with the
    reference's flag semantics and order"""
    B, npars = out["y"].shape
    dtype, dev = out["y"].dtype, out["y"].device
    y = out["y"]
    pars = i2e(y, lo, hi)

    # external-space covariance: undo the bounds chain rule on the
    # stored internal JtJ and invert that, conditioned like the
    # unconstrained problem
    grad = i2e_grad(y, lo, hi)
    eye = torch.eye(npars, dtype=dtype, device=dev)
    g_safe = torch.where(grad == 0.0, torch.finfo(dtype).tiny, grad)
    JtJ_ext = out["JtJ"] / (g_safe[..., :, None] * g_safe[..., None, :])
    pcov0 = chol_inverse(JtJ_ext)

    singular = ~torch.all(torch.isfinite(pcov0.reshape(B, -1)), dim=-1)

    nres = torch.as_tensor(nres, device=dev)
    dof = (nres // 2 if k_space else nres) - npars
    zero_dof = torch.broadcast_to(dof == 0, (B,))
    dof_safe = torch.clamp(dof, min=1)
    s_sq = out["cost_pix"] / dof_safe
    pcov = pcov0 * s_sq[:, None, None]

    # positive definiteness through the Cholesky pivots (Sylvester)
    matsel = torch.where(singular[:, None, None], eye, pcov)
    mat_finite = torch.all(torch.isfinite(matsel.reshape(B, -1)), dim=-1)
    neg_eig = mat_finite & ~chol_is_spd(matsel)
    neg_diag = torch.any(torch.diagonal(pcov, dim1=-2, dim2=-1) < 0, dim=-1)
    eig_notfinite = ~mat_finite

    func_notfinite = ~torch.isfinite(out["cost"])
    maxed = out["nfev"] >= conf.maxfev

    def bit(cond, flag):
        return cond.to(torch.int32) * flag

    flags = torch.zeros((B,), dtype=torch.int32, device=dev)
    # a lane neither done nor at maxfev means the loop exited early
    flags = flags | bit(~out["done"] & ~maxed, SOLVER_INCOMPLETE)
    flags = flags | bit(func_notfinite, LM_FUNC_NOTFINITE)
    flags = flags | bit(singular & ~func_notfinite, LM_SINGULAR_MATRIX)
    flags = flags | bit(zero_dof, ZERO_DOF)
    cov_bad = singular | zero_dof
    flags = flags | bit(~cov_bad & neg_eig & ~eig_notfinite, LM_NEG_COV_EIG)
    flags = flags | bit(~cov_bad & neg_diag & ~eig_notfinite, LM_NEG_COV_DIAG)
    flags = flags | bit(~cov_bad & eig_notfinite, EIG_NOTFINITE)
    flags = flags | bit(maxed & ~out["done"] & (flags == 0), MAXITER)

    cov_ok = ~(cov_bad | neg_eig | neg_diag | eig_notfinite)
    perr = torch.where(
        cov_ok[:, None],
        torch.sqrt(torch.abs(torch.diagonal(pcov, dim1=-2, dim2=-1))),
        CDEF,
    )
    pars_out = torch.where(func_notfinite[:, None], PDEF, pars)
    pcov_out = torch.where(cov_ok[:, None, None], pcov, CDEF)

    ier = torch.where(
        out["ier_small_cost"], 1, torch.where(out["ier_small_step"], 2, 5)
    ).to(torch.int32)
    return {
        "pars": pars_out,
        "pars_err": perr,
        "pars_cov": pcov_out,
        "pars_cov0": pcov0,
        "flags": flags,
        "nfev": out["nfev"],
        "ier": ier,
        "cost": out["cost"],
        "s_sq": s_sq,
    }


def run_gn_refine_state(normal_fn, data, guess, lo, hi, conf: LMConf, niter=3,
                        lam=1.0e-6, prior_fn=None):
    """the solver state of run_gn_refine_batched (same arguments but nres
    and k_space): niter unconditional damped Gauss-Newton steps from
    e2i(guess) at the fixed damping lam, each with the LM step's pinned
    dims and clip, a step that is not finite dropped, then one more
    evaluation at the final point. The state holds y, cost, cost_pix,
    Jtr and JtJ of that evaluation, lam, nfev = niter + 1, done and
    ier_small_step true, ier_small_cost false, and the last step's
    pinned dims (none at niter = 0)."""
    B, npars = guess.shape
    dtype, dev = guess.dtype, guess.device
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)
    eval_normal = _internal_normal_fn(normal_fn, lo, hi, prior_fn)
    y = e2i(guess, lo, hi)
    pinned = torch.zeros((B, npars), dtype=torch.bool, device=dev)
    for _ in range(niter):
        cost, _, Jtr, JtJ = eval_normal(y, data)
        # the LM step's saturated-bound handling: pin the dims on a bound
        # with an outward, unresolvable gradient, and clip
        pinned = _pinned_dims(y, Jtr, cost, conf.ftol, lo, hi)
        JtJ_m, Jtr_m = _mask_normal(JtJ, Jtr, pinned)
        dy = _solve_damped(JtJ_m, Jtr_m, lam)
        ok = torch.all(torch.isfinite(dy), dim=-1)
        y = clip_internal(y + torch.where(ok[:, None], dy, 0.0), lo, hi)
    cost, cost_pix, Jtr, JtJ = eval_normal(y, data)
    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    return {
        "y": y,
        "cost": cost,
        "cost_pix": cost_pix,
        "Jtr": Jtr,
        "JtJ": JtJ,
        "lam": torch.full((B,), lam, dtype=dtype, device=dev),
        "nfev": torch.full((B,), niter + 1, dtype=torch.int32, device=dev),
        "done": ones,
        "ier_small_step": ones,
        "ier_small_cost": torch.zeros_like(ones),
        "pinned": pinned,
    }


def run_gn_refine_batched(normal_fn, data, guess, lo, hi, conf: LMConf, nres, niter=3,
                          lam=1.0e-6, k_space=False, prior_fn=None):
    """fixed-iteration damped Gauss-Newton refinement from a near-optimal
    start (ngmix_tpu/fitting/lm.py: run_gn_refine_batched): the state of
    run_gn_refine_state through _normal_epilogue. For the sheared
    metacal types the target differs from the solved noshear fit by an
    O(step) perturbation, so a few unconditional steps from the noshear
    optimum converge quadratically with no accept or reject and no
    straggler tail; niter = 0 is one evaluation at the guess. Arguments
    as run_lm_normal_batched's; k_space halves the dof (nres // 2 -
    npars) in the epilogue, as for complex residuals."""
    lo = torch.as_tensor(lo, dtype=guess.dtype, device=guess.device)
    hi = torch.as_tensor(hi, dtype=guess.dtype, device=guess.device)
    state = run_gn_refine_state(normal_fn, data, guess, lo, hi, conf, niter=niter, lam=lam,
                                prior_fn=prior_fn)
    return _normal_epilogue(state, lo, hi, conf, nres, k_space)

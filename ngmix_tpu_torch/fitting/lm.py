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
"""
from typing import NamedTuple

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
    # the analytic flux column of the reference's AD normal equations;
    # not ported yet (ROADMAP queue item 10)
    flux_col: bool = False
    # variable projection of the flux; not ported yet (ROADMAP queue
    # item 10)
    varpro: bool = False


def check_supported(conf: LMConf):
    """raise for the LMConf options this port has not taken over"""
    for name in ("flux_col", "varpro"):
        if getattr(conf, name):
            raise NotImplementedError(
                "LMConf.%s=True is not ported yet: ROADMAP queue item 10 "
                "(LM options)" % name
            )


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


def _lm_step(s, data, eval_normal, lo, hi, conf):
    """one LM iteration of every lane of a level; inactive lanes keep
    their state"""
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
    cost_try, Jtr_try, JtJ_try = eval_normal(y_try, data)
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
                          nres, compact_capacity=None):
    """Batched LM driven by normal-equation reductions.

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

    The reference's prior rows (prior_fn), custom gathers (gather_fn)
    and k-space residuals (k_space) are not ported yet (ROADMAP queue
    items 5, 9 and 13).
    """
    B, npars = guess.shape
    dtype, dev = guess.dtype, guess.device
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)

    def eval_normal(y, d):
        """(cost, Jtr, JtJ) in internal coordinates: the bounds chain
        rule J_int = J_ext diag(g)"""
        cost, Jtr, JtJ = normal_fn(i2e(y, lo, hi), d)
        g = i2e_grad(y, lo, hi)
        return cost, Jtr * g, JtJ * g[..., :, None] * g[..., None, :]

    y0 = e2i(guess, lo, hi)
    cost0, Jtr0, JtJ0 = eval_normal(y0, data)
    state = {
        "y": y0,
        "cost": cost0,
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
            cur_state = _lm_step(cur_state, cur_data, eval_normal, lo, hi, conf)
            n_act = _count_active(cur_state, conf)
        # stable partition, active lanes first in their original order;
        # the inactive rows that fill the level are frozen by the
        # active mask
        inactive = (~_active(cur_state, conf)).to(torch.int32)
        idx = torch.argsort(inactive, stable=True)[:K]
        outer.append((cur_state, idx))
        cur_data = _take(cur_data, idx)
        cur_state = _take(cur_state, idx)

    while n_act > 0:
        cur_state = _lm_step(cur_state, cur_data, eval_normal, lo, hi, conf)
        n_act = _count_active(cur_state, conf)
    # scatter each level's results back; lanes left behind at a gather
    # were inactive there, so their frozen values are final
    for prev_state, idx in reversed(outer):
        cur_state = {
            k: prev_state[k].index_copy(0, idx, v) for k, v in cur_state.items()
        }
    return _normal_epilogue(cur_state, lo, hi, conf, nres)


def _normal_epilogue(out, lo, hi, conf, nres):
    """pars, covariance and flags from a finished solver state: the
    chi^2/dof-scaled covariance through the unrolled Cholesky, with the
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
    dof = nres - npars
    zero_dof = torch.broadcast_to(dof == 0, (B,))
    dof_safe = torch.clamp(dof, min=1)
    s_sq = out["cost"] / dof_safe
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

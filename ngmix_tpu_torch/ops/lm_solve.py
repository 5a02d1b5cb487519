"""K3: every lane's whole Levenberg-Marquardt solve of a model (exp,
gauss, dev, bdf or bd) in one hand-written CUDA kernel.

K3 computes what ``fitting.lm.run_lm_normal_state`` computes over the
model's normal equations (``batch._exp_normal_fn``, K1's pixel pass)
without compaction, lane by lane in the order of ``lm._lm_step``:
e2i of the guess and the first evaluation, then, while a lane is
neither done nor at maxfev, the pinned dims, the masked and damped
Cholesky solve, the clipped trial point and its evaluation, the accept
test, the predicted reduction, the ftol / xtol / stuck rules and the
damping update. An evaluation is the model's fill (6, 1 or 10
gaussians of fixed (p, f) for exp, gauss and dev; 16 for bdf and bd,
whose (p, f) and size factor follow the lane's fracdev and, for bd,
log10(Td/Te)), the convolution with the one psf gaussian,
gmix_reparam, the chain in closed form (``batch.exp_chain``), K1's sums
over the model's 6, 7 or 8 parameters and the bounds chain rule; a bad
point gets cost 1e30, Jtr 0 and JtJ = I. The model is a template
argument of the kernel: each model and type is its own instance, and a
model the kernels do not hold raises.

Replaces ``ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas`` together
with the loop around it, ``ngmix_tpu/fitting/lm.py:
run_lm_normal_batched`` (its ``while_loop`` body). The kernel is
``ngmix_tpu_torch/csrc/lm_solve.cuh``, instantiated by ``lm_solve.cu``
(exp, gauss, dev) and ``lm_solve_<model>.cu`` (bdf, bd), built by
``ops/_build.py`` and
bound with ctypes; ``lm_solve_plain`` is its plain PyTorch version.

What bounds it on an H100: the arithmetic of K1's pixel pass times the
evaluations each lane needs (about 5.5 at the main path), against the
pixel planes read once. The host loop it replaces launched ~770 small
kernels per LM iteration and left the card idle; K3 is one launch. A
persistent grid of warps takes lanes from an atomic counter, one warp
per lane, so a lane that needs 23 evaluations holds one warp and no
other lane waits for it; each warp copies its lane's planes into
shared memory once (cp.async) and every evaluation reads them there; a
lane of more than MAX_P pixels reads them from global memory.
Sums reduce in a fixed shuffle order, so a lane's result does not
depend on its batch or on the warp that ran it.

K3-mb (``lm_solve_mb``, ``csrc/lm_solve_mb.cuh``, two translation
units a model, ``csrc/lm_solve_mb_<model>.cu`` for float32 and
``lm_solve_mb_<model>_f64.cu``) is the same solve for the
joint multi-band, multi-epoch fit of ``batch.metacal_pipeline_mb``:
a lane is one object over its E epochs, each epoch with its own psf
gaussian and band, and nshape + nband parameters (the model's nshape
shape columns, 5, 6 for bdf or 7 for bd, and one flux a band). Per
evaluation each epoch's nshape + 1 effective parameters go through
K3's fill, chain and pixel pass, and the band one-hot sums assemble the
global system, as ``batch._mb_exp_normal_fn`` does; a bad point in any
epoch gives the reference's poisoned lane (cost E P FDIFF_BAD^2, Jtr 0,
JtJ 0). ``lm_solve_mb_plain`` is its plain version. It replaces the same
TPU kernel and loop, under the multi-band objective
(``ngmix_tpu/batch.py: _mb_epochwise_normal_fn_f``).

Both take a joint prior (``joint_prior.PriorSimpleSep``,
``PriorBDFSep``, ``PriorBDSep``) whose rows regularize every lane's fit
as ``ngmix_tpu/fitting/lm.py:611-632`` adds them: in external
coordinates before the bounds chain rule, cost += sum rows^2, Jtr +=
Jp^T rows, JtJ += Jp^T Jp. The kernels read the prior as a small table
(``prior.table()``, [nrows, 8] float64 in device memory) and evaluate
each row and its derivatives in closed form, each row on a thread of
the warp; the plain versions take ``prior.fill_fdiff_jacobian``. The
state carries the pixels' cost beside the total as cost_pix, which
scales the covariance.

K3 has two more modes, each one launch of an instance of its own
(``csrc/lm_solve_opt.cuh``; ``lm_solve_opt.cu`` for exp,
``lm_solve_opt_<model>.cu`` for each other model; the planes' placement
a runtime choice there),
selected by ``lm_solve``'s arguments:

- ``refine=n``: n unconditional damped Gauss-Newton steps at a fixed
  damping (``ngmix_tpu/fitting/lm.py: run_gn_refine_batched``, the
  sheared metacal types refined from the noshear optimum): the LM
  step's pin test and damped Cholesky step without the trial
  evaluation or the accept test, a step that is not finite dropped,
  then one evaluation at the final point; plain version
  ``fitting.lm.run_gn_refine_state``.
- ``varpro=True``: variable projection of the flux
  (``ngmix_tpu/batch.py: _run_varpro``). Each evaluation takes one
  value-only pass over the pixels for the optimal flux F = sum(m y) /
  sum(m^2) of the unit-flux model, then K1's pass at flux F, whose
  residuals F m - y are formed pixel by pixel, and folds dF/dq into the
  shape block. The LM runs over the first NP - 1 dims of the NP-wide
  loop, the flux dim held at 0 with its row and column zeroed, so its
  step is exactly 0 and the stopping tests are the reduced solve's. The
  launch ends with the full-width evaluation at (q*, F(q*)) in the
  reference's bad-point convention; plain version
  ``batch.varpro_state``.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
import ctypes
import functools

import torch

from .. import joint_prior
from ..fitting import fit_model, lm
from . import _build

# the largest pixel count whose planes the kernels copy into shared
# memory (4 warps x 4 planes x P float64 values per block); a lane with
# more pixels reads its planes from global memory
MAX_P = 1536

# the models the kernels hold (batch._MODEL_FILLS: 6, 1 and 10
# gaussians, and 16 for the composite bdf and bd)
MODELS = _build.LM_MODELS

# the bands K3-mb is built for (ugrizy)
MAX_NBAND = 6

# the most prior rows a lane's table may hold (csrc/lm_common.cuh:
# kMaxPriorRows)
MAX_PRIOR_ROWS = 16

# launches of the CUDA kernels since the last reset (set them to 0 to
# reset): K3, K3-mb, and K3 in its refine and varpro modes
launches = 0
launches_mb = 0
launches_refine = 0
launches_varpro = 0

# the modes of K3's options kernel (csrc/lm_solve_opt.cuh: kModeRefine,
# kModeVarpro)
MODE_REFINE = 1
MODE_VARPRO = 2

# the damping of the refine mode's Gauss-Newton steps
GN_LAMBDA = 1.0e-6

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def c_name(kernel, model, dtype):
    """the C function of a kernel ("lm_solve" or "lm_solve_mb") for a
    model and dtype, e.g. ngmix_lm_solve_dev_f32"""
    return "ngmix_%s_%s_%s" % (kernel, model, _DTYPES[dtype])


def _check_model(model):
    """the model's shape columns (before the flux); raises for a model
    the kernels do not hold"""
    if model not in MODELS:
        raise ValueError("K3 and K3-mb hold the models %s, not %r" % (MODELS, model))
    return fit_model.shape_count(model)


def _prior_fn(prior):
    return None if prior is None else prior.fill_fdiff_jacobian


def lm_solve_plain(guess, lo, hi, psf, v, u, ia, ve, conf, model="exp", prior=None,
                   refine=0, varpro=False):
    """plain PyTorch version of K3: the host loop of
    fitting.lm.run_lm_normal_state without compaction, over the model's
    normal equations with K1's plain version and the prior's rows (on
    CUDA tensors its steps replay a captured CUDA graph); with refine,
    fitting.lm.run_gn_refine_state over the same; with varpro,
    batch.varpro_state. Same arguments and result as lm_solve."""
    # batch imports this module, so its models are imported here
    from .. import batch

    def normal_fn(pars, data):
        planes, psf_gmix = data
        return batch._exp_normal_fn(pars, planes, psf_gmix, plain=True, model=model)

    data = ((v, u, ia, ve), batch._psf_gmix(psf))
    if refine:
        return lm.run_gn_refine_state(normal_fn, data, guess, lo, hi, conf, niter=refine,
                                      lam=GN_LAMBDA, prior_fn=_prior_fn(prior))
    if varpro:
        return batch.varpro_state(data, guess, lo, hi, conf, model)
    return lm.run_lm_normal_state(
        normal_fn, data, guess, lo, hi,
        conf, compact_capacity=None, prior_fn=_prior_fn(prior), graph=guess.is_cuda,
    )


def _check_common(guess, tensors, conf):
    """dtype, device, contiguity and maxfev of K3's and K3-mb's
    arguments"""
    if guess.dtype not in _DTYPES:
        raise TypeError("dtype must be float32 or float64, got %s" % guess.dtype)
    for t in tensors:
        if t.dtype != guess.dtype or t.device != guess.device:
            raise TypeError(
                "guess, lo, hi, psf, v, u, ia and ve must share dtype and device"
            )
        if not t.is_contiguous():
            raise ValueError("guess, lo, hi, psf, v, u, ia and ve must be contiguous")
    if conf.maxfev < 1:
        raise ValueError("maxfev must be >= 1, got %d" % conf.maxfev)


def _empty_state(guess):
    """the solver state's output tensors for guess [B, npars]"""
    B, npars = guess.shape
    return {
        "y": guess.new_empty((B, npars)),
        "cost": guess.new_empty((B,)),
        "cost_pix": guess.new_empty((B,)),
        "Jtr": guess.new_empty((B, npars)),
        "JtJ": guess.new_empty((B, npars, npars)),
        "lam": guess.new_empty((B,)),
        "nfev": guess.new_empty((B,), dtype=torch.int32),
        "done": guess.new_empty((B,), dtype=torch.bool),
        "ier_small_step": guess.new_empty((B,), dtype=torch.bool),
        "ier_small_cost": guess.new_empty((B,), dtype=torch.bool),
        "pinned": guess.new_empty((B, npars), dtype=torch.bool),
    }


def _conf_args(conf):
    return (conf.maxfev, conf.ftol, conf.xtol, conf.lambda0, conf.lambda_up,
            conf.lambda_down, conf.lambda_min, conf.lambda_max)


def _check_prior(prior, npars, nband, model):
    """raise for a prior that is not a joint prior of the port, or
    whose parameter slots are not the fit's"""
    if prior is None:
        return
    if not isinstance(prior, joint_prior.PRIORS):
        raise TypeError("prior must be one of the port's joint priors %s, got %s"
                        % (tuple(c.__name__ for c in joint_prior.PRIORS),
                           type(prior).__name__))
    if prior.npars != npars:
        raise ValueError(
            "the %s prior has %d parameter slots (%d shape columns and %d flux slots); "
            "the %s fit has %d (%d bands)" % (type(prior).__name__, prior.npars,
                                              prior.nshape, prior.nband, model, npars, nband))
    if prior.n_prior_pars > MAX_PRIOR_ROWS:
        raise ValueError("the kernels take at most %d prior rows, got %d"
                         % (MAX_PRIOR_ROWS, prior.n_prior_pars))


def _prior_table(prior, device):
    """(the prior's table on the device, or None, and its rows)"""
    if prior is None:
        return None, 0
    tab = prior.table()
    if tab.device != device:
        tab = tab.to(device)
    return tab.contiguous(), tab.shape[0]


def _check(guess, lo, hi, psf, planes, conf, model, prior=None, refine=0, varpro=False):
    npars = _check_model(model) + 1
    _check_prior(prior, npars, 1, model)
    if guess.dim() != 2 or guess.shape[1] != npars:
        raise ValueError(
            "K3 fits the %s model's %d-parameter vector: guess must be [B, %d], got %s"
            % (model, npars, npars, tuple(guess.shape))
        )
    B = guess.shape[0]
    if tuple(lo.shape) != (npars,) or tuple(hi.shape) != (npars,):
        raise ValueError("lo and hi must be [%d], got %s and %s"
                         % (npars, tuple(lo.shape), tuple(hi.shape)))
    if tuple(psf.shape) != (B, 3):
        raise ValueError(
            "K3 takes one psf gaussian per lane as psf [B, 3] = (irr, irc, "
            "icc) with B = %d, got %s" % (B, tuple(psf.shape))
        )
    P = planes[0].shape[-1] if planes[0].dim() == 2 else -1
    for x in planes:
        if tuple(x.shape) != (B, P):
            raise ValueError(
                "v, u, ia and ve must be [B, P] with B = %d, got %s"
                % (B, [tuple(x.shape) for x in planes])
            )
    if P < 1:
        raise ValueError("K3 needs P >= 1 pixels a lane, got %d" % P)
    _check_common(guess, (guess, lo, hi, psf) + tuple(planes), conf)
    if not (isinstance(refine, int) and 0 <= refine < 2**31):
        raise ValueError("refine must be an int >= 0, got %r" % (refine,))
    if refine and varpro:
        raise ValueError("refine and varpro are two modes; pass one")
    if varpro and (prior is not None or bool(torch.isfinite(lo[-1]) | torch.isfinite(hi[-1]))):
        raise ValueError("varpro solves the flux exactly: it takes no prior and an "
                         "unbounded flux")


def lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf, model="exp", prior=None, refine=0,
             varpro=False):
    """K3: the LM solve of the model (exp, gauss, dev, bdf or bd) of
    every lane.

    guess [B, npars] external (row, col, g1, g2, T, flux; bdf adds
    fracdev and bd log10(Td/Te) and fracdev before the flux: npars 6, 7
    or 8); lo, hi [npars] with +-inf for unbounded sides; psf [B, 3] the (irr, irc, icc) of one
    unit-flux psf gaussian; v, u, ia = ierr * area and ve = val * ierr
    [B, P]; conf an LMConf. Returns the finished solver state of
    fitting.lm.run_lm_normal_state: y, cost, Jtr, JtJ (internal
    coordinates), lam, nfev (int32), done, ier_small_step,
    ier_small_cost and pinned (bool), and cost_pix, the cost without the
    prior rows. prior: a joint prior of the model's parameter vector
    (one flux slot), or None. Any P >= 1: past MAX_P the kernel
    reads the planes from global memory. CPU tensors go to
    lm_solve_plain; CUDA tensors launch the model's kernel.

    refine = n > 0: n damped Gauss-Newton steps from the guess at the
    damping GN_LAMBDA, then one evaluation (fitting.lm.run_gn_refine_state's
    state). varpro=True (no prior, lo[-1] and hi[-1] infinite): the
    variable-projection solve of batch.varpro_state, whose state holds
    the reduced solve over the nshape shape columns and, under "full",
    the full-width evaluation at its optimum. Each is one launch of
    K3's options kernel on CUDA tensors.
    """
    global launches
    _check(guess, lo, hi, psf, (v, u, ia, ve), conf, model, prior, refine, varpro)
    if guess.device.type == "cpu":
        return lm_solve_plain(guess, lo, hi, psf, v, u, ia, ve, conf, model, prior,
                              refine=refine, varpro=varpro)
    if guess.device.type != "cuda":
        raise RuntimeError("K3 runs on CUDA or CPU tensors, not %s" % guess.device)
    if refine or varpro:
        return _lm_solve_opt(guess, lo, hi, psf, (v, u, ia, ve), conf, model, prior, refine)

    fn = getattr(_build.load(), c_name("lm_solve", model, guess.dtype))
    B, P = v.shape
    out = _empty_state(guess)
    if B == 0:
        return out
    # the lane counter the kernel's warps take their lanes from
    counter = guess.new_zeros((1,), dtype=torch.int32)
    tab, nprior = _prior_table(prior, guess.device)
    # the tensors' device is current only for the launch, so the caller's
    # current device is left as it was
    with torch.cuda.device(guess.device):
        err = fn(
            guess.data_ptr(), lo.data_ptr(), hi.data_ptr(), psf.data_ptr(),
            v.data_ptr(), u.data_ptr(), ia.data_ptr(), ve.data_ptr(),
            *(x.data_ptr() for x in out.values()), counter.data_ptr(),
            None if tab is None else tab.data_ptr(), B, P, nprior, *_conf_args(conf),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K3 lm_solve launch failed: CUDA error %d" % err)
    launches += 1
    return out


def _lm_solve_opt(guess, lo, hi, psf, planes, conf, model, prior, refine):
    """one launch of K3's options kernel: refine mode for refine > 0,
    else varpro mode"""
    global launches_refine, launches_varpro
    fn = getattr(_build.load(), c_name("lm_solve_opt", model, guess.dtype))
    B, P = planes[0].shape
    npars = guess.shape[1]
    out = _empty_state(guess)
    full = {k: out[k].new_empty(out[k].shape) for k in ("y", "cost", "cost_pix", "Jtr", "JtJ")}
    if refine == 0:
        # the reduced solve starts with the flux dim at internal 0
        guess = guess.clone()
        guess[:, -1] = 0.0
    if B > 0:
        counter = guess.new_zeros((1,), dtype=torch.int32)
        tab, nprior = _prior_table(prior, guess.device)
        with torch.cuda.device(guess.device):
            err = fn(
                guess.data_ptr(), lo.data_ptr(), hi.data_ptr(), psf.data_ptr(),
                *(x.data_ptr() for x in planes), *(x.data_ptr() for x in out.values()),
                counter.data_ptr(), None if tab is None else tab.data_ptr(),
                *(x.data_ptr() for x in full.values()), B, P, nprior, conf.maxfev,
                MODE_REFINE if refine else MODE_VARPRO, refine, *_conf_args(conf)[1:],
                GN_LAMBDA, torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError("K3 lm_solve (%s mode) launch failed: CUDA error %d"
                               % ("refine" if refine else "varpro", err))
    if refine:
        launches_refine += 1
        return out
    launches_varpro += 1
    ns = npars - 1
    state = {k: (v[:, :ns] if k in ("y", "Jtr", "pinned") else v[:, :ns, :ns] if k == "JtJ"
                 else v) for k, v in out.items()}
    # the constant fields of the full-width evaluation's state
    # (fitting.lm.run_gn_refine_state at niter = 0)
    ones = out["done"].new_ones((B,))
    state["full"] = dict(full, lam=full["cost"].new_full((B,), GN_LAMBDA),
                         nfev=out["nfev"].new_ones((B,)), done=ones, ier_small_step=ones,
                         ier_small_cost=ones.new_zeros((B,)),
                         pinned=out["pinned"].new_zeros((B, npars)))
    return state


def lm_solve_mb_plain(guess, lo, hi, psf, band, v, u, ia, ve, conf, model="exp",
                      prior=None):
    """plain PyTorch version of K3-mb: the host loop of
    fitting.lm.run_lm_normal_state without compaction, over the joint
    multi-band normal equations of the model (batch._mb_exp_normal_fn
    with K1's plain version) and the prior's rows (on CUDA tensors its
    steps replay a captured CUDA graph). Same arguments and result as
    lm_solve_mb."""
    from .. import batch

    B, E, P = v.shape
    band = torch.broadcast_to(band, (B, E))
    planes = tuple(x.reshape(B * E, P) for x in (v, u, ia, ve))
    psf_gmix = batch._psf_gmix(psf.reshape(B * E, 3))
    return lm.run_lm_normal_state(
        functools.partial(batch._mb_exp_normal_fn, plain=True, model=model),
        (planes, psf_gmix, band), guess, lo, hi, conf, compact_capacity=None,
        prior_fn=_prior_fn(prior), graph=guess.is_cuda,
    )


def _check_mb(guess, lo, hi, psf, band, planes, conf, model, prior=None):
    nshape = _check_model(model)
    if guess.dim() != 2:
        raise ValueError("guess must be [B, %d + nband], got %s"
                         % (nshape, tuple(guess.shape)))
    B, npars = guess.shape
    nband = npars - nshape
    if not 1 <= nband <= MAX_NBAND:
        raise ValueError(
            "K3-mb fits 1 to %d bands (%d + nband parameters of the %s model), got "
            "guess %s" % (MAX_NBAND, nshape, model, tuple(guess.shape))
        )
    _check_prior(prior, npars, nband, model)
    if tuple(lo.shape) != (npars,) or tuple(hi.shape) != (npars,):
        raise ValueError("lo and hi must be [%d], got %s and %s"
                         % (npars, tuple(lo.shape), tuple(hi.shape)))
    shape = tuple(planes[0].shape)
    if len(shape) != 3 or shape[0] != B or min(shape) < 1:
        raise ValueError("v, u, ia and ve must be [B, E, P] with B = %d, got %s"
                         % (B, [tuple(x.shape) for x in planes]))
    for x in planes:
        if tuple(x.shape) != shape:
            raise ValueError("v, u, ia and ve must share one [B, E, P] shape, got %s"
                             % [tuple(x.shape) for x in planes])
    E = shape[1]
    if tuple(psf.shape) != (B, E, 3):
        raise ValueError(
            "K3-mb takes one psf gaussian per epoch as psf [B, E, 3] = (irr, irc, "
            "icc) = %s, got %s" % ((B, E, 3), tuple(psf.shape))
        )
    if band.dtype != torch.int32 or band.device != guess.device or \
            tuple(band.shape) not in ((E,), (B, E)):
        raise ValueError("band must be an int32 [E] or [B, E] tensor on the device of "
                         "guess (E = %d), got %s %s" % (E, band.dtype, tuple(band.shape)))
    _check_common(guess, (guess, lo, hi, psf) + tuple(planes), conf)


def lm_solve_mb(guess, lo, hi, psf, band, v, u, ia, ve, conf, model="exp", prior=None):
    """K3-mb: the joint multi-band LM solve of the model (exp, gauss,
    dev, bdf or bd) of every object.

    guess [B, nshape + nband] external (row, col, g1, g2, T, bdf's
    fracdev or bd's log10(Td/Te) and fracdev, one flux a band: nshape
    5, 6 or 7), 1 <= nband <= MAX_NBAND; lo, hi [nshape + nband] with
    +-inf for unbounded sides; psf [B, E, 3] the (irr, irc, icc) of each epoch's
    unit-flux psf gaussian; band int32 [E] (shared) or [B, E], the band
    of each epoch (a band outside [0, nband) gives that epoch no flux);
    v, u, ia = ierr * area and ve = val * ierr [B, E, P]; conf an
    LMConf; prior a joint prior with nband flux slots, or None. Returns
    the finished solver state, as lm_solve does, with nshape + nband
    parameters. CPU tensors go to lm_solve_mb_plain; CUDA tensors launch
    the model's kernel.
    """
    global launches_mb
    _check_mb(guess, lo, hi, psf, band, (v, u, ia, ve), conf, model, prior)
    if guess.device.type == "cpu":
        return lm_solve_mb_plain(guess, lo, hi, psf, band, v, u, ia, ve, conf, model,
                                 prior)
    if guess.device.type != "cuda":
        raise RuntimeError("K3-mb runs on CUDA or CPU tensors, not %s" % guess.device)

    fn = getattr(_build.load(), c_name("lm_solve_mb", model, guess.dtype))
    B, E, P = v.shape
    band = torch.broadcast_to(band, (B, E)).contiguous()
    out = _empty_state(guess)
    counter = guess.new_zeros((1,), dtype=torch.int32)
    tab, nprior = _prior_table(prior, guess.device)
    with torch.cuda.device(guess.device):
        err = fn(
            guess.data_ptr(), lo.data_ptr(), hi.data_ptr(), psf.data_ptr(),
            band.data_ptr(), v.data_ptr(), u.data_ptr(), ia.data_ptr(), ve.data_ptr(),
            *(x.data_ptr() for x in out.values()), counter.data_ptr(),
            None if tab is None else tab.data_ptr(), B, E, P,
            guess.shape[1] - fit_model.shape_count(model), nprior, *_conf_args(conf),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K3-mb lm_solve_mb launch failed: CUDA error %d" % err)
    launches_mb += 1
    return out


def _attrs(out):
    return dict(regs=out[0], static_smem=out[1], dynamic_smem=out[2], blocks_per_sm=out[3],
                local_bytes=out[4])


def kernel_attrs(dtype, P, model="exp"):
    """registers a thread, static and dynamic shared memory (bytes),
    blocks an SM and local memory a thread (bytes: the stack frame,
    spills included) of the model's kernel at P pixels a lane, on the
    current CUDA device"""
    _check_model(model)
    out = (ctypes.c_int * 5)()
    err = getattr(_build.load(), c_name("lm_solve", model, dtype) + "_attrs")(P, out)
    if err != 0:
        raise RuntimeError("K3 lm_solve attributes failed: CUDA error %d" % err)
    return _attrs(out)


def kernel_attrs_opt(dtype, P, model="exp"):
    """kernel_attrs of K3's options kernel (refine and varpro modes) for
    the model at P pixels a lane"""
    _check_model(model)
    out = (ctypes.c_int * 5)()
    err = getattr(_build.load(), c_name("lm_solve_opt", model, dtype) + "_attrs")(P, out)
    if err != 0:
        raise RuntimeError("K3 options kernel attributes failed: CUDA error %d" % err)
    return _attrs(out)


def kernel_attrs_mb(dtype, nband, E, P, model="exp"):
    """kernel_attrs of K3-mb for the model at nband bands and E epochs
    of P pixels a lane"""
    _check_model(model)
    out = (ctypes.c_int * 5)()
    err = getattr(_build.load(), c_name("lm_solve_mb", model, dtype) + "_attrs")(
        nband, E, P, out)
    if err != 0:
        raise RuntimeError("K3-mb attributes failed: CUDA error %d" % err)
    return _attrs(out)

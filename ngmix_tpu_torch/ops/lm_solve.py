"""K3: every lane's whole exp-model Levenberg-Marquardt solve in one
hand-written CUDA kernel.

K3 computes what ``fitting.lm.run_lm_normal_state`` computes over the
exp model's normal equations (``batch._exp_normal_fn``, K1's pixel
pass) without compaction, lane by lane in the order of ``lm._lm_step``:
e2i of the guess and the first evaluation, then, while a lane is
neither done nor at maxfev, the pinned dims, the masked and damped
Cholesky solve, the clipped trial point and its evaluation, the accept
test, the predicted reduction, the ftol / xtol / stuck rules and the
damping update. An evaluation is the exp fill, the convolution with
the one psf gaussian, gmix_reparam, the chain in closed form
(``batch.exp_chain``), K1's sums and the bounds chain rule; a bad
point gets cost 1e30, Jtr 0 and JtJ = I.

Replaces ``ngmix_tpu/ops/pallas_lm.py: gmix_normal_eqs_pallas`` together
with the loop around it, ``ngmix_tpu/fitting/lm.py:
run_lm_normal_batched`` (its ``while_loop`` body). The kernel is
``ngmix_tpu_torch/csrc/lm_solve.cu``, built by ``ops/_build.py`` and
bound with ctypes; ``lm_solve_plain`` is its plain PyTorch version.

What bounds it on an H100: the arithmetic of K1's pixel pass times the
evaluations each lane needs (about 5.5 at the main path), against the
pixel planes read once. The host loop it replaces launched ~770 small
kernels per LM iteration and left the card idle; K3 is one launch. A
persistent grid of warps takes lanes from an atomic counter, one warp
per lane, so a lane that needs 23 evaluations holds one warp and no
other lane waits for it; each warp copies its lane's planes into
shared memory once (cp.async) and every evaluation reads them there.
Sums reduce in a fixed shuffle order, so a lane's result does not
depend on its batch or on the warp that ran it.

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises; it never falls back.
"""
import ctypes

import torch

from ..fitting import lm
from . import _build

NPARS = 6
# the largest pixel count whose planes fit the kernel's shared memory
# (4 warps x 4 planes x P float64 values per block)
MAX_P = 1536

# launches of the CUDA kernel since the last reset (set it to 0 to reset)
launches = 0

_C_FUNCS = {
    torch.float32: "ngmix_lm_solve_f32",
    torch.float64: "ngmix_lm_solve_f64",
}
_C_ATTRS = {
    torch.float32: "ngmix_lm_solve_attrs_f32",
    torch.float64: "ngmix_lm_solve_attrs_f64",
}


def lm_solve_plain(guess, lo, hi, psf, v, u, ia, ve, conf):
    """plain PyTorch version of K3: the host loop of
    fitting.lm.run_lm_normal_state without compaction, over the exp
    model's normal equations with K1's plain version. Same arguments
    and result as lm_solve."""
    # batch imports this module, so its exp model is imported here
    from .. import batch

    def normal_fn(pars, data):
        planes, psf_gmix = data
        return batch._exp_normal_fn(pars, planes, psf_gmix, plain=True)

    return lm.run_lm_normal_state(
        normal_fn, ((v, u, ia, ve), batch._psf_gmix(psf)), guess, lo, hi,
        conf, compact_capacity=None,
    )


def _check(guess, lo, hi, psf, planes, conf):
    lm.check_supported(conf)
    if guess.dim() != 2 or guess.shape[1] != NPARS:
        raise ValueError(
            "K3 fits the 6-parameter exp model: guess must be [B, 6], got %s"
            % (tuple(guess.shape),)
        )
    B = guess.shape[0]
    if tuple(lo.shape) != (NPARS,) or tuple(hi.shape) != (NPARS,):
        raise ValueError("lo and hi must be [6], got %s and %s"
                         % (tuple(lo.shape), tuple(hi.shape)))
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
    if not 1 <= P <= MAX_P:
        raise ValueError("K3 holds 1 <= P <= %d pixels a lane, got %d" % (MAX_P, P))
    if guess.dtype not in _C_FUNCS:
        raise TypeError("dtype must be float32 or float64, got %s" % guess.dtype)
    for t in (guess, lo, hi, psf) + tuple(planes):
        if t.dtype != guess.dtype or t.device != guess.device:
            raise TypeError(
                "guess, lo, hi, psf, v, u, ia and ve must share dtype and device"
            )
        if not t.is_contiguous():
            raise ValueError("guess, lo, hi, psf, v, u, ia and ve must be contiguous")
    if conf.maxfev < 1:
        raise ValueError("maxfev must be >= 1, got %d" % conf.maxfev)


def lm_solve(guess, lo, hi, psf, v, u, ia, ve, conf):
    """K3: the exp-model LM solve of every lane.

    guess [B, 6] external (row, col, g1, g2, T, flux); lo, hi [6] with
    +-inf for unbounded sides; psf [B, 3] the (irr, irc, icc) of one
    unit-flux psf gaussian; v, u, ia = ierr * area and ve = val * ierr
    [B, P]; conf an LMConf. Returns the finished solver state of
    fitting.lm.run_lm_normal_state: y, cost, Jtr, JtJ (internal
    coordinates), lam, nfev (int32), done, ier_small_step,
    ier_small_cost and pinned (bool). CPU tensors go to lm_solve_plain;
    CUDA tensors launch the kernel.
    """
    global launches
    _check(guess, lo, hi, psf, (v, u, ia, ve), conf)
    if guess.device.type == "cpu":
        return lm_solve_plain(guess, lo, hi, psf, v, u, ia, ve, conf)
    if guess.device.type != "cuda":
        raise RuntimeError("K3 runs on CUDA or CPU tensors, not %s" % guess.device)

    fn = getattr(_build.load(), _C_FUNCS[guess.dtype])
    B, P = v.shape
    out = {
        "y": guess.new_empty((B, NPARS)),
        "cost": guess.new_empty((B,)),
        "Jtr": guess.new_empty((B, NPARS)),
        "JtJ": guess.new_empty((B, NPARS, NPARS)),
        "lam": guess.new_empty((B,)),
        "nfev": guess.new_empty((B,), dtype=torch.int32),
        "done": guess.new_empty((B,), dtype=torch.bool),
        "ier_small_step": guess.new_empty((B,), dtype=torch.bool),
        "ier_small_cost": guess.new_empty((B,), dtype=torch.bool),
        "pinned": guess.new_empty((B, NPARS), dtype=torch.bool),
    }
    if B == 0:
        return out
    # the lane counter the kernel's warps take their lanes from
    counter = guess.new_zeros((1,), dtype=torch.int32)
    # the tensors' device is current only for the launch, so the caller's
    # current device is left as it was
    with torch.cuda.device(guess.device):
        err = fn(
            guess.data_ptr(), lo.data_ptr(), hi.data_ptr(), psf.data_ptr(),
            v.data_ptr(), u.data_ptr(), ia.data_ptr(), ve.data_ptr(),
            *(x.data_ptr() for x in out.values()), counter.data_ptr(),
            B, P, conf.maxfev, conf.ftol, conf.xtol, conf.lambda0,
            conf.lambda_up, conf.lambda_down, conf.lambda_min,
            conf.lambda_max, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError("K3 lm_solve launch failed: CUDA error %d" % err)
    launches += 1
    return out


def kernel_attrs(dtype, P):
    """registers a thread, static and dynamic shared memory (bytes) and
    blocks an SM of the kernel at P pixels a lane, on the current CUDA
    device"""
    out = (ctypes.c_int * 4)()
    err = getattr(_build.load(), _C_ATTRS[dtype])(P, out)
    if err != 0:
        raise RuntimeError("K3 lm_solve attributes failed: CUDA error %d" % err)
    return dict(regs=out[0], static_smem=out[1], dynamic_smem=out[2], blocks_per_sm=out[3])

"""The adaptive-moments measure of the PyTorch port (admom.py) against
ngmix_tpu.admom, in float64 on the same numpy inputs: B = 8 lanes over
the 19x19 window, with lanes that converge, a zero-flux lane, a fully
masked lane, a negative-flux lane and one started off center, under the
default configuration, maxiter = 3 (MAXITER), shiftmax = 0.1
(CEN_SHIFT) and cenonly.

Tolerance: flags, numiter and the per-quantity flags equal; every other
field to rtol 1e-8 and atol 1e-10 with NaNs in the same places, as
tests/test_batch_pipeline.py holds two implementations of one objective
against each other. The weight goes through K2's plain version on the
CPU, and through jax's plain eval_gmix in the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import admom as jadmom
from ngmix_tpu.gmix import core as jcore
from ngmix_tpu.pixels import Pixels as JPixels

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import admom, convert, flags

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

B = 8
SCALE = 0.263
INT_KEYS = ("flags", "numiter", "T_flags", "flux_flags", "rho4_flags")
CONFS = {
    "default": dict(),
    "maxiter3": dict(maxiter=3),
    "shiftmax": dict(shiftmax=0.1),
    "cenonly": dict(cenonly=True),
}


def _inputs(seed=3):
    """(v, u, area, val, ierr) [B, 361] of exp galaxies with noise, lanes
    4-6 made zero-flux, fully masked and negative; wt0 [B, 6] round
    guesses, lane 7's off center; jac_area [B]"""
    rng = np.random.RandomState(seed)
    g = np.arange(19)
    rr, cc = np.meshgrid(g, g, indexing="ij")
    cens = 9 + rng.uniform(-0.5, 0.5, (B, 2))
    v = (rr.reshape(-1)[None] - cens[:, :1]) * SCALE
    u = (cc.reshape(-1)[None] - cens[:, 1:]) * SCALE
    z = np.zeros(B)
    pars = np.stack([z, z, rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                     rng.uniform(0.3, 1.0, B), rng.uniform(50, 150, B)], -1)
    gm, _ = jcore.fill_exp(jnp.asarray(pars))
    val = np.array(jcore.eval_gmix(gm, jnp.asarray(v), jnp.asarray(u), SCALE**2, fast=False))
    val = val + rng.normal(0, 1e-3, val.shape)
    ierr = np.full(val.shape, 1e3)
    val[4] = 0.0
    ierr[5] = 0.0
    val[6] *= -1.0
    area = np.full(val.shape, SCALE**2)
    wt0 = np.tile([1.0, 0.0, 0.0, 0.3, 0.0, 0.3], (B, 1))
    wt0[7, 1] = 0.5
    return (v, u, area, val, ierr), wt0, np.full(B, SCALE**2)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def assert_results_equal(tres, jres, what):
    assert set(tres) == set(jres), (what, set(tres) ^ set(jres))
    for k, ref in jres.items():
        got = tres[k]
        assert np.shape(got) == np.shape(ref), (what, k)
        if k in INT_KEYS:
            np.testing.assert_array_equal(got, ref, err_msg=str((what, k)))
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10, equal_nan=True,
                                       err_msg=str((what, k)))


@pytest.mark.parametrize("name", sorted(CONFS))
def test_admom_batch_matches_jax(inputs, name):
    planes, wt0, jac_area = inputs
    jconf = jadmom.AdmomConf(**CONFS[name])
    jres = jadmom.admom_batch(JPixels(*map(jnp.asarray, planes)), jnp.asarray(wt0),
                              jnp.asarray(jac_area), jconf)
    jres = jax.tree.map(np.asarray, jres)
    tres = convert.to_numpy(nt.admom_batch(
        JPixels(*planes), wt0, jac_area, convert.admom_conf_from_fields(jconf), device="cpu"))
    assert_results_equal(tres, jres, name)
    f = tres["flags"]
    # the lanes reach the branches they were made for
    assert f[4] & flags.NONPOS_FLUX and f[5] & flags.NONPOS_FLUX and f[6] & flags.NONPOS_FLUX
    if name == "maxiter3":
        assert np.all(f[[0, 1, 2, 3, 7]] == flags.MAXITER)
        assert np.all(tres["numiter"][[0, 1, 2, 3, 7]] == 3)
    elif name == "shiftmax":
        assert f[7] == flags.CEN_SHIFT
    else:
        assert np.all(f[[0, 1, 2, 3, 7]] == 0)


def test_admom_batch_independent_of_lane_order(inputs):
    planes, wt0, jac_area = inputs
    conf = nt.AdmomConf()
    full = nt.admom_batch(JPixels(*planes), wt0, jac_area, conf, device="cpu")
    perm = np.random.RandomState(1).permutation(B)[:5]
    sub = nt.admom_batch(JPixels(*(x[perm] for x in planes)), wt0[perm], jac_area[perm], conf,
                         device="cpu")
    for k, x in sub.items():
        np.testing.assert_array_equal(x.numpy(), full[k].numpy()[perm], err_msg=k)


def test_deweight_matches_jax():
    rng = np.random.RandomState(8)
    n = 12
    wt = np.tile([1.0, 0.1, -0.2, 0.0, 0.0, 0.0], (n, 1))
    T = rng.uniform(0.3, 1.0, n)
    e = rng.uniform(-0.3, 0.3, (n, 2))
    wt[:, 3:] = 0.5 * T[:, None] * np.column_stack([1 - e[:, 0], e[:, 1], 1 + e[:, 0]])
    # measured moments inside the weight's: a valid deweight
    Irr, Irc, Icc = (wt[:, 3:] * rng.uniform(0.4, 0.9, n)[:, None]).T.copy()
    Irr[0] = Icc[0] = 0.0  # det M = 0
    wt[1, 3:] = [0.1, 0.2, 0.1]  # det W < 0
    Irr[2], Icc[2], Irc[2] = wt[2, 3], wt[2, 5], wt[2, 4]  # M = W: det N = 0
    # wider than W along rows, narrower along columns: det N < 0
    wt[3, 4] = Irc[3] = 0.0
    Irr[3], Icc[3] = 2 * wt[3, 3], 0.5 * wt[3, 5]
    want = jax.vmap(jadmom._deweight)(*map(jnp.asarray, (wt, Irr, Irc, Icc)))
    got = admom._deweight(*map(torch.as_tensor, (wt, Irr, Irc, Icc)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-8, atol=1e-10)
    assert np.all(got[1].numpy()[:4] == flags.LOW_DET) and np.all(got[1].numpy()[4:] == 0)


def _crafted_raw():
    """raw admom outputs, one lane per branch of admom_result: a good
    lane; a flagged one; T at 0; var55, var44, var66 and a diagonal
    element of the covariance at or below 0; a non-positive flux sum;
    an infinite shape error (sums[4] = 0); a zero weight sum"""
    rng = np.random.RandomState(2)
    n = 10
    A = rng.normal(size=(n, 7, 7))
    cov = A @ np.transpose(A, (0, 2, 1)) + 7 * np.eye(7)
    sums = rng.uniform(1.0, 2.0, (n, 7))
    pars = np.column_stack([rng.normal(size=(n, 2)), rng.uniform(-0.1, 0.1, (n, 2)),
                            rng.uniform(0.3, 1.0, n), np.ones(n)])
    raw = dict(
        flags=np.zeros(n, np.int32), numiter=np.full(n, 5, np.int32), sums=sums,
        sums_cov=cov, wsum=rng.uniform(1.0, 3.0, n), pars=pars,
        rho4=rng.uniform(1.5, 2.5, n), wgt_norm=rng.uniform(0.5, 1.0, n),
        wt=rng.normal(size=(n, 6)),
    )
    raw["flags"][1] = flags.NONPOS_SIZE
    raw["pars"][2, 4] = 0.0
    raw["sums_cov"][3, 5, 5] = -1.0
    raw["sums_cov"][4, 4, 4] = 0.0
    raw["sums_cov"][5, 6, 6] = -2.0
    raw["sums_cov"][6, 3, 3] = 0.0
    raw["sums"][7, 5] = -1.0
    raw["sums"][8, 4] = 0.0
    raw["wsum"][9] = 0.0
    return raw, np.full(n, SCALE**2)


def test_admom_result_branches_match_jax():
    raw, jac_area = _crafted_raw()
    jres = jax.tree.map(np.asarray, jadmom.admom_result(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(jac_area)))
    tres = convert.to_numpy(admom.admom_result(
        {k: torch.as_tensor(v) for k, v in raw.items()}, torch.as_tensor(jac_area)))
    assert_results_equal(tres, jres, "crafted")
    # each lane reaches its branch
    np.testing.assert_array_equal(tres["flags"], [
        0, flags.NONPOS_SIZE, flags.NONPOS_SIZE, flags.NONPOS_VAR, flags.NONPOS_VAR,
        flags.NONPOS_VAR, flags.NONPOS_VAR, flags.NONPOS_FLUX, flags.NONPOS_SHAPE_VAR, 0])
    assert tres["flux_flags"][2] == flags.NONPOS_SIZE
    assert tres["flux_flags"][3] == flags.NONPOS_VAR
    assert tres["T_flags"][4] == flags.NONPOS_VAR and tres["T_flags"][7] == flags.NONPOS_FLUX
    assert tres["rho4_flags"][5] == flags.NONPOS_VAR


def test_admom_conf_from_jax_fields():
    jconf = jadmom.AdmomConf(maxiter=17, shiftmax=2.5, etol=1e-6, Ttol=2e-3, cenonly=True)
    conf = convert.admom_conf_from_fields(jconf)
    assert conf == nt.AdmomConf(17, 2.5, 1e-6, 2e-3, True)
    assert convert.admom_conf_from_fields(conf._asdict()) == conf
    assert convert.admom_conf_from_fields(jadmom.AdmomConf()) == nt.AdmomConf()
    with pytest.raises(ValueError):
        convert.admom_conf_from_fields({**conf._asdict(), "bogus": 1})

"""The batched normal-equation LM of the PyTorch port
(ngmix_tpu_torch/fitting/lm.py) and its exp-model measure
(batch._exp_lm_measure) against the JAX package, in float64 on the same
numpy inputs.

Tolerances:
- bounds maps and iteration helpers: rtol 1e-12 (the same elementwise
  arithmetic), masks equal;
- the LM solver on one objective written in both frameworks: flags,
  nfev and ier equal; pars, pars_err and cost to rtol 1e-8 and atol
  1e-10, as tests/test_batch_pipeline.py:822-828 holds two
  implementations of one objective;
- the exp measure against the JAX K1 route (use_pallas=True, the TPU
  kernel in interpret mode): the same, plus s2n; both sides compute the
  same objective to ~1e-15, so a miss is a fault, not a tolerance to
  loosen;
- against the JAX AD route (its default): the tolerances of
  tests/test_pallas_lm.py:107-123, e1/e2/T/flux to rtol 1e-5 and atol
  1e-7, pars_err to rtol 1e-3, nfev within 2;
- compaction: bitwise equal to the uncompacted run
  (tests/test_pallas_lm.py:126-144).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu import batch as jbatch
from ngmix_tpu.fitting import lm as jlm

from ngmix_tpu_torch import batch as tbatch, flags
from ngmix_tpu_torch.fitting import lm as tlm

from test_torch_normal_eqs import _pixel_batch

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

INF = np.inf
# one two-sided, two one-sided and three unbounded dims
LO = np.array([-1.0, 0.0, -INF, -INF, -INF, -INF])
HI = np.array([1.0, INF, 2.0, INF, INF, INF])


def _close(out, ref, rtol=1e-12, atol=1e-300):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=atol)


def test_bounds_maps_match_jax():
    rng = np.random.RandomState(4)
    y = rng.normal(0.0, 3.0, (40, 6))
    y[:5] = [30.0, 0.0, -1e-3, 1e3, -27.0, 9.3]
    # inside the bounds, and three rows on them
    x = rng.uniform(-0.99, 0.99, (40, 6))
    x[:, 1] = np.abs(x[:, 1]) + 1e-3
    x[:, 2] = 2.0 - np.abs(x[:, 2]) - 1e-3
    x[:3, :3] = [[-1.0, 0.0, 2.0], [1.0, 0.0, 2.0], [-1.0, 5.0, -3.0]]
    lo, hi = (torch.as_tensor(a) for a in (LO, HI))
    names = ("i2e", "i2e_grad", "clip_internal", "e2i")
    refs = jax.jit(lambda y, x, lo, hi: [
        getattr(jlm, name)(x if name == "e2i" else y, lo, hi) for name in names
    ])(y, x, LO, HI)
    for name, ref in zip(names, refs):
        out = getattr(tlm, name)(torch.as_tensor(x if name == "e2i" else y), lo, hi)
        _close(out.numpy(), ref, atol=1e-12)
    # round trip through the internal coordinate
    _close(tlm.i2e(tlm.e2i(torch.as_tensor(x[5:]), lo, hi), lo, hi).numpy(), x[5:],
           rtol=1e-9, atol=1e-9)


def _helper_inputs(seed=8, B=40):
    rng = np.random.RandomState(seed)
    y = rng.normal(0.0, 1.0, (B, 6))
    # near-bound internal coordinates on the bounded dims
    y[::2, 0] = rng.choice([-12.0, 12.0, -27.6], B // 2)
    y[::3, 1] = rng.uniform(-1e-2, 1e-2, len(y[::3]))
    y[1::3, 2] = rng.uniform(-1e-2, 1e-2, len(y[1::3]))
    M = rng.normal(size=(B, 8, 6))
    JtJ = np.einsum("bri,brj->bij", M, M)
    Jtr = rng.normal(0.0, 1.0, (B, 6)) * 10.0 ** rng.uniform(-6, 2, (B, 6))
    cost = 10.0 ** rng.uniform(-2, 4, B)
    lam = 10.0 ** rng.uniform(-4, 2, B)
    return y, JtJ, Jtr, cost, lam


def test_pinned_mask_and_solve_match_jax():
    y, JtJ, Jtr, cost, lam = _helper_inputs()
    lo, hi = (torch.as_tensor(a) for a in (LO, HI))
    pinned = tlm._pinned_dims(*map(torch.as_tensor, (y, Jtr, cost)), 1e-5, lo, hi)

    @jax.jit
    def ref(y, JtJ, Jtr, cost, lam):
        pinned = jlm._pinned_dims(y, Jtr, cost, 1e-5, LO, HI)
        JtJ_m, Jtr_m = jlm._mask_normal(JtJ, Jtr, pinned)
        return pinned, JtJ_m, Jtr_m, jax.vmap(jlm._solve_damped)(JtJ_m, Jtr_m, lam)

    jpinned, jJtJ_m, jJtr_m, jdy = ref(y, JtJ, Jtr, cost, lam)
    np.testing.assert_array_equal(pinned.numpy(), np.asarray(jpinned))
    assert pinned.any() and not pinned[:, 3:].any()

    JtJ_m, Jtr_m = tlm._mask_normal(torch.as_tensor(JtJ), torch.as_tensor(Jtr), pinned)
    _close(JtJ_m.numpy(), jJtJ_m)
    _close(Jtr_m.numpy(), jJtr_m)

    dy = tlm._solve_damped(JtJ_m, Jtr_m, torch.as_tensor(lam)).numpy()
    _close(dy, jdy, rtol=1e-10, atol=1e-14)
    # pinned dims do not move
    assert np.all(dy[pinned.numpy()] == 0)


# ----------------------------------------------------------------------
# the LM solver on one small objective written in both frameworks:
# r_i = sum_k M[i, k] tanh(x_k) + 0.1 x_0 x_1 - d_i over 12 rows

NB, NR = 8, 12


def _toy_problem(seed=21):
    rng = np.random.RandomState(seed)
    M = rng.normal(size=(NB, NR, 6))
    M[5, :, 3] = 0.0  # a lane whose x_3 never enters: singular JtJ
    x_true = rng.uniform(-0.6, 0.6, (NB, 6))
    x_true[::2, 0] = 1.4  # beyond hi = 1 on the two-sided dim: pinned
    d = np.einsum("brk,bk->br", M, np.tanh(x_true))
    d = d + 0.1 * x_true[:, :1] * x_true[:, 1:2] + rng.normal(0.0, 0.01, (NB, NR))
    guess = np.clip(x_true + rng.normal(0.0, 0.2, (NB, 6)), -0.9, 0.9)
    guess[:, 1] = np.abs(guess[:, 1]) + 0.1
    return M, d, guess


def _jax_normal(x, data):
    M, d = data
    r = jnp.einsum("brk,bk->br", M, jnp.tanh(x)) + 0.1 * x[:, :1] * x[:, 1:2] - d
    J = M * (1.0 - jnp.tanh(x) ** 2)[:, None, :]
    J = J.at[:, :, 0].add(0.1 * x[:, 1:2]).at[:, :, 1].add(0.1 * x[:, :1])
    return jnp.sum(r * r, -1), jnp.einsum("bri,br->bi", J, r), jnp.einsum("bri,brj->bij", J, J)


def _torch_normal(x, data):
    M, d = data
    r = torch.einsum("brk,bk->br", M, torch.tanh(x)) + 0.1 * x[:, :1] * x[:, 1:2] - d
    J = M * (1.0 - torch.tanh(x) ** 2)[:, None, :]
    J[:, :, 0] += 0.1 * x[:, 1:2]
    J[:, :, 1] += 0.1 * x[:, :1]
    return torch.sum(r * r, -1), torch.einsum("bri,br->bi", J, r), torch.einsum("bri,brj->bij", J, J)


SOLVER_CASES = {
    "unbounded": (dict(), False),
    "bounded": (dict(), True),
    "maxfev2": (dict(maxfev=2), True),
}


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_matches_jax(case):
    kw, bounded = SOLVER_CASES[case]
    M, d, guess = _toy_problem()
    lo, hi = (LO, HI) if bounded else (np.full(6, -INF), np.full(6, INF))
    ref = jax.jit(lambda *a: jlm.run_lm_normal_batched(
        _jax_normal, a[:2], *a[2:], jlm.LMConf(**kw), nres=NR,
    ))(M, d, guess, lo, hi)
    ref = jax.tree.map(np.asarray, ref)
    for caps in (None, (6, 3)):
        out = tlm.run_lm_normal_batched(
            _torch_normal, (torch.as_tensor(M), torch.as_tensor(d)),
            torch.as_tensor(guess), torch.as_tensor(lo), torch.as_tensor(hi),
            tlm.LMConf(**kw), nres=NR, compact_capacity=caps,
        )
        out = {k: v.numpy() for k, v in out.items()}
        assert set(out) == set(ref)
        for k in ("flags", "nfev", "ier"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        for k in ("pars", "pars_err", "cost", "s_sq"):
            _close(out[k], ref[k], rtol=1e-8, atol=1e-10)
    # the singular lane and the maxfev lanes carry their flags
    assert ref["flags"][5] & flags.LM_SINGULAR_MATRIX
    if case == "maxfev2":
        assert np.all(out["nfev"] == 2)
        assert np.sum(ref["flags"] == flags.MAXITER) >= NB // 2
    else:
        assert np.sum(ref["flags"] == 0) >= NB - 1


@pytest.mark.parametrize("caps", [None, 3, (6, 3), (6, 5, 4, 3, 2)])
def test_compaction_levels_match_solver_iterations(caps):
    """compaction_levels, worked out from nfev alone, gives the
    (lanes, iterations) of each level that the solver ran"""
    M, d, guess = _toy_problem()
    steps = []
    step = tlm._lm_step

    def counted(s, *a):
        steps.append(s["y"].shape[0])
        return step(s, *a)

    with mock.patch.object(tlm, "_lm_step", counted):
        out = tlm.run_lm_normal_batched(
            _torch_normal, (torch.as_tensor(M), torch.as_tensor(d)),
            torch.as_tensor(guess), torch.as_tensor(LO), torch.as_tensor(HI),
            tlm.LMConf(), nres=NR, compact_capacity=caps,
        )
    levels = tlm.compaction_levels(out["nfev"], caps)
    ran = [(w, steps.count(w)) for w in dict.fromkeys(steps)]
    assert [lv for lv in levels if lv[1] > 0] == ran
    assert levels[0][0] == NB and sum(n for _, n in levels) == int(out["nfev"].max()) - 1


# ----------------------------------------------------------------------
# the exp measure on eight noisy 33x33 stamps

@pytest.fixture(scope="module")
def measure_inputs():
    jpix, tpix, sig, _ = _pixel_batch(nb=8, seed=23)
    return jpix, tpix, sig


@pytest.fixture(scope="module")
def port_measure(measure_inputs):
    _, tpix, sig = measure_inputs
    out = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf())
    return {k: v.numpy() for k, v in out.items()}


def _jax_measure(measure_inputs, **kw):
    jpix, _, sig = measure_inputs
    out = jax.jit(lambda: jbatch._exp_lm_measure(jpix, sig, jlm.LMConf(), **kw))()
    return jax.tree.map(np.asarray, out)


def test_measure_matches_jax_kernel_route(measure_inputs, port_measure):
    ref = _jax_measure(measure_inputs, use_pallas=True, interpret=True)
    out = port_measure
    assert set(out) == set(ref)
    for k in ("flags", "nfev", "ier"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in ("pars", "pars_err", "cost", "s2n"):
        _close(out[k], ref[k], rtol=1e-8, atol=1e-10)
    assert np.all(out["flags"] == 0)
    np.testing.assert_array_equal(out["e1"], out["pars"][:, 2])


def test_measure_matches_jax_ad_route(measure_inputs, port_measure):
    ref = _jax_measure(measure_inputs, use_pallas=False)
    out = port_measure
    np.testing.assert_array_equal(out["flags"], ref["flags"])
    for k in ("e1", "e2", "T", "flux"):
        _close(out[k], ref[k], rtol=1e-5, atol=1e-7)
    _close(out["pars_err"], ref["pars_err"], rtol=1e-3)
    assert np.all(np.abs(out["nfev"].astype(int) - ref["nfev"].astype(int)) <= 2)


def test_measure_compaction_is_bitwise_exact(measure_inputs, port_measure):
    """the host-loop route with and without compaction, and the K3
    route (its plain version on the CPU), give the same bits"""
    _, tpix, sig = measure_inputs
    cmp = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), host_loop=True,
                                 compact_capacity=3)
    full = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(), host_loop=True,
                                  compact_capacity=None)
    for k in ("pars", "flags", "nfev", "ier", "cost", "pars_err", "s2n"):
        np.testing.assert_array_equal(cmp[k].numpy(), full[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(port_measure[k], full[k].numpy(), err_msg=k)


def test_measure_unported_options_raise(measure_inputs, port_measure):
    """the LM options are ported: flux_col leaves the measure's bits as
    they are, varpro reaches the standard solve's optimum (the reference
    test's tolerance) and raises its ValueError for a bounded flux"""
    _, tpix, sig = measure_inputs
    out = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(flux_col=True))
    for k, v in port_measure.items():
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)
    vp = tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(varpro=True))
    np.testing.assert_array_equal(vp["flags"].numpy(), port_measure["flags"])
    np.testing.assert_allclose(vp["pars"].numpy(), port_measure["pars"], rtol=1e-6, atol=1e-8)
    box = ([-np.inf] * 5 + [0.0], [np.inf] * 6)
    with pytest.raises(ValueError, match="unbounded flux"):
        tbatch._exp_lm_measure(tpix, sig, tlm.LMConf(varpro=True), bounds=box)

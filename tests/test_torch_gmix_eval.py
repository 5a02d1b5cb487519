"""K2 of the PyTorch port (ngmix_tpu_torch/ops/gmix_eval.py) against the
JAX package: its plain version against eval_gmix_pallas in interpret
mode and against gmix.core.eval_gmix, on the same numpy inputs.

Tolerances: rtol 1e-12 in float64, as tests/test_misc_components.py
holds the Pallas kernel against the jnp version; in float32, rtol 1e-5
with an atol of 1e-6 times the lane's max |model| (float32 round-off
of chi2 feeds exp; the far wings sit many decades below the peak).

The CUDA kernel itself runs only on the card (chip_smoke.py); here the
wrapper's dispatch is checked with a mocked CUDA tensor and library.
"""
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngmix_tpu.gmix import core as jcore
from ngmix_tpu.ops.pallas_gmix import eval_gmix_pallas

from ngmix_tpu_torch.ops import _build, gmix_eval

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

_jnp_eval_gmix = jax.jit(jcore.eval_gmix, static_argnames=("fast",))


def _inputs(n, B=4, P=300, seed=3, dtype=np.float64, degenerate=True):
    """[B, n, 6] mixtures with a spread of sizes and shapes and [B, P]
    coordinates; lane 1 gets a gaussian with det <= 0 and T <= 0"""
    rng = np.random.RandomState(seed + n)
    p = rng.uniform(0.1, 2.0, (B, n))
    row = rng.uniform(-0.5, 0.5, (B, n))
    col = rng.uniform(-0.5, 0.5, (B, n))
    T = rng.uniform(0.05, 3.0, (B, n))
    e1 = rng.uniform(-0.4, 0.4, (B, n))
    e2 = rng.uniform(-0.4, 0.4, (B, n))
    gm = np.stack(
        [p, row, col, 0.5 * T * (1 - e1), 0.5 * T * e2, 0.5 * T * (1 + e1)],
        axis=-1,
    )
    if degenerate:
        gm[1, 0, 3:] = (-0.5, 0.6, -0.5)
    v = rng.uniform(-3.0, 3.0, (B, P))
    u = rng.uniform(-3.0, 3.0, (B, P))
    area = rng.uniform(0.05, 0.08, (B, P))
    return gm.astype(dtype), v.astype(dtype), u.astype(dtype), area.astype(dtype)


def _close(out, ref, dtype):
    out = np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.all(np.isfinite(out))
    if dtype == np.float64:
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    else:
        atol = 1e-6 * np.max(np.abs(ref), axis=-1, keepdims=True)
        assert np.all(np.abs(out - ref) <= 1e-5 * np.abs(ref) + atol)


def _plain(gm, v, u, area, fast):
    t = torch.as_tensor
    a = t(area) if np.ndim(area) else area
    return gmix_eval.eval_gmix(t(gm), t(v), t(u), a, fast=fast).numpy()


# every n and mode in float64; float32 at the sims' n = 18 (each
# interpret-mode case compiles its own program, ~2 s on the CPU)
_PALLAS_CASES = [
    (n, fast, np.float64) for n in (1, 6, 18) for fast in (True, False)
] + [(18, fast, np.float32) for fast in (True, False)]


@pytest.mark.parametrize("n,fast,dtype", _PALLAS_CASES)
def test_plain_matches_pallas_interpret(n, fast, dtype):
    gm, v, u, area = _inputs(n, dtype=dtype)
    ref = eval_gmix_pallas(
        jnp.asarray(gm), jnp.asarray(v), jnp.asarray(u), jnp.asarray(area),
        fast=fast, interpret=True,
    )
    _close(_plain(gm, v, u, area, fast), ref, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("n", [1, 6, 18])
def test_plain_matches_jnp_eval_gmix(n, fast, dtype):
    """valid mixtures: the jnp reference's validity rule agrees with the
    kernel's there; a scalar area exercises the scalar mode"""
    gm, v, u, _ = _inputs(n, dtype=dtype, degenerate=False)
    ref = _jnp_eval_gmix(
        jnp.asarray(gm), jnp.asarray(v), jnp.asarray(u), 0.069, fast=fast
    )
    _close(_plain(gm, v, u, 0.069, fast), ref, dtype)


def test_degenerate_gaussian_contributes_zero():
    gm, v, u, area = _inputs(3)
    full = _plain(gm, v, u, area, False)
    gm_wo = gm.copy()
    gm_wo[1, 0, 0] = 0.0  # the degenerate gaussian with zero flux
    np.testing.assert_array_equal(full, _plain(gm_wo, v, u, area, False))


def test_wrapper_checks_inputs():
    gm, v, u, area = (torch.as_tensor(x) for x in _inputs(3))
    with pytest.raises(ValueError):
        gmix_eval.eval_gmix(gm[:, :, :5], v, u, area)
    with pytest.raises(ValueError):
        gmix_eval.eval_gmix(gm, v[:2], u[:2], area)
    with pytest.raises(ValueError):
        gmix_eval.eval_gmix(gm, v, u, area[:, :7])
    with pytest.raises(ValueError):
        gmix_eval.eval_gmix(gm, v.T.contiguous().T, u, area)
    with pytest.raises(TypeError):
        gmix_eval.eval_gmix(gm, v.float(), u, area)
    with pytest.raises(ValueError):
        big = torch.zeros(2, gmix_eval.MAX_GAUSS + 1, 6, dtype=torch.float64)
        gmix_eval.eval_gmix(big, v[:2], u[:2], 1.0)
    with pytest.raises(RuntimeError):
        gmix_eval.eval_gmix(gm.to("meta"), v.to("meta"), u.to("meta"), 1.0)


class _FakeCuda(torch.Tensor):
    """a CPU tensor that reports a CUDA device"""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake_cuda(x):
    return torch.Tensor._make_subclass(_FakeCuda, torch.as_tensor(x))


def _mock_card(monkeypatch, ret):
    """a fake kernel library that records its calls, a card of 132 SMs
    that holds 3 blocks an SM, and a plain version that must not be
    taken"""
    calls = []

    def fake_kernel(*args):
        calls.append(args)
        return ret

    def fake_attrs(fast, n, smem, out):
        out[0], out[1], out[2], out[3] = 40, 16, smem, 3
        return 0

    lib = types.SimpleNamespace(
        ngmix_gmix_eval_f32=fake_kernel, ngmix_gmix_eval_f64=fake_kernel,
        ngmix_gmix_eval_attrs_f32=fake_attrs, ngmix_gmix_eval_attrs_f64=fake_attrs,
    )
    monkeypatch.setattr(_build, "load", lambda: lib)
    # a cache of the fake card's attributes for this test only
    monkeypatch.setattr(gmix_eval, "_attrs",
                        functools.lru_cache()(gmix_eval._attrs.__wrapped__))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda d=None: types.SimpleNamespace(multi_processor_count=132),
    )

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(gmix_eval, "eval_gmix_plain", no_plain)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda d=None: types.SimpleNamespace(cuda_stream=1234),
    )

    @contextlib.contextmanager
    def current_device(dev):
        # the launch must run with the tensors' device current
        calls.append(("device", dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", current_device)
    return calls


def _at_offset(x, k=1):
    """a copy of x whose base lies k elements into its 16-byte aligned
    buffer"""
    buf = np.empty(x.size + k, dtype=x.dtype)
    assert buf.ctypes.data % 16 == 0
    view = buf[k:].reshape(x.shape)
    view[...] = x
    return view


@pytest.mark.parametrize("area_mode", ["scalar", "tensor", "offset"])
def test_cuda_tensor_launches_kernel_never_plain(monkeypatch, area_mode):
    """the launch's arguments; "offset" hands v, u and area as views one
    element past a 16-byte boundary, which the plan takes as a head, and
    the output lies at the same offset"""
    calls = _mock_card(monkeypatch, 0)
    gm, v, u, area = _inputs(18, B=3, P=40)
    if area_mode == "offset":
        v, u, area = (_at_offset(x) for x in (v, u, area))
    gm, v, u, area = (_fake_cuda(x) for x in (gm, v, u, area))
    if area_mode == "scalar":
        area = 0.069
    monkeypatch.setattr(gmix_eval, "launches", 0)
    out = gmix_eval.eval_gmix(gm, v, u, area, fast=False)
    assert gmix_eval.launches == 1
    devices = [c[1] for c in calls if c[0] == "device"]
    (args,) = [c for c in calls if c[0] != "device"]
    assert devices and all(d == gm.device for d in devices)
    (gp, vp, up, ap, ascalar, op, B, n, P, fast,
     tile, head, ntiles, nfull, magic, shift, grid, smem, stream) = args
    assert (gp, vp, up, op) == (gm.data_ptr(), v.data_ptr(), u.data_ptr(), out.data_ptr())
    if area_mode == "scalar":
        assert ap is None and ascalar == 0.069
        inputs = [v, u]
    else:
        assert ap == area.data_ptr()
        inputs = [v, u, area]
    assert (B, n, P, fast, stream) == (3, 18, 40, 0, 1234)
    # the launch plan for these inputs, on the fake card's 132 x 3 blocks
    plan = gmix_eval.launch_plan(3, 18, 40, 8, len(inputs), gmix_eval.input_offset(inputs))
    assert (tile, head, ntiles, nfull, magic, shift, smem) == (
        plan.tile, plan.head, plan.ntiles, plan.nfull, plan.magic, plan.shift,
        plan.smem_bytes)
    assert grid == gmix_eval.grid_size(plan.ntiles, 132, 3)
    assert head == (1 if area_mode == "offset" else 0)
    assert op % 16 == vp % 16


def test_cuda_launch_error_raises(monkeypatch):
    _mock_card(monkeypatch, 700)
    gm, v, u, area = (_fake_cuda(x) for x in _inputs(1, B=2, P=10))
    monkeypatch.setattr(gmix_eval, "launches", 0)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        gmix_eval.eval_gmix(gm, v, u, area, fast=True)
    assert gmix_eval.launches == 0

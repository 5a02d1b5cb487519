"""Fault 3.4 of ROADMAP.md: do float32 bd-lm fits on exp truth stop early
in the JAX package's LM as they do in the port's?

    python scripts/fault34_f32_stops.py [--n 2048] [--seed 314]

Makes sims.make_sim_batch(torch.Generator().manual_seed(seed), n) (exp
galaxies), runs the port's metacal engine and captures the solve inputs
of its bd-lm measure under sims.BD_LM_BOUNDS (5 n lanes), and solves
every lane with the port's plain LM (fitting.lm.run_lm_normal_state over
batch._exp_normal_fn with K1's plain version, the compaction cascade,
which gives each lane the bits of K3's plain version) in float32 and in
float64. The lanes whose float32 e1, e2, T or flux end farther than half
the float64 pars_err from the float64 optimum are the early stops. Then
the JAX package's float32 LM (run_lm_normal_batched over its AD normal
equations of fill_bd, the route its bd-lm takes) solves the same float32
inputs of every lane, and the script counts its early stops against the
same optimum: on all lanes, and on the port's early-stop lanes. Runs on
the CPU; JAX runs in float32 (x64 off). Prints one JSON line.
"""
import argparse
import json
import time

import numpy as np
import torch

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import batch as tbatch
from ngmix_tpu_torch.fitting import lm as tlm
from ngmix_tpu_torch.ops import lm_solve

KEYS = ("e1", "e2", "T", "flux")


class _Captured(Exception):
    pass


def solve_inputs(n, seed):
    """the float32 inputs (guess, lo, hi, psf, v, u, ia, ve) of the bd-lm
    measure's solve, and its pixels (v, u, area, val, ierr)"""
    sims = nt.make_sim_batch(torch.Generator().manual_seed(seed), n, torch.float32, "cpu")
    seen = {}
    planes = tbatch._lm_planes

    def planes_spy(pixels):
        seen["pixels"] = pixels
        return planes(pixels)

    def solve_spy(*a):
        seen["args"] = a[:8]
        raise _Captured

    fn = nt.make_metacal_pipeline_fn(nt.sims.METACAL_EXP_LM_CONFIG, measure="bd-lm",
                                     lm_bounds=nt.sims.BD_LM_BOUNDS, device="cpu",
                                     max_chunk=None)
    orig = (tbatch._lm_planes, lm_solve.lm_solve)
    tbatch._lm_planes, lm_solve.lm_solve = planes_spy, solve_spy
    try:
        fn(*sims)
    except _Captured:
        pass
    finally:
        tbatch._lm_planes, lm_solve.lm_solve = orig
    return seen["args"], seen["pixels"]


def port_solve(args):
    """the port's plain LM of the bd model on args, through the
    compaction cascade: e1, e2, T, flux, their pars_err, flags, nfev"""
    guess, lo, hi, psf, v, u, ia, ve = args
    conf = tlm.LMConf()

    def normal_fn(pars, data):
        return tbatch._exp_normal_fn(pars, *data, plain=True, model="bd")

    B = guess.shape[0]
    state = tlm.run_lm_normal_state(normal_fn, ((v, u, ia, ve), tbatch._psf_gmix(psf)), guess,
                                    lo, hi, conf, compact_capacity=tbatch._auto_cascade(B))
    return columns(tlm._normal_epilogue(state, lo, hi, conf, torch.sum(ia > 0, dim=-1)))


def columns(out):
    pars = torch.as_tensor(np.array(out["pars"]))
    err = torch.as_tensor(np.array(out["pars_err"]))
    idx = [2, 3, 4, pars.shape[1] - 1]
    return dict(zip(KEYS, pars[:, idx].double().unbind(-1)), err=err[:, idx].double(),
                flags=torch.as_tensor(np.array(out["flags"])),
                nfev=torch.as_tensor(np.array(out["nfev"])))


def beyond(a, opt):
    """per lane: unflagged in both, and the largest distance of a's keys
    from opt's in opt's pars_err"""
    d = torch.stack([(a[k] - opt[k]).abs() / opt["err"][:, i] for i, k in enumerate(KEYS)],
                    -1).max(-1).values
    ok = (a["flags"] == 0) & (opt["flags"] == 0)
    return ok, torch.where(ok, d, torch.zeros_like(d))


def jax_solve(args, pixels):
    """the JAX package's float32 LM of the bd model (its AD normal
    equations, the compaction cascade) on the same inputs"""
    import jax
    import jax.numpy as jnp

    from ngmix_tpu import batch as jbatch
    from ngmix_tpu.fitting import lm as jlm
    from ngmix_tpu.gmix import core as jcore
    from ngmix_tpu.pixels import Pixels as JPixels

    guess, lo, hi, psf = (np.asarray(x, dtype=np.float32) for x in args[:4])
    px = JPixels(*(jnp.asarray(np.asarray(getattr(pixels, f), dtype=np.float32))
                   for f in ("v", "u", "area", "val", "ierr")))
    psf_gmix = jnp.asarray(tbatch._psf_gmix(torch.as_tensor(psf)).numpy())
    normal_fn = jbatch._make_ad_normal_fn(jcore.fill_bd)
    B = guess.shape[0]
    run = jax.jit(lambda g, d: jlm.run_lm_normal_batched(
        normal_fn, d, g, jnp.asarray(lo), jnp.asarray(hi), jlm.LMConf(),
        nres=jnp.sum(d[0].ierr > 0, axis=-1), compact_capacity=jbatch._auto_cascade(B)))
    out = jax.tree.map(np.asarray, run(jnp.asarray(guess), (px, psf_gmix)))
    return columns(out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=314)
    a = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.time()
    args, pixels = solve_inputs(a.n, a.seed)
    p32 = port_solve(args)
    p64 = port_solve(tuple(x.double() for x in args))
    ok, d_port = beyond(p32, p64)
    early = ok & (d_port > 0.5)
    t1 = time.time()
    j32 = jax_solve(args, pixels)
    jok, d_jax = beyond(j32, p64)
    jearly = jok & (d_jax > 0.5)
    both = early & jearly
    print(json.dumps(dict(
        n_stamps=a.n, seed=a.seed, lanes=int(ok.numel()),
        port_f32_unflagged=int(ok.sum()), port_f32_early=int(early.sum()),
        port_f32_max_pars_err=float(d_port.max()),
        jax_f32_unflagged=int(jok.sum()), jax_f32_early=int(jearly.sum()),
        jax_f32_max_pars_err=float(d_jax.max()),
        jax_f32_early_on_port_early_lanes=int(both.sum()),
        jax_on_port_early_lanes_pars_err=[round(float(x), 4) for x in d_jax[early]][:64],
        port_early_lanes_pars_err=[round(float(x), 4) for x in d_port[early]][:64],
        port_nfev_mean=float(p32["nfev"].double().mean()),
        jax_nfev_mean=float(j32["nfev"].double().mean()),
        flags_differ_port_jax=int((p32["flags"] != j32["flags"]).sum()),
        port_f32_flags={int(k): int(v) for k, v in zip(*np.unique(p32["flags"].numpy(),
                                                                  return_counts=True))},
        jax_f32_flags={int(k): int(v) for k, v in zip(*np.unique(j32["flags"].numpy(),
                                                                 return_counts=True))},
        port_f64_flags={int(k): int(v) for k, v in zip(*np.unique(p64["flags"].numpy(),
                                                                  return_counts=True))},
        port_seconds=round(t1 - t0, 1), jax_seconds=round(time.time() - t1, 1))))


if __name__ == "__main__":
    main()

"""Time K3 and K3-mb with a FlatPrior table against the same table with
LMBounds slots, on the inputs of chip_smoke.py's phase 23, on one CUDA
card.

    python scripts/time_prior_kinds.py [--rounds 9] [--calls 5]

Builds the kernels, makes phase 23's sims (exp seed 314, B = 10240; the
mb bdf-truth sims seed 271, 2048 objects x 3 epochs, nband 2),
captures the exp-lm and mb bdf-lm solve inputs under phase 23's boxes,
and then, in each of ``--rounds`` rounds, times every table on them
with chip_smoke.time_ms (``--calls`` calls after 2) in turn: no prior,
the FlatPrior table (chip_smoke.exp_prior, bdf_prior) and the same
prior with LMBounds slots (chip_smoke.lmbounds_prior). Prints one JSON
line: each table's median, lowest and highest ms, its nfev sum, and
whether the per-lane nfev and results of the two prior tables are
bitwise equal.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ngmix_tpu_torch as nt  # noqa: E402
from ngmix_tpu_torch.ops import _build, lm_solve  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--calls", type=int, default=5)
    a = ap.parse_args()
    _build.build()
    dev = "cuda"
    conf = nt.LMConf()

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    hom = nt.make_sim_batch(gen(314), cs.B_MAIN, torch.float32, device=dev)
    truth_mb = nt.make_sim_batch_mb(gen(271), cs.B_MB, torch.float32, device=dev,
                                    hetero=True, gal_model="bdf")
    nb = nt.sims.MB_NBAND
    exp_fn = nt.make_metacal_pipeline_fn(cs.LM_CONF, measure="exp-lm", lm_prior=cs.exp_prior(),
                                         lm_bounds=cs.BOX, device=dev)
    mb_fn = nt.make_metacal_pipeline_mb_fn(cs.MB_CONF, nt.sims.MB_BAND, nb, measure="bdf-lm",
                                           lm_prior=cs.bdf_prior(nb),
                                           lm_bounds=cs.mb_box(nt.sims.BDF_LM_BOUNDS, nb),
                                           device=dev)
    exp_args = cs.capture_solve(exp_fn, *hom)[0]
    mb_args = cs.capture_solve(mb_fn, *truth_mb, mb=True)[0]
    cases = {
        "K3 exp": (lambda p: lm_solve.lm_solve(*exp_args, conf, "exp", p),
                   {"none": None, "flat": cs.exp_prior(), "lmbounds": cs.lmbounds_prior("exp")}),
        "K3-mb bdf": (lambda p: lm_solve.lm_solve_mb(*mb_args, conf, "bdf", p),
                      {"none": None, "flat": cs.bdf_prior(nb),
                       "lmbounds": cs.lmbounds_prior("bdf", nb)}),
    }
    out = {"card": cs.card_line(), "rounds": a.rounds, "calls": a.calls}
    for name, (solve, priors) in cases.items():
        states = {k: solve(p) for k, p in priors.items()}
        torch.cuda.synchronize()
        ms = {k: [] for k in priors}
        for _ in range(a.rounds):
            for k, p in priors.items():
                ms[k].append(cs.time_ms(lambda: solve(p), a.calls))
        f, lb = states["flat"], states["lmbounds"]
        out[name] = {
            k: {"median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v),
                "nfev_sum": int(states[k]["nfev"].sum())} for k, v in ms.items()}
        out[name]["prior tables equal"] = {
            "nfev": bool(torch.equal(f["nfev"], lb["nfev"])),
            "y": bool(torch.equal(f["y"], lb["y"])),
            "lanes": int(f["nfev"].numel())}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""A short card check of K3's and K3-mb's prior rows, for a first call
after a kernel change.

    python scripts/prior_kernel_check.py

Run from the root of a checkout on one CUDA card (NB=64 stamps by
default, env NB). Builds the kernels with `-Xptxas -v` and prints each
float32 instance's registers and spills (REG lines) and the build time,
then holds K3 (exp, and bdf on the bdf-truth and the exp sims) and
K3-mb (bdf, nband 2) with and without the phase 23 priors of
chip_smoke.py to their plain versions in float64 and float32 (flags,
nfev, the largest relative and pars_err differences, cost_pix), and
prints the kernels' attributes.
"""
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")

import chip_smoke as cs  # noqa: E402
import ngmix_tpu_torch as nt  # noqa: E402
from ngmix_tpu_torch.ops import _build, lm_solve  # noqa: E402

TIMES = {}


def run_all(cmds, deadline):
    """_build._run_all with each source's time and ptxas report"""
    t0 = time.time()
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)) for c in cmds]
    for cmd, proc in procs:
        out = proc.communicate()[0]
        src = cmd[-1].split("/")[-1]
        TIMES[src] = round(time.time() - t0, 1)
        if proc.returncode:
            print(out[-8000:])
            raise SystemExit("nvcc failed")
        if "lm_solve" not in src:
            continue
        fn, prev = None, ""
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and "IfNS" in fn:
                spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                  r"(\d+) bytes spill loads", prev)
                print("REG", src, fn[-60:], m.group(1), spill.groups() if spill else "",
                      flush=True)
            prev = line


def report(tag, a, b, keys):
    flags = int((a["flags"] != b["flags"]).sum())
    dnfev = int((a["nfev"] - b["nfev"]).abs().max())
    rel = max(float(((a[k].double() - b[k].double()).abs()
                     / b[k].double().abs().clamp_min(1e-30)).max()) for k in keys)
    _, in_err = cs.f32_split(a, b, keys)
    print(tag, "flags diff", flags, "nfev diff", dnfev, "max rel %.3e" % rel,
          "in_err %.3e" % in_err, "flagged", int((a["flags"] != 0).sum()),
          "nfev mean %.2f" % float(a["nfev"].double().mean()), flush=True)


def main():
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-Xptxas", "-v")
    _build._run_all = run_all
    t0 = time.time()
    _build.build()
    print("BUILD total %.1f s" % (time.time() - t0), TIMES, flush=True)
    _build.load()

    dev = "cuda"
    nb = int(os.environ.get("NB", 64))
    conf = nt.LMConf()

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    hom = nt.make_sim_batch(gen(314), nb, torch.float32, device=dev)
    het = nt.make_sim_batch_hetero(gen(271), nb, torch.float32, device=dev, gal_model="bdf")
    for model, sims, name in (("exp", hom, "hom"), ("bdf", het, "het"), ("bdf", hom, "hom")):
        make, box, _ = cs.PRIOR_FITS[model]
        for dt in (torch.float64, torch.float32):
            for prior in (make(), None):
                fn = nt.make_metacal_pipeline_fn(cs.LM_CONF, measure=model + "-lm",
                                                 lm_prior=prior, lm_bounds=box, device=dev)
                args, pr, _ = cs.capture_solve(fn, *[a.to(dt) for a in sims])
                st = lm_solve.lm_solve(*args, conf, model, pr)
                pl = lm_solve.lm_solve_plain(*args, conf, model, pr)
                tag = "K3 %s %s %s prior=%s" % (model, name, dt, prior is not None)
                report(tag, cs.solve_columns(st, args, conf), cs.solve_columns(pl, args, conf),
                       ("e1", "e2", "T", "flux"))
                if prior is not None:
                    print("   cost_pix lanes", cs.check_cost_pix(st, args, pr, tag), flush=True)
    mb = nt.make_sim_batch_mb(gen(9), nb, torch.float32, device=dev, hetero=True,
                              gal_model="bdf")
    box = cs.mb_box(nt.sims.BDF_LM_BOUNDS, 2)
    for dt in (torch.float64, torch.float32):
        for prior in (cs.bdf_prior(2), None):
            fn = nt.make_metacal_pipeline_mb_fn(cs.MB_CONF, nt.sims.MB_BAND, 2, measure="bdf-lm",
                                                lm_prior=prior, lm_bounds=box, device=dev)
            args, pr, _ = cs.capture_solve(fn, *[x.to(dt) for x in mb], mb=True)
            st = lm_solve.lm_solve_mb(*args, conf, "bdf", pr)
            pl = lm_solve.lm_solve_mb_plain(*args, conf, "bdf", pr)
            tag = "K3-mb bdf %s prior=%s" % (dt, prior is not None)
            report(tag, cs.mb_cols(cs._epilogue_mb(st, args, conf)),
                   cs.mb_cols(cs._epilogue_mb(pl, args, conf)), cs.MB_KEYS)
            if prior is not None:
                print("   cost_pix lanes", cs.check_cost_pix(st, args, pr, tag), flush=True)
    for model in ("bdf", "bd"):
        print("   K3-mb local bytes at nband 1-6", model,
              [lm_solve.kernel_attrs_mb(torch.float32, n, 3, 361, model)["local_bytes"]
               for n in range(1, 7)], flush=True)
    for model in lm_solve.MODELS:
        print("   K3 attrs", model, lm_solve.kernel_attrs(torch.float32, 361, model), flush=True)
    print("DONE")


if __name__ == "__main__":
    main()

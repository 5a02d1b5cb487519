"""Time K3, K3-mb and K3's options kernel at the main paths' shapes, for
one checkout of the port, on one CUDA card.

    python scripts/time_lm_kernels.py DIR [--rows NAME,...] [--out FILE]

DIR holds a checkout's chip_smoke.py and ngmix_tpu_torch/ (the library
is built in DIR/build/ unless it is there). The script makes the sims
of chip_smoke.py's phases 13 and 21-24 (exp sims seed 314, bdf-truth
sims seed 271, B = 10240; the mb bdf-truth sims, 2048 objects x 3
epochs in 2 bands), captures each LM measure's solve inputs and times
every row with chip_smoke.time_ms (10 calls after 2):

- K3: exp, gauss, dev (exp sims), bdf and bd (bdf-truth sims in their
  boxes), each with and without its prior where chip_smoke has one
  (exp: the reference test's PriorSimpleSep; bdf: the production
  PriorBDFSep);
- K3-mb: exp, gauss, bdf and bd at nband 2 (E = 3, bands 0, 0, 1; bdf
  also with PriorBDFSep), and bdf and bd at nband 6 (each object's three epochs
  twice over, one band an epoch: E = 6, the planes past shared memory);
- the options kernel: refine (3 steps) of exp and bdf on the sheared
  types, varpro of exp, from phase 24's pipelines;
- where the solvers take at_floor (the host fitters' stop at the cost
  floor), the composite rows and K3-mb's exp and gauss rows again with
  it on (a checkout without the option always stops so).

Each row prints its time (ms), its evaluations (the nfev sum of one
call), ms per 10^5 evaluations, a digest of its outputs (y, nfev, lam,
the flags) that two checkouts compare bitwise, and the kernel's
registers a thread, local bytes a thread (spills included) and blocks
an SM (the kernel_attrs functions, which read the occupancy API). One
JSON object a line as each row ends, then one line of all rows, with
the card's name and power limit. To compare two commits, unpack the
parent with `git archive` into a directory that .gitignore lists and
run parent, change, change, parent in one call to the card.
"""
import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from unittest import mock


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def digest(state):
    h = hashlib.sha256()
    for k in ("y", "nfev", "lam", "done", "ier_small_step", "ier_small_cost", "pinned"):
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dir")
    ap.add_argument("--rows", default=None, help="comma-separated row names (default all)")
    ap.add_argument("--out", default=None, help="also append the rows' JSON lines to FILE")
    ap.add_argument("--device", default="cuda", help="cpu rehearses the script (plain versions)")
    opts = ap.parse_args()
    sys.path.insert(0, opts.dir)

    import torch

    import chip_smoke as cs
    import ngmix_tpu_torch as nt
    from ngmix_tpu_torch.fitting import lm as tlm
    from ngmix_tpu_torch.ops import _build, lm_solve

    t0 = time.time()
    if opts.device == "cuda":
        _build.build()
    head = {"dir": opts.dir, "card": card() if opts.device == "cuda" else "cpu",
            "build_s": round(time.time() - t0, 1)}
    print(json.dumps(head), flush=True)
    dev = opts.device
    conf = tlm.LMConf()
    has_floor = "at_floor" in inspect.signature(lm_solve.lm_solve).parameters
    want = None if opts.rows is None else set(opts.rows.split(","))

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    hom = nt.make_sim_batch(gen(314), cs.B_MAIN, torch.float32, device=dev)
    truth = nt.make_sim_batch_hetero(gen(271), cs.B_MAIN, torch.float32, device=dev,
                                     gal_model="bdf")
    boxes = {"bdf": nt.sims.BDF_LM_BOUNDS, "bd": nt.sims.BD_LM_BOUNDS}
    flat = {}
    for model in ("exp", "gauss", "dev", "bdf", "bd"):
        box = boxes.get(model)
        kw = {} if box is None else dict(lm_bounds=box)
        flat[model] = cs.capture_k3_inputs(truth if box else hom, dev, measure=model + "-lm",
                                           **kw)[0]
    priors = {"exp": cs.exp_prior(), "bdf": cs.bdf_prior()}

    mb = nt.make_sim_batch_mb(gen(271), cs.B_MB, torch.float32, device=dev, hetero=True,
                              gal_model="bdf")
    mb_args = {}
    for model in ("exp", "gauss", "bdf", "bd"):
        box = boxes.get(model)
        fn = nt.make_metacal_pipeline_mb_fn(
            cs.MB_CONF, nt.sims.MB_BAND, nt.sims.MB_NBAND, measure=model + "-lm",
            lm_bounds=None if box is None else cs.mb_box(box, nt.sims.MB_NBAND), device=dev)
        mb_args[model] = cs.capture_mb_inputs(fn, *mb)[0]["k3mb"]
    del mb

    def six_bands(model):
        """the nband-2 inputs as six bands of one epoch each: each
        object's three epochs twice over, the flux guesses of its bands
        repeated"""
        guess, lo, hi, psf, band, v, u, ia, ve = mb_args[model]
        ns = guess.shape[1] - nt.sims.MB_NBAND
        band6 = torch.arange(6, dtype=torch.int32, device=dev)
        fl = guess[:, ns:]
        g6 = torch.cat([guess[:, :ns], fl[:, [0, 0, 1, 0, 0, 1]]], 1).contiguous()
        lo6 = torch.cat([lo[:ns], lo[ns:ns + 1].expand(6)]).contiguous()
        hi6 = torch.cat([hi[:ns], hi[ns:ns + 1].expand(6)]).contiguous()
        tile = [x.repeat(1, 2, 1).contiguous() for x in (psf, v, u, ia, ve)]
        return (g6, lo6, hi6, tile[0], band6) + tuple(tile[1:])

    options = {}
    for name, (measure, box, pconf, lm_conf) in cs.OPTION_RUNS.items():
        fn = nt.make_metacal_pipeline_fn(pconf, measure=measure, lm_bounds=box, lm_conf=lm_conf,
                                         device=dev)
        seen = {}
        solve = lm_solve.lm_solve

        def spy(*a, **kw):
            seen["call"] = (a, kw)
            return solve(*a, **kw)

        with mock.patch.object(lm_solve, "lm_solve", spy):
            fn(*hom)
        options[name] = seen["call"]
    del hom, truth

    rows = []

    def k3_row(model, args, prior=None, **kw):
        return (lambda: lm_solve.lm_solve(*args, conf, model, prior, **kw),
                lambda: lm_solve.kernel_attrs(torch.float32, args[4].shape[1], model))

    def mb_row(model, args, prior=None, **kw):
        E, P = args[5].shape[1:]
        nband = args[0].shape[1] - (len(boxes[model][0]) - 1 if model in boxes else 5)
        return (lambda: lm_solve.lm_solve_mb(*args, conf, model, prior, **kw),
                lambda: lm_solve.kernel_attrs_mb(torch.float32, nband, E, P, model))

    def opt_row(name):
        a, kw = options[name]
        model = a[9] if len(a) > 9 else kw.get("model", "exp")
        return (lambda: lm_solve.lm_solve(*a, **kw),
                lambda: lm_solve.kernel_attrs_opt(torch.float32, a[4].shape[1], model))

    table = [("k3 exp", k3_row("exp", flat["exp"])),
             ("k3 gauss", k3_row("gauss", flat["gauss"])),
             ("k3 dev", k3_row("dev", flat["dev"])),
             ("k3 bdf", k3_row("bdf", flat["bdf"])),
             ("k3 bd", k3_row("bd", flat["bd"])),
             ("k3 exp prior", k3_row("exp", flat["exp"], priors["exp"])),
             ("k3 bdf prior", k3_row("bdf", flat["bdf"], priors["bdf"])),
             ("k3mb exp nb2", mb_row("exp", mb_args["exp"])),
             ("k3mb gauss nb2", mb_row("gauss", mb_args["gauss"])),
             ("k3mb bdf nb2", mb_row("bdf", mb_args["bdf"])),
             ("k3mb bd nb2", mb_row("bd", mb_args["bd"])),
             ("k3mb bdf nb2 prior", mb_row("bdf", mb_args["bdf"], cs.bdf_prior(2))),
             ("k3mb bdf nb6", mb_row("bdf", six_bands("bdf"))),
             ("k3mb bd nb6", mb_row("bd", six_bands("bd"))),
             ("opt refine exp", opt_row("exp-lm refine")),
             ("opt refine bdf", opt_row("bdf-lm refine")),
             ("opt varpro exp", opt_row("exp-lm varpro"))]
    if has_floor:
        on = dict(at_floor=True)
        table += [("k3 bdf at_floor", k3_row("bdf", flat["bdf"], **on)),
                  ("k3 bd at_floor", k3_row("bd", flat["bd"], **on)),
                  ("k3 bdf prior at_floor", k3_row("bdf", flat["bdf"], priors["bdf"], **on)),
                  ("k3mb bdf nb2 at_floor", mb_row("bdf", mb_args["bdf"], **on)),
                  ("k3mb bd nb2 at_floor", mb_row("bd", mb_args["bd"], **on)),
                  ("k3mb exp nb2 at_floor", mb_row("exp", mb_args["exp"], **on)),
                  ("k3mb gauss nb2 at_floor", mb_row("gauss", mb_args["gauss"], **on))]
    for name, (call, attrs) in table:
        if want is not None and name not in want:
            continue
        state = call()
        cs._sync(dev)
        nfev = int(state["nfev"].long().sum())
        ms = cs.time_ms(call, 10)
        a = attrs()
        row = {"row": name, "ms": round(ms, 4), "evaluations": nfev,
               "ms_per_1e5_evals": round(ms * 1e5 / nfev, 4), "digest": digest(state),
               "regs": a["regs"], "local_bytes": a["local_bytes"],
               "blocks_per_sm": a["blocks_per_sm"], "smem": a["dynamic_smem"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if opts.out:
            with open(opts.out, "a") as f:
                f.write(json.dumps(dict(row, dir=opts.dir, card=head["card"])) + "\n")
    print(json.dumps(dict(head, rows=rows)), flush=True)


if __name__ == "__main__":
    main()

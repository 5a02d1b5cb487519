"""Time K3 and K3-mb without a prior at the main paths' shapes, for one
checkout of the port, on one CUDA card.

    python scripts/time_lm_kernels.py DIR

DIR holds a checkout's chip_smoke.py and ngmix_tpu_torch/ (the library
is built in DIR/build/). The script builds the kernels (the build time
is printed), makes the sims of chip_smoke.py's phases 13, 21 and 22
(exp sims seed 314, bdf-truth sims seed 271, B = 10240; the mb bdf-truth
sims, 2048 objects x 3 epochs), captures each LM measure's solve inputs
and times the solve with chip_smoke.time_ms (10 calls after 2). Prints
one JSON line: ms by model, and K3's registers and local bytes. To
compare two commits, unpack the parent with `git archive` into a
directory that .gitignore lists and run parent, change, change, parent
in one call to the card.
"""
import json
import sys
import time

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ngmix_tpu_torch as nt  # noqa: E402
from ngmix_tpu_torch.ops import _build, lm_solve  # noqa: E402


def main():
    t0 = time.time()
    _build.build()
    out = {"dir": sys.argv[1], "build_s": round(time.time() - t0, 1)}
    _build.load()
    dev = "cuda"
    conf = nt.LMConf()

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    hom = nt.make_sim_batch(gen(314), 10240, torch.float32, device=dev)
    truth = nt.make_sim_batch_hetero(gen(271), 10240, torch.float32, device=dev,
                                     gal_model="bdf")
    cases = {"exp": (hom, None), "dev": (hom, None), "bdf": (truth, nt.sims.BDF_LM_BOUNDS),
             "bd": (truth, nt.sims.BD_LM_BOUNDS)}
    for model, (sims, box) in cases.items():
        kw = {} if box is None else dict(lm_bounds=box)
        args, _ = cs.capture_k3_inputs(sims, dev, measure=model + "-lm", **kw)
        out[model] = round(cs.time_ms(lambda: lm_solve.lm_solve(*args, conf, model), 10), 4)
        attrs = lm_solve.kernel_attrs(torch.float32, 361, model)
        out[model + "_regs_local"] = (attrs["regs"], attrs["local_bytes"])
    mb = nt.make_sim_batch_mb(gen(271), 2048, torch.float32, device=dev, hetero=True,
                              gal_model="bdf")
    for model, box in (("exp", None), ("bdf", cs.mb_box(nt.sims.BDF_LM_BOUNDS, 2))):
        fn = nt.make_metacal_pipeline_mb_fn(cs.MB_CONF, nt.sims.MB_BAND, 2,
                                            measure=model + "-lm", lm_bounds=box, device=dev)
        a = cs.capture_mb_inputs(fn, *mb)[0]["k3mb"]
        out["mb_" + model] = round(
            cs.time_ms(lambda: lm_solve.lm_solve_mb(*a, conf, model), 10), 4)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

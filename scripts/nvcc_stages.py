"""The port's kernel build split by nvcc stage, on a host with nvcc.

    python scripts/nvcc_stages.py [--out chiprun_out/nvcc_stages.json]
        [--variants UNIT] [--extra "FLAGS"] [--ptxas] [--install]

Compiles every ``ngmix_tpu_torch/csrc/*.cu`` as ``ops/_build.py`` does
(its flags, then ``--extra``'s; its order; one process a core) with
``nvcc --time``, and prints each unit's CPU seconds (user + system of nvcc and its children)
beside the milliseconds of each stage nvcc reports (the front end
``cudafe++``, ``cicc``, ``ptxas``, ``fatbinary`` and the host
compiler), then the stages summed over the units. With ``--variants``
it also compiles UNIT under a few extra flag sets, all at once, so
that their CPU seconds compare. With ``--ptxas`` every compile runs
with ``-Xptxas -v`` (which changes no code), and each kernel instance's
registers a thread, stack frame and spill bytes are printed and kept.
With ``--install`` (and no ``--extra``) the objects are linked and put
where ``_build.load()`` finds them, so a program run after it in the
same checkout does not build again. Writes everything as JSON to
``--out``. Builds into a temporary directory; loads nothing.
"""
import argparse
import csv
import json
import re
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from ngmix_tpu_torch.ops import _build  # noqa: E402

VARIANTS = {
    "as built": [],
    "host -O0": ["-Xcompiler", "-O0"],
    "ptxas -O2": ["-Xptxas", "-O2"],
    "cicc -O2": ["-Xcicc", "-O2"],
}


def read_times(path):
    """{stage: ms} from an ``nvcc --time`` CSV"""
    out = defaultdict(float)
    with open(path) as f:
        rows = [[c.strip() for c in r] for r in csv.reader(f) if r]
    if not rows:
        return {}
    head = [h.lower() for h in rows[0]]
    name = head.index("phase name") if "phase name" in head else 1
    metric = head.index("metric") if "metric" in head else -2
    for r in rows[1:]:
        try:
            out[r[name]] += float(r[metric])
        except (ValueError, IndexError):
            continue
    return dict(out)


def read_ptxas(path):
    """{kernel: {regs, stack, spill_stores, spill_loads}} from the -Xptxas
    -v output in path, the kernels' names demangled where c++filt is
    there"""
    out, name = {}, None
    for line in Path(path).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["regs"] = int(m.group(1))
    if out and shutil.which("c++filt"):
        names = list(out)
        dem = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True).stdout.splitlines()
        if len(dem) == len(names):
            out = {short(d): out[n] for n, d in zip(names, dem)}
    return out


def short(name):
    """a demangled kernel instance without its namespaces and argument
    list: lm_solve_kernel<float, BdModel, true>"""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.sub(r"\(.*\)$", "", name).replace("CompositeModel<1>", "BdfModel").replace(
        "CompositeModel<2>", "BdModel")


def compile_all(cmds, slots):
    """runs cmds through the build's own scheduler (``_build._run_all``),
    at most ``slots`` at a time; each one's CPU seconds and wall seconds"""
    t0, t1 = {}, {}
    cpu = _build._run_all(cmds, time.monotonic() + _build.BUILD_TIMEOUT_S, slots,
                          on_done=lambda k, _: t1.__setitem__(k, time.monotonic()),
                          on_start=lambda k: t0.__setitem__(k, time.monotonic()))
    return [(cpu[i], t1[i] - t0[i]) for i in range(len(cmds))]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/nvcc_stages.json")
    ap.add_argument("--variants", default=None, help="a csrc/*.cu name to compile alone "
                    "under the VARIANTS flag sets")
    ap.add_argument("--extra", default="", help="flags added to every compile")
    ap.add_argument("--ptxas", action="store_true", help="each kernel's registers and spills")
    ap.add_argument("--install", action="store_true", help="link the build where "
                    "_build.load() finds it")
    a = ap.parse_args()
    extra = a.extra.split()
    if a.install and extra:
        raise SystemExit("--install builds the library as _build does: no --extra flags")
    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    print(version.strip().splitlines()[-1])
    tmp = Path(tempfile.mkdtemp())
    srcs = _build.sources()
    order = sorted(srcs, key=lambda s: -_build.UNIT_CPU_SECONDS.get(s.name, 1e9))
    cmds = [[nvcc, *_build.NVCC_FLAGS, *extra, "--time", str(tmp / (s.stem + ".csv")), "-c", "-o",
             str(tmp / (s.stem + ".o")), str(s)] for s in order]
    if a.ptxas:
        # each compile's ptxas report into <unit>.ptxas
        cmds = [["sh", "-c", "%s 2> %s" % (shlex.join(c[:1] + ["-Xptxas", "-v"] + c[1:]),
                                             shlex.quote(str(tmp / (s.stem + ".ptxas"))))]
                for c, s in zip(cmds, order)]
    t0 = time.time()
    res = compile_all(cmds, _build._slots())
    wall = time.time() - t0
    units, total = {}, defaultdict(float)
    for s, (cpu, w) in zip(order, res):
        st = read_times(tmp / (s.stem + ".csv"))
        units[s.name] = {"cpu_s": cpu, "wall_s": w, "stages_ms": st}
        for k, v in st.items():
            total[k] += v
    print("build: %d units on %d cores, wall %.1f s, nvcc CPU %.1f s"
          % (len(srcs), _build._slots(), wall, sum(u["cpu_s"] for u in units.values())))
    for name, u in units.items():
        print("  %-26s cpu %6.1f s wall %6.1f s  %s" % (
            name, u["cpu_s"], u["wall_s"],
            ", ".join("%s %.1f" % (k, v / 1e3) for k, v in sorted(
                u["stages_ms"].items(), key=lambda x: -x[1]) if v >= 50)))
    print("stages summed (s): " + ", ".join("%s %.1f" % (k, v / 1e3) for k, v in sorted(
        total.items(), key=lambda x: -x[1])))
    if a.ptxas:
        for s in order:
            kernels = read_ptxas(tmp / (s.stem + ".ptxas"))
            units[s.name]["ptxas"] = kernels
            for k, v in sorted(kernels.items()):
                print("  %s: %s regs, %s bytes stack, spill %s/%s bytes" % (
                    k, v.get("regs"), v.get("stack"), v.get("spill_stores"),
                    v.get("spill_loads")))
    if a.install:
        _, links = _build.nvcc_commands(tmp, nvcc)
        _build._run_all(links, time.monotonic() + _build.BUILD_TIMEOUT_S, _build._slots())
        dest = _build.library_path()
        dest.mkdir(parents=True, exist_ok=True)
        for s in srcs:
            shutil.copy2(tmp / (s.stem + ".so"), dest / (s.stem + ".so"))
        print("installed in %s" % dest)
    out = {"nvcc": version.strip().splitlines()[-1], "extra": extra, "slots": _build._slots(),
           "wall_s": wall,
           "units": units, "stages_ms": dict(total)}
    if a.variants:
        src = _build.CSRC / a.variants
        out["variants"] = {}
        names = list(VARIANTS)
        cmds = [[nvcc, *_build.NVCC_FLAGS, *VARIANTS[n], "--time", str(tmp / ("v%d.csv" % i)),
                 "-c", "-o", str(tmp / ("v%d.o" % i)), str(src)] for i, n in enumerate(names)]
        for i, (name, (cpu, w)) in enumerate(zip(names, compile_all(cmds, len(cmds)))):
            st = read_times(tmp / ("v%d.csv" % i))
            out["variants"][name] = {"cpu_s": cpu, "stages_ms": st}
            print("  %s %s: cpu %.1f s  %s" % (a.variants, name, cpu, ", ".join(
                "%s %.1f" % (k, v / 1e3) for k, v in sorted(st.items(), key=lambda x: -x[1])
                if v >= 50)))
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

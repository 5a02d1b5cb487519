"""Scale-out of the PyTorch port against the JAX package: ragged
catalogs (ragged.py), result checkpoints (checkpoint.py) and one process
per device (parallel/), in float64 on the CPU.

- pack_ragged: every bucket's arrays, masks and indices exactly equal to
  the JAX package's (tests/test_ragged.py's catalog), and the same
  ValueErrors;
- metacal_pipeline_ragged on a catalog of two buckets (single-epoch
  49x49 stamps, the flat pipeline; single- and multi-epoch 41x41 crops,
  the mb pipeline with a pad epoch): each object's rows bit
  for bit the direct pipeline call's on its bucket;
- checkpoints: the shards and manifest one package writes, the other
  reads, with the same resume index;
- host_shard_bounds: equal to the JAX package's over a grid of catalog
  sizes, process counts and indices;
- two processes on the CPU in one gloo group (a FileStore in the test's
  directory, so concurrent runs share no port), spawned once: the
  sharded flat exp-LM and mb exp-LM pipelines' calibration equal to the
  single-process call's to rtol 1e-12 on both ranks, and each rank's
  rows equal to the same rows of the single-process call (bit for bit
  for the flat pipeline; to rtol 1e-8 and atol 1e-10 for the mb one,
  whose plain solve rounds a batch of 2 objects and one of 4
  differently).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ngmix_tpu import checkpoint as jcheckpoint, ragged as jragged
from ngmix_tpu.parallel import distributed as jdist

import ngmix_tpu_torch as nt
from ngmix_tpu_torch import checkpoint, ragged
from ngmix_tpu_torch.parallel import distributed as dist, mesh

import _torch_shard_worker as worker
from test_torch_pipeline import DIMS, PSF_DIMS, SCALE, _inputs

# one intra-op thread: the suite's workers share the cores, and
# torch's default pool per worker oversubscribes them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# the two gloo ranks' shared deadline (s); alone they take ~4 s
WORKER_TIMEOUT_S = 300


def _catalog():
    """tests/test_ragged.py's mixed catalog shape: 33x33 and 49x49 stamps
    of 1 to 3 epochs (random pixels: packing reads no values)"""
    rng = np.random.RandomState(10)

    def obj(dims, nepoch):
        ims = [rng.normal(size=dims) for _ in range(nepoch)]
        return dict(image=ims, weight=[np.full(dims, 1e8)] * nepoch,
                    cen=rng.uniform(10, 20, (nepoch, 2)),
                    psf_image=[rng.normal(size=PSF_DIMS) for _ in range(nepoch)],
                    psf_cen=np.full((nepoch, 2), 12.0),
                    noise=[rng.normal(size=dims) for _ in range(nepoch)],
                    band=rng.randint(0, 2, nepoch))

    return [obj((33, 33), 1), obj((49, 49), 3), obj((33, 33), 2), obj((49, 49), 1)]


@pytest.mark.parametrize("bucket_dims", [None, [(49, 49)]], ids=["by-size", "coarse"])
def test_pack_ragged_matches_jax(bucket_dims):
    cat = _catalog()
    ref = jragged.pack_ragged(cat, bucket_dims=bucket_dims)
    out = ragged.pack_ragged(cat, bucket_dims=bucket_dims)
    assert len(out) == len(ref) == (2 if bucket_dims is None else 1)
    for o, r in zip(out, ref):
        assert set(o) == set(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert o[k].dtype == v.dtype and o[k].shape == v.shape, k
                np.testing.assert_array_equal(o[k], v, err_msg=k)
            else:
                assert o[k] == v, k
    for bad, kw in (([cat[1]], dict(bucket_dims=[(33, 33)])),
                    ([dict(cat[1], image=[cat[1]["image"][0], cat[0]["image"]])], {})):
        for pack in (jragged.pack_ragged, ragged.pack_ragged):
            with pytest.raises(ValueError):
                pack(bad, **kw)


def test_ragged_pipeline_matches_direct_calls():
    """one pipeline call a bucket, reassembled in catalog order: the
    single-epoch 49x49 bucket through the flat pipeline, the 41x41 one
    (central crops: an object of two epochs and one of one, which gets a
    pad epoch) through the mb pipeline"""
    ims, wts, cens, pims, pcens, noise = _inputs()

    def obj(idx, crop=0):
        s = slice(crop, DIMS[0] - crop)
        return dict(image=[ims[i][s, s] for i in idx], weight=[wts[i][s, s] for i in idx],
                    cen=cens[list(idx)] - crop, psf_image=[pims[i] for i in idx],
                    psf_cen=pcens[list(idx)], noise=[noise[i][s, s] for i in idx])

    cat = [obj([0]), obj([1, 3], crop=4), obj([2]), obj([5], crop=4)]
    conf = nt.MetacalConfig(dims=(0, 0), psf_dims=PSF_DIMS, jac=(SCALE, 0.0, 0.0, SCALE),
                            fixnoise=True, pad_factor=2, fit_dims=(19, 19))
    res = ragged.metacal_pipeline_ragged(cat, conf, measure="gaussmom", device="cpu")
    keys = ("images", "weights", "cens", "psf_images", "psf_cens", "noises")
    buckets = ragged.pack_ragged(cat)
    assert [(b["dims"], b["nepoch"]) for b in buckets] == [((41, 41), 2), ((49, 49), 1)]
    for b in buckets:
        conf_b = conf._replace(dims=b["dims"], psf_dims=b["psf_dims"])
        if b["nepoch"] == 1:
            direct = nt.metacal_pipeline(*(b[k][:, 0] for k in keys), conf_b, device="cpu")
        else:
            direct = nt.metacal_pipeline_mb(*(b[k] for k in keys), b["band"], 1, conf_b,
                                            measure="gaussmom", device="cpu")
        for t in nt.batch.GALSHEAR_TYPES:
            assert set(res[t]) == set(direct[t])
            for k, v in direct[t].items():
                np.testing.assert_array_equal(res[t][k][b["indices"]], v.numpy(),
                                              err_msg=(t, k))
        for row, idx in enumerate(b["indices"]):
            sig = direct["psf_sigma"][row].numpy()
            np.testing.assert_array_equal(res["psf_sigma"][idx],
                                          sig[:b["epoch_mask"][row].sum()] if sig.ndim else sig)
    assert res["dropped_keys"] == []
    assert res["noshear"]["flags"].shape == (4,) and np.all(res["noshear"]["flags"] == 0)


def _results(seed, n):
    rng = np.random.RandomState(seed)
    return {"noshear": {"pars": rng.normal(size=(n, 6)), "flags": rng.randint(0, 3, n)},
            "psf_sigma": rng.uniform(0.5, 1.0, n), "step": np.float64(0.01)}


def test_checkpoints_read_both_ways(tmp_path):
    """the port's shards (from tensors) read by the JAX package's
    load_results and the JAX package's by the port's, with the same
    manifest and resume index"""
    parts = [_results(s, n) for s, n in ((1, 3), (2, 4))]
    writers = {"port": checkpoint.ResultWriter, "jax": jcheckpoint.ResultWriter}
    for name, writer in writers.items():
        w = writer(str(tmp_path / name))
        assert w.next_index() == 0
        for i, p in enumerate(parts):
            if name == "port":
                p = {"noshear": {k: torch.as_tensor(v) for k, v in p["noshear"].items()},
                     "psf_sigma": torch.as_tensor(p["psf_sigma"]), "step": p["step"]}
            w.write(i, p)
    assert (json.loads((tmp_path / "port" / "manifest.json").read_text())
            == json.loads((tmp_path / "jax" / "manifest.json").read_text()))
    for reader, src in ((jcheckpoint.load_results, "port"), (checkpoint.load_results, "jax")):
        out = reader(str(tmp_path / src))
        assert set(out) == {"noshear/pars", "noshear/flags", "psf_sigma", "step"}
        np.testing.assert_array_equal(out["noshear/pars"],
                                      np.concatenate([p["noshear"]["pars"] for p in parts]))
        np.testing.assert_array_equal(out["noshear/flags"],
                                      np.concatenate([p["noshear"]["flags"] for p in parts]))
        np.testing.assert_array_equal(out["step"], [0.01, 0.01])
    # resume across packages: a gap at index 2 leaves the resume point there
    jcheckpoint.ResultWriter(str(tmp_path / "port")).write(3, parts[0])
    for writer in writers.values():
        w = writer(str(tmp_path / "port"))
        assert w.next_index() == 2 and w.has(3) and not w.has(2)
    assert checkpoint.load_results(str(tmp_path / "port"))["noshear/pars"].shape == (10, 6)


def test_host_shard_bounds_match_jax():
    for nobj in (0, 1, 6, 12, 1000, 10240):
        for n in (1, 2, 3, 4, 8):
            for p in range(n):
                if nobj % n:
                    for fn in (jdist.host_shard_bounds, dist.host_shard_bounds):
                        with pytest.raises(ValueError, match="does not divide"):
                            fn(nobj, p, n)
                else:
                    assert dist.host_shard_bounds(nobj, p, n) == jdist.host_shard_bounds(
                        nobj, p, n)
    # outside a process group: one process, the whole catalog
    assert not dist.is_initialized()
    assert dist.host_shard_bounds(12) == (0, 12)
    assert dist.local_device("cpu") == torch.device("cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v.numpy()
    return out


def test_gloo_two_process_sharded_pipelines(tmp_path):
    """two ranks of one gloo group, each its half of the catalog: the
    calibration equal to one process's on both, and the rows the same"""
    flat = _inputs()
    eps = [_inputs(seed) for seed in (21, 22)]
    mb = tuple(np.stack([ep[i][:4] for ep in eps], axis=1) for i in range(6))
    band = np.array([[0, 1], [1, 0]] * 2, np.int32)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, band=band, **{"flat%d" % i: a for i, a in enumerate(flat)},
             **{"mb%d" % i: a for i, a in enumerate(mb)})
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    outs = [tmp_path / ("rank%d.npz" % r) for r in range(2)]
    # each rank writes to a file of its own (a pipe read after the other
    # rank's could fill and stall a rank inside a collective), and both
    # share one deadline
    logs = [tmp_path / ("rank%d.log" % r) for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, worker.__file__, str(tmp_path / "store"), str(r), "2",
                     str(inputs), str(outs[r])], env=env, cwd=str(ROOT), stdout=log,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [log.read_text() for log in logs]

    res, calib = mesh.make_sharded_pipeline_fn(worker.FLAT_CONF, measure="exp-lm",
                                               device="cpu")(*flat)
    mres, mcalib = mesh.make_sharded_mb_pipeline_fn(worker.MB_CONF, band, worker.NBAND,
                                                    device="cpu")(*mb)
    one = dict(_flat(res, "flat/"), **_flat(mres, "mb/"))
    calibs = dict(_flat(calib, "calib/"), **_flat(mcalib, "mbcalib/"))
    torch.testing.assert_close(calib["R"], nt.shear_response(res)["R"], rtol=0, atol=0)
    for r, out in enumerate(outs):
        d = np.load(out)
        lo, hi = int(d["lo"]), int(d["hi"])
        assert (lo, hi) == (4 * r, 4 * r + 4)
        for k, v in calibs.items():
            np.testing.assert_allclose(d[k], v, rtol=1e-12, atol=0, err_msg=k)
        for k, v in one.items():
            n = 4 if k.startswith("flat/") else 2
            if k.startswith("flat/"):
                np.testing.assert_array_equal(d[k], v[r * n:(r + 1) * n], err_msg=k)
            else:
                # the plain K3-mb and its engine round a batch of 2 objects
                # and one of 4 differently (by ~1e-11)
                np.testing.assert_allclose(d[k], v[r * n:(r + 1) * n], rtol=1e-8, atol=1e-10,
                                           err_msg=k)
        assert set(d.files) == set(one) | set(calibs) | {"lo", "hi"}

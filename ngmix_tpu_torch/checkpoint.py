"""Batch-level checkpointing of result tables.

The port of ``ngmix_tpu/checkpoint.py``, in the same format: a run that
processes millions of stamps in batches appends one compressed npz
shard per completed batch (``shard_%06d.npz``, nested result dicts
flattened with '/' separators) and a ``manifest.json`` mapping each
batch index to its shard, so an interrupted run resumes, and
``load_results`` concatenates the shards back into one table. Either
package reads what the other wrote.
"""
import json
import os

import numpy as np
import torch


def _numpy(val):
    """a tensor (on any device) or array-like as a numpy array"""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


class ResultWriter(object):
    """append batched result dicts as npz shards with resume support.

    Usage::

        writer = ResultWriter("outdir")
        start = writer.next_index()          # resume point (batch index)
        for i in range(start, nbatch):
            results = pipeline(batch_i)
            writer.write(i, results)
    """

    def __init__(self, outdir):
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.manifest_path = os.path.join(outdir, "manifest.json")
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                self.manifest = json.load(f)
        else:
            self.manifest = {"shards": {}}

    def next_index(self):
        """the first batch index without a completed shard"""
        done = sorted(int(k) for k in self.manifest["shards"])
        i = 0
        for d in done:
            if d != i:
                break
            i += 1
        return i

    def has(self, index):
        return str(index) in self.manifest["shards"]

    def write(self, index, results):
        """write one batch of results (a dict of tensors or arrays; nested
        dicts are flattened with '/' separators), the shard and then the
        manifest each through a temporary file and a rename"""
        flat = {}

        def add(prefix, val):
            if isinstance(val, dict):
                for k, v in val.items():
                    add(f"{prefix}/{k}" if prefix else k, v)
            else:
                flat[prefix] = _numpy(val)

        add("", results)

        fname = os.path.join(self.outdir, "shard_%06d.npz" % index)
        # np.savez appends .npz when missing, so the temporary name keeps
        # the suffix
        tmp = fname.replace(".npz", ".tmp.npz")
        np.savez_compressed(tmp, **flat)
        os.replace(tmp, fname)

        self.manifest["shards"][str(index)] = os.path.basename(fname)
        tmpm = self.manifest_path + ".tmp"
        with open(tmpm, "w") as f:
            json.dump(self.manifest, f)
        os.replace(tmpm, self.manifest_path)


def load_results(outdir):
    """every shard concatenated into one dict of numpy arrays (the
    leading axis stamps, shards in batch order; 0-d values stacked)"""
    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    tables = []
    for k in sorted(manifest["shards"], key=int):
        with np.load(os.path.join(outdir, manifest["shards"][k])) as d:
            tables.append({name: d[name] for name in d.files})
    if not tables:
        return {}
    out = {}
    for name in tables[0]:
        parts = [t[name] for t in tables]
        out[name] = np.stack(parts) if parts[0].ndim == 0 else np.concatenate(parts, axis=0)
    return out

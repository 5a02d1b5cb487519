"""Ragged survey catalogs: size bucketing.

The port of ``ngmix_tpu/ragged.py``. A catalog whose objects differ in
stamp size and epoch count is grouped into buckets of one static shape
each:

- objects are grouped into stamp-size buckets; each bucket runs the
  batched metacal pipeline once, with that bucket's dims;
- smaller stamps inside a bucket are zero-padded with zero weight, so
  the pad pixels carry ierr = 0 and drop out of every measurement (the
  mask plays the role of the reference's pixel compaction);
- objects with fewer epochs than their bucket's maximum get pad
  epochs: zero image, zero weight (no residual rows and no
  normal-equation terms, exactly) and a copy of a real epoch's psf
  stamp so the k-space engine stays finite;
- results are scattered back to catalog order.

Where the JAX package compiles one program per bucket, the port calls
the pipeline once per bucket: single-epoch, single-band buckets the flat
``metacal_pipeline``, the others ``metacal_pipeline_mb``.

Entry points: pack_ragged (grouping and padding) and
metacal_pipeline_ragged (the pipeline of every bucket and the
reassembly).
"""
import logging

import numpy as np
import torch

from .batch import MetacalConfig, metacal_pipeline, metacal_pipeline_mb

__all__ = ["pack_ragged", "metacal_pipeline_ragged"]

logger = logging.getLogger(__name__)


def _as_epoch_list(x):
    """a bare [H, W] array or a list of epoch arrays as a list"""
    if isinstance(x, (list, tuple)):
        return list(x)
    x = np.asarray(x)
    if x.ndim == 3:
        return [x[i] for i in range(x.shape[0])]
    return [x]


def _normalize_object(obj):
    """one catalog entry as per-epoch lists of one length.

    Keys: image, weight, cen, psf_image, psf_cen and the optional noise
    and band; a single-epoch entry may hold bare arrays, a multi-epoch
    entry lists (or stacked [E, ...] arrays). All epochs of one object
    share a stamp size (MEDS cutouts do).
    """
    images = _as_epoch_list(obj["image"])
    weights = _as_epoch_list(obj["weight"])
    psf_images = _as_epoch_list(obj["psf_image"])
    nepoch = len(images)

    cens = np.atleast_2d(np.asarray(obj["cen"], dtype=float))
    psf_cens = np.atleast_2d(np.asarray(obj["psf_cen"], dtype=float))
    if cens.shape[0] == 1:
        cens = np.repeat(cens, nepoch, axis=0)
    if psf_cens.shape[0] == 1:
        psf_cens = np.repeat(psf_cens, nepoch, axis=0)

    if "noise" in obj and obj["noise"] is not None:
        noises = _as_epoch_list(obj["noise"])
    else:
        noises = [np.zeros_like(np.asarray(im)) for im in images]
    band = np.atleast_1d(np.asarray(obj.get("band", 0), dtype=np.int32))
    if band.shape[0] == 1:
        band = np.repeat(band, nepoch)

    dims = {np.asarray(im).shape for im in images}
    if len(dims) != 1:
        raise ValueError(
            "all epochs of one object must share a stamp size; got %s" % sorted(dims)
        )
    if not (
        len(weights) == len(psf_images) == len(noises) == nepoch
        and cens.shape[0] == psf_cens.shape[0] == band.shape[0] == nepoch
    ):
        raise ValueError("inconsistent epoch counts within one object")
    return dict(
        images=images, weights=weights, cens=cens, psf_images=psf_images,
        psf_cens=psf_cens, noises=noises, band=band, nepoch=nepoch,
        dims=next(iter(dims)),
    )


def _pad_stamp(img, dims, fill=0.0):
    """a stamp at the top left of a [dims] canvas (its pixel coordinates,
    and so its center, unchanged)"""
    img = np.asarray(img)
    out = np.full(dims, fill, dtype=img.dtype)
    out[: img.shape[0], : img.shape[1]] = img
    return out


def pack_ragged(catalog, bucket_dims=None):
    """group a ragged catalog into static-shape buckets.

    catalog: a list of per-object dicts (see _normalize_object).
    bucket_dims: an optional list of (H, W) bucket sizes; by default
    every distinct stamp size is a bucket (no pad, one pipeline shape a
    size). Each object lands in the smallest bucket that fits.

    Returns a list of bucket dicts with keys: indices [Bb] (catalog
    rows), dims, psf_dims, nepoch (the bucket's most), epoch_mask [Bb,
    E], the stacked numpy arrays images, weights, cens, psf_images,
    psf_cens, noises [Bb, E, ...] and band [Bb, E].
    """
    objs = [_normalize_object(o) for o in catalog]

    if bucket_dims is None:
        sizes = sorted({o["dims"] for o in objs})
    else:
        sizes = sorted(tuple(d) for d in bucket_dims)
        for o in objs:
            if not any(o["dims"][0] <= s[0] and o["dims"][1] <= s[1] for s in sizes):
                raise ValueError("stamp %s fits no bucket in %s" % (o["dims"], sizes))

    def bucket_of(dims):
        for s in sizes:
            if dims[0] <= s[0] and dims[1] <= s[1]:
                return s
        raise AssertionError

    groups = {}
    for idx, o in enumerate(objs):
        groups.setdefault(bucket_of(o["dims"]), []).append(idx)

    buckets = []
    for dims in sorted(groups):
        indices = groups[dims]
        members = [objs[i] for i in indices]
        E = max(o["nepoch"] for o in members)
        psf_dims = (
            max(np.asarray(o["psf_images"][0]).shape[0] for o in members),
            max(np.asarray(o["psf_images"][0]).shape[1] for o in members),
        )
        Bb = len(members)
        images = np.zeros((Bb, E) + dims)
        weights = np.zeros((Bb, E) + dims)
        noises = np.zeros((Bb, E) + dims)
        psf_images = np.zeros((Bb, E) + psf_dims)
        cens = np.zeros((Bb, E, 2))
        psf_cens = np.zeros((Bb, E, 2))
        band = np.zeros((Bb, E), np.int32)
        epoch_mask = np.zeros((Bb, E), bool)
        for row, o in enumerate(members):
            for e in range(E):
                src = min(e, o["nepoch"] - 1)
                real = e < o["nepoch"]
                epoch_mask[row, e] = real
                # pad epochs copy a real epoch's psf (finite k-space
                # operations) but have zero image, weight and noise
                psf_images[row, e] = _pad_stamp(o["psf_images"][src], psf_dims)
                psf_cens[row, e] = o["psf_cens"][src]
                cens[row, e] = o["cens"][src]
                band[row, e] = o["band"][src] if real else 0
                if real:
                    images[row, e] = _pad_stamp(o["images"][e], dims)
                    weights[row, e] = _pad_stamp(o["weights"][e], dims)
                    noises[row, e] = _pad_stamp(o["noises"][e], dims)
        buckets.append(dict(
            indices=np.asarray(indices), dims=dims, psf_dims=psf_dims, nepoch=E,
            epoch_mask=epoch_mask, images=images, weights=weights, cens=cens,
            psf_images=psf_images, psf_cens=psf_cens, noises=noises, band=band,
        ))
    return buckets


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def metacal_pipeline_ragged(catalog, conf: MetacalConfig, measure="gaussmom", nband=1,
                            bucket_dims=None, dtype=None, device=None, **measure_kw):
    """batched metacal over a ragged catalog: one pipeline call per size
    bucket, the results reassembled in catalog order.

    conf.dims and conf.psf_dims are set per bucket. One estimator runs
    over the whole catalog: single-epoch single-band buckets take the
    flat pipeline, multi-epoch (or multi-band) buckets the mb pipeline
    with the same measure (LM measures become joint multi-epoch fits,
    gaussmom and admom pool the epochs' moment sums, and pgauss and
    ksigma raise on multi-epoch buckets rather than switch estimators).
    dtype: the real dtype of the stamps (pack_ragged's float64 by
    default); device: as the pipelines take it; measure_kw passes to
    them.

    Returns {type: {key: [Ncat, ...] numpy arrays}} in catalog order,
    plus "psf_sigma" as a per-object list (epoch counts differ) and
    "dropped_keys", the result columns that could not be merged across
    buckets (each also warned about once).
    """
    buckets = pack_ragged(catalog, bucket_dims=bucket_dims)
    ncat = sum(len(b["indices"]) for b in buckets)

    def arrays(b, keys, epoch=None):
        out = [b[k] if epoch is None else b[k][:, epoch] for k in keys]
        return [torch.as_tensor(a, dtype=dtype) if dtype is not None and a.dtype.kind == "f"
                else a for a in out]

    keys = ("images", "weights", "cens", "psf_images", "psf_cens", "noises")
    merged = None
    dropped = set()
    seen_keys = {}
    psf_sigma = [None] * ncat
    for b in buckets:
        conf_b = conf._replace(dims=b["dims"], psf_dims=b["psf_dims"])
        if b["nepoch"] == 1 and nband == 1:
            res = metacal_pipeline(*arrays(b, keys, 0), conf_b, measure=measure,
                                   device=device, **measure_kw)
        else:
            res = metacal_pipeline_mb(*arrays(b, keys), b["band"], nband, conf_b,
                                      measure=measure, device=device, **measure_kw)
        res = {t: ({k: _numpy(v) for k, v in r.items()} if isinstance(r, dict) else _numpy(r))
               for t, r in res.items()}

        sig = res.pop("psf_sigma")
        for row, idx in enumerate(b["indices"]):
            nep = int(b["epoch_mask"][row].sum())
            psf_sigma[idx] = sig[row, :nep] if sig.ndim == 2 else sig[row]

        nb = len(b["indices"])
        if merged is None:
            merged = {
                t: {k: _alloc_catalog(v, ncat) for k, v in tres.items()
                    if v.ndim >= 1 and v.shape[0] == nb}
                for t, tres in res.items()
            }
        # merge the columns every bucket reports alike: flat and
        # multi-epoch buckets can report different shapes (flat [6] pars
        # against mb [5 + nband]); such a column, or one a bucket lacks, is
        # dropped from the catalog, with a warning, and listed under
        # "dropped_keys"
        for t, tres in res.items():
            # every column any bucket reports is tracked, so one that only
            # later buckets produce ends up in dropped_keys too
            for k, v in tres.items():
                if v.ndim >= 1 and v.shape[0] == nb:
                    seen_keys.setdefault(t, set()).add(k)
            for k in list(merged[t]):
                v = tres.get(k)
                dst = merged[t][k]
                if v is None or v.shape[1:] != dst.shape[1:]:
                    if k not in dropped:
                        dropped.add(k)
                        logger.warning(
                            "metacal_pipeline_ragged: dropping result column %r from the "
                            "merged catalog: the size buckets report it with inconsistent "
                            "shapes (or not at all); returned under 'dropped_keys'", k)
                    del merged[t][k]
                    continue
                dst[b["indices"]] = v

    for t, seen in seen_keys.items():
        for k in sorted(seen - set(merged.get(t, {}))):
            if k not in dropped:
                dropped.add(k)
                logger.warning(
                    "metacal_pipeline_ragged: result column %r was reported by some size "
                    "buckets but not the first, so it is absent from the merged catalog; "
                    "returned under 'dropped_keys'", k)
    merged["psf_sigma"] = psf_sigma
    merged["dropped_keys"] = sorted(dropped)
    return merged


def _alloc_catalog(template, ncat):
    t = np.asarray(template)
    return np.zeros((ncat,) + t.shape[1:], t.dtype)

"""Generic traversal over the Observation container hierarchy.

The port of ``ngmix_tpu/containers.py``: one recursion scheme over
MultiBandObsList -> ObsList -> Observation; consumers supply a leaf
function and get mapping, zipping, pruning, or dict-transposing over
the nested containers.
"""
from .observation import MultiBandObsList, Observation, ObsList

__all__ = ["obs_map", "obs_zip_map", "obs_prune", "obs_map_transpose"]


def _bad_type(obs):
    raise ValueError(
        "expected Observation, ObsList or MultiBandObsList, got %s"
        % type(obs).__name__
    )


def obs_map(obs, leaf_fn):
    """Apply ``leaf_fn`` to every leaf Observation.

    Results come back in the input's nesting: plain (possibly nested)
    lists mirroring the ObsList / MultiBandObsList structure, or the
    bare return value for a bare Observation.
    """
    if isinstance(obs, Observation):
        return leaf_fn(obs)
    if isinstance(obs, (ObsList, MultiBandObsList)):
        return [obs_map(sub, leaf_fn) for sub in obs]
    _bad_type(obs)


def obs_zip_map(a, b, leaf_fn):
    """Apply ``leaf_fn(leaf_a, leaf_b)`` over two same-shape containers."""
    if isinstance(a, Observation):
        return leaf_fn(a, b)
    if isinstance(a, (ObsList, MultiBandObsList)):
        return [obs_zip_map(x, y, leaf_fn) for x, y in zip(a, b)]
    _bad_type(a)


def obs_prune(obs, keep_fn):
    """Rebuild the container keeping only leaves where ``keep_fn`` is True.

    Container metadata carries over. Returns None when nothing usable
    remains at this level: a bare Observation failing ``keep_fn``, an
    ObsList with every epoch pruned, or a MultiBandObsList where any
    band emptied (a band with zero epochs is unusable downstream).
    """
    if isinstance(obs, Observation):
        return obs if keep_fn(obs) else None
    if isinstance(obs, ObsList):
        kept = ObsList(meta=obs.meta)
        for sub in obs:
            if keep_fn(sub):
                kept.append(sub)
        return kept if len(kept) > 0 else None
    if isinstance(obs, MultiBandObsList):
        rebuilt = MultiBandObsList(meta=obs.meta)
        for band in obs:
            kept_band = obs_prune(band, keep_fn)
            if kept_band is None:
                return None
            rebuilt.append(kept_band)
        return rebuilt
    _bad_type(obs)


def obs_map_transpose(obs, leaf_fn):
    """Map a dict-returning ``leaf_fn`` over leaves and transpose.

    Each leaf produces ``{key: Observation}``; the result is
    ``{key: container}`` with the input's ObsList / MultiBandObsList
    nesting rebuilt around the per-key values. All leaves must produce
    the same key set.
    """
    if isinstance(obs, Observation):
        return leaf_fn(obs)
    if isinstance(obs, ObsList):
        cls = ObsList
    elif isinstance(obs, MultiBandObsList):
        cls = MultiBandObsList
    else:
        _bad_type(obs)
    per_sub = [obs_map_transpose(sub, leaf_fn) for sub in obs]
    out = {}
    for key in per_sub[0]:
        gathered = cls()
        for sub in per_sub:
            gathered.append(sub[key])
        out[key] = gathered
    return out

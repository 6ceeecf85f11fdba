"""What crosses between the reference package and the port, as plain values.

GPIC has no learned weights. The state that crosses is:

  - the features, as a numpy array (``run_gpic`` takes it as is);
  - the configuration: :func:`config_from_reference` takes the reference
    ``GPICConfig``'s fields as plain values (dtypes as strings, the
    affinity spec as a dict of its fields) and returns the port's
    ``GPICConfig``;
  - random draws, as numpy: k-means start centroids go in through
    ``kmeans(init=...)`` and extra power start columns as the ``v0`` of
    ``batched_power_iteration`` (the two packages' generators differ).

:func:`result_to_numpy` turns a result into numpy arrays for comparisons.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .core.affinity import AffinitySpec
from .core.pic import PICResult
from .core.pipeline import GPICConfig, check_config

#: reference fields that select HOW the reference computes (kernel vs jnp
#: oracle, a fallback policy, knobs of routes that a dense single-device
#: run never takes) and not WHAT: the port accepts any value and ignores it
_NO_EFFECT = ("use_pallas", "retry_on_fallback", "block_sparse", "overlap",
              "component_probe", "shard_axes", "max_retries", "backoff")

#: reference fields this slice does not route, with the value that means
#: "off"; any other value raises NotImplementedError
_UNROUTED_DEFAULTS = {
    "mesh": None,                 # ROADMAP queue 1 item 10, multi-GPU
    "qr_every": 1,                # item 4, embedding modes
    "residual_tol": None,         # item 4
    "snapshot_iters": None,       # item 4
    "fold_shift": False,          # item 10 (sharded explicit engine only)
    "row_reorder": False,         # item 7, block-sparse and row reorder
    "checkpoint_every": None,     # item 9, resumable execution
    "ckpt_dir": None,             # item 9
    "straggler_timeout": None,    # item 9
    "inject_ring_fault": None,    # item 10
}


def config_from_reference(ref_fields: dict) -> GPICConfig:
    """The port's :class:`GPICConfig` for the reference config whose fields
    are given as plain values. Raises ValueError for an unknown field and
    NotImplementedError for a setting this slice does not route."""
    kept = {f.name for f in fields(GPICConfig)}
    out = {}
    for name, value in ref_fields.items():
        if name in kept:
            if name == "a_dtype":
                value = getattr(torch, str(value))
            elif name == "affinity" and value is not None:
                value = AffinitySpec(**value)
            out[name] = value
        elif name in _UNROUTED_DEFAULTS:
            if value != _UNROUTED_DEFAULTS[name]:
                raise NotImplementedError(
                    f"{name}={value!r} is not routed by the port yet (see "
                    "ROADMAP queue 1)")
        elif name not in _NO_EFFECT:
            raise ValueError(f"unknown GPICConfig field {name!r}")
    cfg = GPICConfig(**out)
    check_config(cfg)
    return cfg


def result_to_numpy(res: PICResult) -> dict[str, np.ndarray]:
    """The result's arrays as numpy (health fields prefixed ``health_``)."""
    out = {name: getattr(res, name).detach().cpu().numpy()
           for name in ("labels", "embedding", "n_iter", "converged",
                        "embeddings", "n_iter_cols", "converged_cols")}
    if res.health is not None:
        for name in ("col_status", "isolated_rows", "n_components", "components"):
            out[f"health_{name}"] = getattr(res.health, name).detach().cpu().numpy()
    return out

"""What crosses between the reference package and the port, as plain values.

GPIC has no learned weights. The state that crosses is:

  - the features, as a numpy array (``run_gpic`` takes it as is);
  - the configuration: :func:`config_from_reference` takes the reference
    ``GPICConfig``'s fields as plain values (dtypes as strings, the
    affinity spec as a dict of its fields, snapshot times as a sequence of
    ints) and returns the port's ``GPICConfig``;
  - random draws, as numpy: k-means start centroids go in through
    ``kmeans(init=...)`` and extra power start columns as the ``v0`` of
    ``batched_power_iteration`` (the two packages' generators differ).

The LM substrate has weights: :func:`lm_params_from_reference` turns the
reference's parameter tree, as numpy arrays, into the port's parameter
dict, so that both packages compute with the same weights, and
:func:`adamw_state_from_reference` its AdamW state, so that both train
from one state.

:func:`result_to_numpy` turns a result into numpy arrays for comparisons.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .core.affinity import AffinitySpec
from .core.pic import PICResult
from .core.pipeline import GPICConfig, check_config
from .train.optimizer import AdamWState

#: reference fields that select HOW the reference computes (kernel vs jnp
#: oracle, a fallback policy, the mesh axes the rows stripe over, which a
#: process group has no counterpart of) and not WHAT: the port accepts any
#: value and ignores it. The port has no kernel fallback, so
#: ``retry_on_fallback`` has nothing to retry.
_NO_EFFECT = ("use_pallas", "retry_on_fallback", "shard_axes")

def config_from_reference(ref_fields: dict, n: int | None = None) -> GPICConfig:
    """The port's :class:`GPICConfig` for the reference config whose fields
    are given as plain values. Raises ValueError for an unknown field or a
    value the reference refuses (the spec's neighbor ranks against ``n``,
    the number of points, when it is given) and NotImplementedError for a
    setting that does not cross (a reference mesh) or that the port does
    not route yet."""
    kept = {f.name for f in fields(GPICConfig)}
    out = {}
    for name, value in ref_fields.items():
        if name == "mesh":
            # a JAX object: the port's counterpart is a process group, which
            # the caller sets on the port's config
            if value is not None:
                raise NotImplementedError(
                    f"mesh={value!r} is a JAX mesh and cannot cross; set the port's "
                    "GPICConfig.mesh to a torch.distributed process group instead")
        elif name in kept:
            if name == "a_dtype":
                value = getattr(torch, str(value))
            elif name == "affinity" and value is not None:
                value = AffinitySpec(**value)
            elif name == "snapshot_iters" and value is not None:
                value = tuple(int(t) for t in value)
            elif name == "inject_ring_fault" and value is not None:
                value = tuple(value)
            out[name] = value
        elif name not in _NO_EFFECT:
            raise ValueError(f"unknown GPICConfig field {name!r}")
    cfg = GPICConfig(**out)
    check_config(cfg, n)
    return cfg


def lm_params_from_reference(tree: dict, cfg) -> dict:
    """The port's dense-LM parameters from the reference's parameter tree
    as numpy (``jax.tree.map(np.asarray, params)``): ``embed.{tok,head}``,
    ``layers.*`` stacked on a leading (n_layers, ...) axis, ``ln_f``. The
    (in, out) weight layout is kept; the stacked layers become a list of
    per-layer dicts. CPU tensors in the arrays' float type."""
    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    def layer(node, i):
        if isinstance(node, dict):
            return {name: layer(sub, i) for name, sub in node.items()}
        if node.shape[0] != cfg.n_layers:
            raise ValueError(f"stacked layer weights have {node.shape[0]} layers, the "
                             f"config {cfg.n_layers}")
        return tensor(node[i])

    return {"embed": {name: tensor(a) for name, a in tree["embed"].items()},
            "layers": [layer(tree["layers"], i) for i in range(cfg.n_layers)],
            "ln_f": tensor(tree["ln_f"])}


def adamw_state_from_reference(state: dict, cfg):
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from the
    reference's AdamW state as numpy (``{"step", "mu", "nu"}``, the moments
    in the reference's parameter tree): the step an int32 scalar, the
    moments as :func:`lm_params_from_reference` gives them."""
    return AdamWState(step=torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32),
                      mu=lm_params_from_reference(state["mu"], cfg),
                      nu=lm_params_from_reference(state["nu"], cfg))


def result_to_numpy(res: PICResult) -> dict[str, np.ndarray]:
    """The result's arrays as numpy (health fields prefixed ``health_``)."""
    out = {name: getattr(res, name).detach().cpu().numpy()
           for name in ("labels", "embedding", "n_iter", "converged",
                        "embeddings", "n_iter_cols", "converged_cols")}
    if res.health is not None:
        for name in ("col_status", "isolated_rows", "n_components", "components"):
            out[f"health_{name}"] = getattr(res.health, name).detach().cpu().numpy()
    return out

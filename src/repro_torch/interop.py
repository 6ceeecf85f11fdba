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
reference's parameter tree of any family the port routes, as numpy
arrays, into the port's parameter dict, so that both packages compute
with the same weights, and
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
from .models.moe import layer_schedule
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


#: the reference's stacked parameter groups of each family, by the config
#: field that counts their layers (moe's two groups: :func:`_stacked_counts`)
_STACKED = {"layers": "n_layers", "mamba": "n_layers", "enc_layers": "n_enc_layers",
            "dec_layers": "n_layers"}


def _stacked_counts(cfg) -> dict[str, int]:
    """{stacked group: its layers}; moe's ``dense_layers`` and
    ``moe_layers`` counted from its layer schedule."""
    counts = {name: getattr(cfg, field) for name, field in _STACKED.items()}
    if cfg.family == "moe":
        kinds = [kind for kind, _ in layer_schedule(cfg)]
        counts.update(dense_layers=kinds.count("dense"), moe_layers=kinds.count("moe"))
    return counts


def lm_params_from_reference(tree: dict, cfg) -> dict:
    """The port's LM parameters from the reference's parameter tree as
    numpy (``jax.tree.map(np.asarray, params)``), for every family the port
    routes: the groups stacked on a leading layer axis (``layers`` of the
    dense, ssm and vlm families, hybrid's ``mamba``, encdec's
    ``enc_layers`` and ``dec_layers``, moe's ``dense_layers`` and
    ``moe_layers``) become lists of per-layer dicts;
    everything else (``embed``, ``ln_f``, hybrid's one ``shared_attn``,
    encdec's ``ln_enc``) keeps its nesting. The (in, out) weight layout is
    kept. CPU tensors in the arrays' float type (bfloat16 arrays, which
    numpy holds as an extension type, cross through f32, exactly)."""
    def tensor(a) -> torch.Tensor:
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True))

    def layer(node, i, n):
        if isinstance(node, dict):
            return {name: layer(sub, i, n) for name, sub in node.items()}
        if node.shape[0] != n:
            raise ValueError(f"stacked layer weights have {node.shape[0]} layers, the "
                             f"config {n}")
        return tensor(node[i])

    def whole(node):
        if isinstance(node, dict):
            return {name: whole(sub) for name, sub in node.items()}
        return tensor(node)

    stacked = _stacked_counts(cfg)
    out = {}
    for name, node in tree.items():
        if name in stacked:
            n = stacked[name]
            out[name] = [layer(node, i, n) for i in range(n)]
        else:
            out[name] = whole(node)
    return out


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

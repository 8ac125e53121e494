"""PartitionSpec heuristics aligned with the mesh axis vocabulary.

Counterpart of ``mxtpu/sharding/spec.py``, kept as the port's own copy:
``SpecLayout`` (:49) names the three canonical axes

* ``data`` — batch/replica axis: activations and optimizer state shard
  here (weight-update sharding), parameters replicate across it;
* ``fsdp`` — parameter rows shard here when the mesh has the axis;
* ``tp``   — tensor-parallel columns;

and ``parameter_spec_from_name`` (:103) assigns a spec to every parameter
from its name alone. A spec may name axes the active mesh does not have:
the plan (``plan.py``) prunes absent axes to ``None``.

``PartitionSpec`` is the port's own: a tuple of axis entries (``None``,
an axis name, or a tuple of axis names), equal as a tuple to
``jax.sharding.PartitionSpec`` with the same entries.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PartitionSpec", "SpecLayout", "parameter_spec_from_name"]


class PartitionSpec(tuple):
    """``PartitionSpec("fsdp", "tp")``: one entry per array dimension,
    trailing dimensions unnamed (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


PS = PartitionSpec

#: suffixes that mark small per-feature vectors: always replicated
_REPLICATED_SUFFIXES = ("_bias", "_gamma", "_beta", "_moving_mean",
                       "_moving_var", "_moving_avg", "_running_mean",
                       "_running_var")

#: substrings that mark attention/recurrent input projections
_PROJECTION_KEYS = ("i2h", "h2h", "q_proj", "k_proj", "v_proj", "qkv",
                    "query", "key", "value", "attn")

#: substrings that mark output projections
_OUT_PROJECTION_KEYS = ("o_proj", "out_proj", "proj_out")


@dataclass(frozen=True)
class SpecLayout:
    """Canonical PartitionSpecs for parameters and activations. Axis
    names only: whether an axis shards anything is decided by the plan
    against the live mesh."""

    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    tp_axis: str = "tp"

    def embeddings(self):
        """Vocabulary rows over fsdp x tp, features replicated."""
        return PS((self.fsdp_axis, self.tp_axis), None)

    def projection(self):
        """Attention/recurrent projections: rows over fsdp, cols over
        tp."""
        return PS(self.fsdp_axis, self.tp_axis)

    def out_projection(self):
        """Output projections: rows over fsdp, columns replicated."""
        return PS(self.fsdp_axis, None)

    def generic_weight(self):
        """Other weight matrices: rows over fsdp, cols over tp."""
        return PS(self.fsdp_axis, self.tp_axis)

    def replicated(self):
        """Biases, norm scales, and anything unrecognized."""
        return PS()

    def activations(self):
        """Batches shard over the data axis."""
        return PS(self.data_axis)

    def weight_update(self):
        """Optimizer state rows shard over the data axis (cross-replica
        weight-update sharding)."""
        return PS(self.data_axis)


def parameter_spec_from_name(param_name, layout=None):
    """The spec of a parameter from its name, first match wins:
    ``*_bias``/``*_gamma``/``*_beta``/BN statistics/``norm`` ->
    replicated; ``embed`` -> embeddings; output projections ->
    out_projection (before the input-projection rule: ``self_attn.o_proj``
    contains ``attn``); input projections -> projection; any other
    ``weight`` -> generic_weight; an unknown name -> replicated."""
    layout = layout or SpecLayout()
    name = param_name.lower()
    if name.endswith(_REPLICATED_SUFFIXES) or "norm" in name:
        return layout.replicated()
    if "embed" in name:
        return layout.embeddings()
    if any(k in name for k in _OUT_PROJECTION_KEYS):
        return layout.out_projection()
    if any(k in name for k in _PROJECTION_KEYS):
        return layout.projection()
    if "weight" in name:
        return layout.generic_weight()
    return layout.replicated()

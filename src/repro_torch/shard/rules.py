"""Per-parameter sharding rules for the LM's parameter tree on a dp×tp mesh.

Port of :mod:`repro.shard.rules`: one table, used by the sharded train
step (which block of each tensor a rank holds) and by the sharded
checkpoint writer (the axis rules in the layout manifest):

=============  =======================  ===========================
parameter      spec                     meaning
=============  =======================  ===========================
wq, wk, wv     P(None, None, "tp")      column-parallel: each shard
                                        holds ``num_heads/tp`` query
                                        (``num_kv_heads/tp`` kv) heads
w_gate, w_up   P(None, None, "tp")      column-parallel: ``d_ff/tp``
                                        hidden columns per shard
wo, w_down     P(None, "tp", None)      row-parallel: contracts over
                                        the shard's local columns,
                                        completed by a tp all-reduce
embed, norms,  P()                      replicated (their gradients
lm_head                                 are completed by the
                                        identity-forward/all-reduce-
                                        backward wrapper in
                                        :mod:`repro_torch.models.lm`)
=============  =======================  ===========================

The ``dp`` axis never appears in parameter specs: parameters are
replicated across data-parallel ranks and only the batch is split.

:class:`PartitionSpec` is the port's own spec type, a tuple of axis
names or ``None`` per dimension (the reference's ``jax.sharding``
type is one too, so the two compare equal).  The reference's
``state_shardings`` (specs to ``NamedSharding`` for ``device_put``)
becomes :func:`shard_block` / :func:`shard_state`, which cut this
rank's block out of a full tensor, and :func:`assemble` /
:func:`assemble_state`, which put the global tensor back together from
the blocks in shard order.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["DP_AXIS", "TP_AXIS", "TRAIN_AXES", "PartitionSpec",
           "validate_tp", "lm_param_specs", "train_state_specs",
           "specs_to_rules", "rules_to_specs", "flatten_specs",
           "shard_block", "shard_state", "assemble", "assemble_state"]

#: The two mesh axes the training stack understands.
DP_AXIS = "dp"
TP_AXIS = "tp"
TRAIN_AXES = (DP_AXIS, TP_AXIS)


class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is split over, or ``None``;
    trailing dimensions not named are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def validate_tp(cfg, tp: int) -> None:
    """Raise if a tp degree cannot shard this LM config evenly.

    Column-parallel attention shards whole heads and row-parallel MLP
    shards hidden columns, so ``tp`` must divide ``num_heads``,
    ``num_kv_heads`` and ``d_ff``.
    """
    bad = [f"{k}={v}" for k, v in (("num_heads", cfg.num_heads),
                                   ("num_kv_heads", cfg.num_kv_heads),
                                   ("d_ff", cfg.d_ff)) if v % tp]
    if bad:
        raise ValueError(
            f"tp={tp} cannot shard config {cfg.name!r}: it must "
            f"divide " + ", ".join(bad))


def lm_param_specs(cfg, tp_axis: str = TP_AXIS) -> dict:
    """Spec tree matching :attr:`repro_torch.models.Model.params`."""
    P = PartitionSpec
    col = P(None, None, tp_axis)   # (L, d, out): split output columns
    row = P(None, tp_axis, None)   # (L, in, d): split input rows
    specs = {
        "embed": P(),
        "blocks": {
            "attn_norm": P(), "mlp_norm": P(),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "w_gate": col, "w_up": col, "w_down": row,
        },
        "final_norm": P(),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P()
    return specs


def train_state_specs(cfg, tp_axis: str = TP_AXIS) -> tuple:
    """Specs for the ``(params, opt_state)`` train state: AdamW's
    moments mirror the parameters leaf for leaf, its step counter is a
    replicated scalar."""
    p = lm_param_specs(cfg, tp_axis)
    return p, {"step": PartitionSpec(), "mu": p, "nu": p}


def flatten_specs(specs_tree) -> List[PartitionSpec]:
    """The specs of a spec tree in the order
    :func:`repro_torch.train.checkpoint.tree_flatten` gives its state's
    leaves (dict values by sorted key, tuples and lists in order)."""
    if isinstance(specs_tree, PartitionSpec):
        return [specs_tree]
    if isinstance(specs_tree, dict):
        return [s for key in sorted(specs_tree)
                for s in flatten_specs(specs_tree[key])]
    if isinstance(specs_tree, (tuple, list)):
        return [s for item in specs_tree for s in flatten_specs(item)]
    raise TypeError(f"not a spec tree node: {specs_tree!r}")


def _leaves(tree) -> list:
    from ..train.checkpoint import tree_flatten
    return tree_flatten(tree)


def specs_to_rules(specs_tree, state_tree) -> List[List[Optional[str]]]:
    """Flatten a spec tree to per-leaf axis-rule lists, each as long as
    its leaf's rank, entries an axis name or ``None``: the JSON form the
    checkpoint manifest records."""
    specs = flatten_specs(specs_tree)
    leaves = _leaves(state_tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    rules = []
    for spec, leaf in zip(specs, leaves):
        ents = list(spec) + [None] * (len(leaf.shape) - len(spec))
        rule = []
        for e in ents:
            if e is not None and not isinstance(e, str):
                raise ValueError(f"unsupported spec entry {e!r} "
                                 "(nested tuples) in checkpoint rules")
            rule.append(e)
        rules.append(rule)
    return rules


def rules_to_specs(rules) -> List[PartitionSpec]:
    """Inverse of :func:`specs_to_rules` (per leaf, flat)."""
    return [PartitionSpec(*rule) for rule in rules]


def _split_dim(spec, axis: str):
    dims = [d for d, a in enumerate(spec) if a == axis]
    return dims[0] if dims else None


def shard_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x``: split along each
    dimension ``spec`` names an axis for, at the rank's coordinate on
    that axis (a contiguous copy); a replicated tensor is ``x`` itself."""
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} is not "
                             f"divisible by mesh axis {axis!r} of size {n}")
        block = x.shape[d] // n
        i = mesh.coords[axis]
        x = x.narrow(d, i * block, block).contiguous()
    return x


def shard_state(tree, specs_tree, mesh):
    """:func:`shard_block` over every leaf of ``tree`` (specs from a spec
    tree of the same structure)."""
    from ..train.checkpoint import tree_unflatten

    specs = flatten_specs(specs_tree)
    leaves = _leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} specs for {len(leaves)} leaves")
    return tree_unflatten(tree, [shard_block(x, s, mesh)
                                 for x, s in zip(leaves, specs)])


def assemble(blocks, spec, axis: str = TP_AXIS):
    """The global tensor from its blocks in shard order along ``axis``
    (the one split axis, as the sharded checkpoint has it); a
    replicated tensor is the first block."""
    d = _split_dim(spec, axis)
    return blocks[0] if d is None else torch.cat(list(blocks), dim=d)


def assemble_state(trees, specs_tree, axis: str = TP_AXIS):
    """:func:`assemble` leaf by leaf over the local trees of the ranks
    along ``axis``, in their order."""
    from ..train.checkpoint import tree_unflatten

    specs = flatten_specs(specs_tree)
    per_rank = [_leaves(t) for t in trees]
    return tree_unflatten(trees[0], [
        assemble([leaves[i] for leaves in per_rank], spec, axis)
        for i, spec in enumerate(specs)])

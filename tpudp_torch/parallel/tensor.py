"""Partition rules and sharding choices — the port of
``tpudp/parallel/tensor.py``.

The rule tables are JAX's, as data: ``(path regex, spec)`` pairs
matched against flax parameter paths (``params/h_0/attn/qkv/kernel``),
first match wins, where a spec is a tuple over the leaf's dims in its
flax layout, each entry an axis name or None (JAX's ``PartitionSpec``;
``()`` replicates).  In the port a leaf's sharding is ``(dim, axis)``
or None (replicated): :func:`leaf_sharding` resolves a rule to that,
with JAX's fallback to replicated where the axis does not divide the
dim.  The TP step (``tpudp_torch.parallel.sharded.make_tp_train_step``)
resolves every leaf by these rules, then writes Megatron's layout by
hand for GPT-2 and ViT from :func:`gpt2_tp_rules` and for LLaMA from
:func:`llama_tp_rules`, and the channel split of a VGG or a ResNet from
:func:`vgg_tp_rules`; a model the rules split nothing of runs
replicated, as under JAX's GSPMD.

:func:`fsdp_dim` is FSDP's rule (``fsdp_shardings``): a leaf of at least
``min_size`` elements shards its first dim the axis size divides, any
other leaf stays replicated; :func:`fsdp_shardings` and
:func:`zero1_shardings` apply it to a tree (ZeRO-1: the optimizer state
only).
"""

from __future__ import annotations

import math
import re

MODEL_AXIS = "model"


def gpt2_tp_rules(model_axis: str = MODEL_AXIS) -> tuple:
    """Megatron-style rules for GPT-2 (JAX's ``gpt2_tp_rules``)."""
    col, row = (None, model_axis), (model_axis, None)
    return (
        (r"attn/qkv/kernel", col),
        (r"attn/qkv/bias", (model_axis,)),
        (r"attn/proj/kernel", row),
        (r"attn/proj/bias", ()),
        (r"mlp_fc/kernel", col),
        (r"mlp_fc/bias", (model_axis,)),
        (r"mlp_proj/kernel", row),
        (r"mlp_proj/bias", ()),
        (r"wte/embedding", (model_axis, None)),  # vocab-split
        (r"wpe/embedding", ()),
        (r"ln_\w+/(scale|bias)", ()),
    )


def llama_tp_rules(model_axis: str = MODEL_AXIS) -> tuple:
    """JAX's ``llama_tp_rules``: q/k/v, gate and up column-parallel, wo
    and down row-parallel, the untied head column-parallel over vocab."""
    col, row = (None, model_axis), (model_axis, None)
    return (
        (r"attn/w[qkv]/kernel", col),
        (r"attn/wo/kernel", row),
        (r"(gate|up)/kernel", col),
        (r"down/kernel", row),
        (r"wte/embedding", (model_axis, None)),
        (r"lm_head/kernel", col),
        (r"rms_\w+/scale", ()),
    )


def vgg_tp_rules(model_axis: str = MODEL_AXIS) -> tuple:
    """JAX's ``vgg_tp_rules``: HWIO conv kernels split their output
    channels, BatchNorm runs on the local channels, the classifier is
    column-parallel."""
    return (
        (r"Conv_\d+/kernel|stem_conv/kernel|conv\w*/kernel",
         (None, None, None, model_axis)),
        (r"Conv_\d+/bias", (model_axis,)),
        (r"BatchNorm_\d+/(scale|bias)", (model_axis,)),
        (r"(classifier|Dense_\d+)/kernel", (None, model_axis)),
        (r"(classifier|Dense_\d+)/bias", (model_axis,)),
    )


def spec_for_path(path: str, rules, ndim: int | None = None) -> tuple:
    """The first rule matching ``path`` (a spec longer than the leaf's
    ``ndim`` replicates); unmatched leaves replicate: ``()``."""
    for pattern, spec in rules:
        if spec is None:
            continue
        if re.search(pattern, path):
            if ndim is not None and len(spec) > ndim:
                return ()
            return tuple(spec)
    return ()


def leaf_sharding(path: str, shape, rules, axis_sizes: dict):
    """``(dim, axis)`` of the leaf at ``path`` under ``rules``, or None
    when it replicates: unmatched, or the axis size does not divide the
    dim (JAX's ``tree_shardings`` fallback)."""
    spec = spec_for_path(path, rules, len(shape))
    out = None
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % axis_sizes[axis]:
            return None
        out = (dim, axis)
    return out


def tree_paths(tree: dict, prefix: str = "") -> dict:
    """``{'a/b/c': leaf}`` of a nested dict (JAX's normalized paths)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_paths(v, path))
        else:
            out[path] = v
    return out


def tree_shardings(tree: dict, rules, axis_sizes: dict) -> dict:
    """``{path: (dim, axis) or None}`` for every leaf of ``tree``."""
    return {path: leaf_sharding(path, tuple(leaf.shape), rules, axis_sizes)
            for path, leaf in tree_paths(tree).items()}


def fsdp_dim(shape, n: int, min_size: int = 1024) -> int | None:
    """FSDP's rule: the first dim ``n`` divides, for a leaf of at least
    ``min_size`` elements; None (replicated) otherwise."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return None
    for dim, d in enumerate(shape):
        if d % n == 0:
            return dim
    return None


def fsdp_shardings(tree: dict, n: int, axis: str = "data", *,
                   min_size: int = 1024) -> dict:
    """``{path: (dim, axis) or None}``: every leaf by :func:`fsdp_dim`."""
    out = {}
    for path, leaf in tree_paths(tree).items():
        dim = fsdp_dim(tuple(leaf.shape), n, min_size)
        out[path] = None if dim is None else (dim, axis)
    return out


def zero1_shardings(state_tree: dict, n: int, axis: str = "data", *,
                    min_size: int = 1024) -> dict:
    """ZeRO-1 over a checkpoint tree: ``opt_state`` by
    :func:`fsdp_shardings`, everything else replicated."""
    out = {path: None for path in tree_paths(state_tree)}
    if "opt_state" in state_tree:
        out.update(fsdp_shardings({"opt_state": state_tree["opt_state"]}, n,
                                  axis, min_size=min_size))
    return out

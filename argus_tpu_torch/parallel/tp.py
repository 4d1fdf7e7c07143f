"""Tensor parallelism of the wide dense layers: a model's sharded leaves
cut to this rank's slices, and a train state gathered whole again.

`shard_model_(model, mesh)` applies `param_shardings` (the port's copy of
argus_tpu's `DEFAULT_TP_RULES`) to a model holding whole, equal weights on
every rank: each matching parameter is replaced by this rank's slice and
the model and its backbone are given the model group (`models.pose_cnn`
says what the forward then does). The Adam moments made from those
parameters are sliced alike, so a sharded leaf's optimizer state is
sharded too.

Checkpoints hold whole tensors in argus_tpu's layout: `whole_state(state,
mesh)` gathers every sharded leaf of the parameters and moments over the
model group (every rank takes part; rank 0 then writes), and
`checkpoint.restore_train_state` cuts a whole file to the state's
`shardings`, so a file loads into a run with any number of model shards.
`shard_state` cuts a whole model and its state (what `create_train_state`
does with a model axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from argus_tpu_torch.parallel.collectives import gather_whole
from argus_tpu_torch.parallel.mesh import Mesh, Shard, param_shardings


@torch.no_grad()
def shard_model_(model: nn.Module, mesh: Mesh) -> Dict[str, Shard]:
    """Cut `model`'s TP leaves in place to this rank's slices; returns
    {name: Shard} of the leaves cut ({} without a model axis), also kept as
    `model.shardings`."""
    specs = {k: s for k, s in param_shardings(model.named_parameters(), mesh).items() if s is not None}
    for name, spec in specs.items():
        owner, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(owner)
        old = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(spec.take(old.detach()), requires_grad=old.requires_grad))
    if specs:
        for mod in (model, getattr(model, "backbone", None)):
            if mod is not None:
                mod.model_group = mesh.model_group
    model.shardings = specs
    return specs


def shard_state(model: nn.Module, state, mesh: Mesh):
    """Cut a whole model and its train state (fresh or trained: the Adam
    moments are cut alike) to this rank's slices; returns the new state,
    its `shardings` the leaves cut. The state without a model axis."""
    cuts = shard_model_(model, mesh)
    if not cuts:
        return state

    def cut(d):
        return {k: cuts[k].take(v.detach()) if k in cuts else v for k, v in d.items()}

    opt = dataclasses.replace(state.opt_state, mu=cut(state.opt_state.mu), nu=cut(state.opt_state.nu))
    return dataclasses.replace(state, params=dict(model.named_parameters()), opt_state=opt, shardings=cuts)


def whole_state(state, mesh: Mesh):
    """`state` with every sharded leaf of its parameters and Adam moments
    whole (a new state; the same one when nothing is sharded). Every rank
    of the model group must call it."""
    cuts = getattr(state, "shardings", None) or {}
    if not cuts:
        return state

    def whole(d):
        return {k: gather_whole(v.detach(), cuts[k], mesh.model_group) if k in cuts else v for k, v in d.items()}

    opt = dataclasses.replace(state.opt_state, mu=whole(state.opt_state.mu), nu=whole(state.opt_state.nu))
    return dataclasses.replace(state, params=whole(state.params), opt_state=opt, shardings={})

"""Pipeline parallelism for transformer stacks over a 'pp' mesh axis
(wise_tpu/parallel/pipeline.py).

GPipe's schedule: the layers of a stack are cut into S contiguous stages,
stage s on the mesh's device ``[s, 0]``; a batch is cut
into M microbatches, and at tick t (of M + S - 1) stage s works on microbatch
t - s. The reference runs it as one ``shard_map`` program, activations hopping
stage to stage by ``ppermute``, so that ``jax.grad`` differentiates through
the schedule (pipeline.py:10-11). Here one process drives the stages of one
'dp' column: each tick issues every busy stage's layers on its own device
(the launches are asynchronous, so stages on different cards overlap), and an
activation crosses to the next stage with ``.to(device)``. Autograd records
the schedule as it runs and differentiates through it: there is no
hand-written backward schedule either. Edge ticks, which the reference
computes on clamped inputs and masks, are skipped.

Layer parameters are STACKED, as in the reference: each leaf carries a
leading (n_layers, ...) axis. :meth:`PipelinedStack.split_stages` cuts a
stacked tree into the stages' contiguous slices; the pipeline-parallel
trainer (parallel/pp_train.py) keeps each slice on its stage's device.
``remat`` recomputes each stage's application in the backward
(``torch.utils.checkpoint``), for O(S + M) fewer stored activations.

The mesh has one 'dp' column: under 'dp' each rank of a process group drives
its own column (parallel/pp_train.py narrows the mesh to the rank's), so a
mesh of several columns is refused.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint


def stack_layer_params(per_layer_params: list) -> dict:
    """Per-layer parameter dicts of one structure -> one dict whose leaves
    carry a leading (n_layers, ...) axis."""
    if not per_layer_params:
        raise ValueError("need at least one layer")
    return {k: torch.stack([p[k] for p in per_layer_params])
            for k in per_layer_params[0]}


def unstack_layer_params(stacked: dict) -> list:
    """Inverse of stack_layer_params."""
    n = next(iter(stacked.values())).shape[0]
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def extract_resblock_params(tower_params: dict, prefix: str = "resblocks."):
    """The per-layer ``resblocks.{i}.*`` leaves of a Transformer's state_dict
    (models/clip/model.py; keys relative to it) in layer order, as dicts by
    the rest of the key, and the remainder with the layers removed."""
    layers, rest = {}, {}
    for key, leaf in tower_params.items():
        if key.startswith(prefix):
            index, _, name = key[len(prefix):].partition(".")
            layers.setdefault(int(index), {})[name] = leaf
        else:
            rest[key] = leaf
    if not layers:
        raise ValueError(f"no '{prefix}*' subtrees found")
    return [layers[i] for i in sorted(layers)], rest


class PipelinedStack:
    """A transformer layer stack run pipeline-parallel over 'pp'.

    ``layer_fn(layer_params, x) -> x`` applies ONE layer. ``apply(stacked,
    x)`` takes stacked parameters (leading axis n_layers, divisible by the
    mesh's 'pp' size) or the list of the stages' slices, and a batch
    divisible by n_microbatches; it is differentiable with respect to both.
    The mesh is one 'dp' column (the module docstring says why).
    """

    def __init__(self, mesh, layer_fn: Callable, *, n_microbatches: int,
                 remat: bool = False):
        if "pp" not in mesh.axis_names or "dp" not in mesh.axis_names:
            raise ValueError("mesh needs 'pp' and 'dp' axes")
        if mesh.shape["dp"] != 1:
            raise ValueError(f"a mesh of dp={mesh.shape['dp']}: one process "
                             "drives one 'dp' column, each 'dp' rank its own")
        self.mesh = mesh
        self.layer_fn = layer_fn
        self.n_microbatches = int(n_microbatches)
        self.remat = bool(remat)
        if self.n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")

    def stage_devices(self) -> list:
        """The stages' devices, in order."""
        return [self.mesh.device(pp=s, dp=0)
                for s in range(self.mesh.shape["pp"])]

    def split_stages(self, stacked: dict) -> list:
        """Stacked parameters -> each stage's contiguous slice of layers
        (views, where they lie)."""
        n_stages = self.mesh.shape["pp"]
        n_layers = next(iter(stacked.values())).shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"pp={n_stages}")
        per = n_layers // n_stages
        return [{k: v[s * per:(s + 1) * per] for k, v in stacked.items()}
                for s in range(n_stages)]

    def place(self, stacked: dict) -> list:
        """Each stage's slice on its device."""
        return [{k: v.to(dev) for k, v in stage.items()}
                for stage, dev in zip(self.split_stages(stacked),
                                      self.stage_devices())]

    def _run_stage(self, params: dict, h):
        keys = list(params)

        def run(h, *leaves):
            for i in range(leaves[0].shape[0]):
                h = self.layer_fn({k: v[i] for k, v in zip(keys, leaves)}, h)
            return h

        leaves = [params[k] for k in keys]
        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, h, *leaves, use_reentrant=False)
        return run(h, *leaves)

    def _hop(self, y, device):
        """An activation crossing to the next stage's device."""
        return y.to(device)

    def apply(self, stacked, x):
        """GPipe over the stages: M + S - 1 ticks, stage s on microbatch
        t - s at tick t; the finished batch on x's device."""
        devs = self.stage_devices()
        n_stages, n_mb = len(devs), self.n_microbatches
        if isinstance(stacked, dict):
            stages = self.split_stages(stacked)
        else:
            stages = list(stacked)
            if len(stages) != n_stages:
                raise ValueError(f"{len(stages)} stages for pp={n_stages}")
        if x.shape[0] % n_mb:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"dp*microbatches = 1*{n_mb}")
        params = [{k: v.to(dev) for k, v in stage.items()}
                  for stage, dev in zip(stages, devs)]
        micro = x.chunk(n_mb)
        carry, done = [None] * n_stages, [None] * n_mb
        for t in range(n_mb + n_stages - 1):
            # the last stage first: each takes what the stage before it
            # finished at tick t - 1, before that stage overwrites it
            for s in reversed(range(n_stages)):
                m = t - s
                if not 0 <= m < n_mb:
                    continue
                h = micro[m].to(devs[0]) if s == 0 else carry[s]
                y = self._run_stage(params[s], h)
                if s == n_stages - 1:
                    done[m] = y
                else:
                    carry[s + 1] = self._hop(y, devs[s + 1])
        return torch.cat(done).to(x.device)

"""Pipeline-parallel CLIP contrastive training (wise_tpu/parallel/pp_train.py).

Builds on parallel/pipeline.py's GPipe stack: the two transformer towers of
the CLS-pooled causal CLIP family run pipeline-parallel over 'pp' (each
stage's contiguous layers on its device, microbatched), while the towers'
embed and head stay on the first stage's device and the batch splits over
'dp'. Each 'dp' rank is one process that drives its column's stages; the
gradients of the 'dp' ranks are averaged after the backward (what DDP does
for the one-device trainer), and the loss is the global batch's through
``gather_rows`` (parallel/train.py).

Parameters keep full interop with models/clip: ``restructure_clip_params``
reshapes a CLIP state_dict into the pipeline layout ({rest, stack} per
tower, stack leaves carrying a leading layer axis) and ``restore_clip_params``
inverts it bit for bit, so converted OpenCLIP checkpoints fine-tune
pipelined and a pipeline checkpoint serves through the extractor once
restored.

The embed and head are the towers' own (models/clip/model.py
``VisionTransformer.embed`` / ``head``, ``TextTransformer.embed`` / ``head``,
on a CLIP built with no layers), and the per-layer body IS the same
``ResidualAttentionBlock`` module, applied to each layer's slice of the
stacked parameters by ``torch.func.functional_call``.

Scope, as in the reference: vision_pool "cls", causal argmax-pooled text,
the kernels off (the reference's pp shard_map does not calibrate its Pallas
kernels; here every stage is plain PyTorch). The f32 master weights, the
optimizer and its clip are parallel/train.py's; the checkpoint's params are
the PIPELINE tree.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch
from torch.func import functional_call

from ..models.clip.config import CLIPConfig
from ..models.clip.model import CLIP, ResidualAttentionBlock, init_random_
from .mesh import Mesh
from .pipeline import (PipelinedStack, extract_resblock_params,
                       stack_layer_params, unstack_layer_params)
from .train import (_process_group, build_optimizer, clip_loss, gather_rows,
                    restore_train_checkpoint, save_train_checkpoint)

TOWERS = ("visual", "text")


def restructure_clip_params(params: dict) -> dict:
    """A CLIP state_dict (CLIP.state_dict, convert.py's output) ->
    {'visual': {'rest', 'stack'}, 'text': {'rest', 'stack'},
    'logit_scale'}: 'rest' the tower's leaves outside its transformer (keys
    relative to the tower), 'stack' its layers' leaves stacked on a leading
    (n_layers, ...) axis (keys relative to a layer)."""
    out = {"logit_scale": params["logit_scale"]}
    for tower in TOWERS:
        head = tower + "."
        sub = {k[len(head):]: v for k, v in params.items()
               if k.startswith(head)}
        tf = {k[len("transformer."):]: sub.pop(k) for k in list(sub)
              if k.startswith("transformer.")}
        layers, rest_tf = extract_resblock_params(tf)
        if rest_tf:
            raise ValueError(f"unexpected transformer leaves: "
                             f"{sorted(rest_tf)}")
        out[tower] = {"rest": sub, "stack": stack_layer_params(layers)}
    return out


def restore_clip_params(pp_params: dict) -> dict:
    """Inverse of restructure_clip_params: the CLIP state_dict (what
    ``CLIP.load_state_dict`` and the extractor's checkpoint take)."""
    out = {"logit_scale": pp_params["logit_scale"]}
    for tower in TOWERS:
        for k, v in pp_params[tower]["rest"].items():
            out[f"{tower}.{k}"] = v
        for i, layer in enumerate(
                unstack_layer_params(pp_params[tower]["stack"])):
            for k, v in layer.items():
                out[f"{tower}.transformer.resblocks.{i}.{k}"] = v
    return out


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class PipelinedCLIPTrainer:
    """CLIP contrastive fine-tuning with both towers GPipe-parallel.

    ``mesh`` carries ('pp', 'dp'); vision_layers and text_layers must each
    divide by its 'pp' size, the batch by dp * n_microbatches. A process
    drives one 'dp' column: alone, of a mesh of dp = 1; as a rank of a
    process group of the mesh's 'dp' size, the rank's column (its rows of
    the global batch).
    """

    def __init__(self, config: CLIPConfig, mesh: Mesh, *,
                 n_microbatches: int = 2, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, warmup_steps: int = 0,
                 total_steps: int = 0, grad_clip: float = 0.0,
                 remat: bool = False):
        if config.vision_pool != "cls" or not config.text_causal \
                or config.text_pool != "argmax" \
                or config.text_tower != "clip":
            raise ValueError(
                "PipelinedCLIPTrainer supports the CLS-pooled causal CLIP "
                "family (see module docstring)"
            )
        if config.fused_attention or config.fused_block:
            raise ValueError("fused kernels are not calibrated inside the "
                             "pp shard_map; disable them for pp training")
        self.config = config
        self.world, self.rank = _process_group()
        n_stages, dp = mesh.shape["pp"], mesh.shape["dp"]
        if self.world != dp:
            raise ValueError(f"{self.world} ranks on a mesh of dp={dp}")
        if self.world > 1:
            mesh = Mesh([mesh.device(pp=s, dp=self.rank)
                         for s in range(n_stages)], ("pp", "dp"),
                        (n_stages, 1))
        self.mesh = mesh
        #: this process's place among the 'dp' ranks (the CLI's batches)
        self.dp, self.dp_rank = self.world, self.rank
        self.device = mesh.device(pp=0, dp=0)
        self._opt_args = (learning_rate, weight_decay, warmup_steps,
                          total_steps, grad_clip)
        c = config
        with torch.device("meta"):
            blocks = {
                tower: ResidualAttentionBlock(
                    width, heads, c.act_name, c.torch_dtype, False, False,
                    torch.float32)
                for tower, width, heads in (
                    ("visual", c.vision_width, c.vision_heads),
                    ("text", c.text_width, c.text_heads))}

        def layer(tower, causal):
            def fn(layer_params, h):
                return functional_call(blocks[tower], layer_params,
                                       (h, h.shape[1], causal))
            return fn

        self.pipes = {
            tower: PipelinedStack(mesh, layer(tower, causal),
                                  n_microbatches=n_microbatches, remat=remat)
            for tower, causal in (("visual", False), ("text", True))}
        self.rest = self.stages = self.optimizer = None

    # -- setup -----------------------------------------------------------
    def init(self, seed: int = 0, params=None) -> "PipelinedCLIPTrainer":
        """Seeded random weights (models/clip/model.py ``init_random_`` on
        the whole CLIP, as the one-device trainer draws them) or ``params``,
        a CLIP state_dict, placed into the pipeline layout
        (:meth:`prepare`)."""
        if params is None:
            model = CLIP(self.config, param_dtype=torch.float32)
            init_random_(model, seed)
            params = model.state_dict()
        return self.prepare(params)

    def prepare(self, clip_params: dict) -> "PipelinedCLIPTrainer":
        """A CLIP state_dict into the pipeline layout: the embed and head
        on the first stage's device, each stage's layers on its own, all
        f32 masters; and the optimizer over them."""
        return self._load(restructure_clip_params(
            {k: v.detach().to(torch.float32, copy=True)
             for k, v in clip_params.items()}))

    def _load(self, pp_params: dict) -> "PipelinedCLIPTrainer":
        c = self.config
        rest = CLIP(dataclasses.replace(c, vision_layers=0, text_layers=0),
                    param_dtype=torch.float32)
        rest.load_state_dict({
            **{f"{t}.{k}": v for t in TOWERS
               for k, v in pp_params[t]["rest"].items()},
            "logit_scale": pp_params["logit_scale"]})
        self.rest = rest.to(self.device).train()
        self.stages = {
            t: [{k: torch.nn.Parameter(v.clone()) for k, v in stage.items()}
                for stage in self.pipes[t].place(pp_params[t]["stack"])]
            for t in TOWERS}
        self.optimizer = build_optimizer(
            [p for _, p in self._named()], *self._opt_args)
        return self

    def _named(self):
        """(name, parameter) of every master weight: the embed and head by
        their CLIP keys, each stage's stacked leaves as
        ``<tower>.stack<s>.<key>``."""
        yield from self.rest.named_parameters()
        for t in TOWERS:
            for s, stage in enumerate(self.stages[t]):
                for k, p in stage.items():
                    yield f"{t}.stack{s}.{k}", p

    def pp_tree(self, grads: bool = False) -> dict:
        """The pipeline tree of the master weights (or of their gradients,
        zero where none reached a weight) on the host:
        restructure_clip_params's layout."""
        def leaf(p):
            if grads:
                return (torch.zeros_like(p) if p.grad is None
                        else p.grad).detach().cpu()
            return p.detach().cpu()

        rest = {k: leaf(p) for k, p in self.rest.named_parameters()}
        out = {"logit_scale": rest.pop("logit_scale")}
        for t in TOWERS:
            head = t + "."
            out[t] = {
                "rest": {k[len(head):]: v for k, v in rest.items()
                         if k.startswith(head)},
                "stack": {k: torch.cat([leaf(stage[k])
                                        for stage in self.stages[t]])
                          for k in self.stages[t][0]}}
        return out

    # -- forward ---------------------------------------------------------
    def encode_image(self, images):
        """The vision tower's embed, the pipelined layers, its head:
        (B, embed_dim) f32, normalised."""
        v = self.rest.visual
        x = self.pipes["visual"].apply(self.stages["visual"], v.embed(images))
        return _l2_normalize(v.head(x))

    def encode_text(self, tokens):
        """The text tower's embed, the pipelined layers, its head at the
        EOT argmax: (B, embed_dim) f32, normalised."""
        t = self.rest.text
        x, eot = t.embed(tokens)
        return _l2_normalize(t.head(self.pipes["text"].apply(
            self.stages["text"], x), eot))

    def loss(self, images, tokens):
        """The loss of the global batch: on a rank, of every rank's rows."""
        img, txt = self.encode_image(images), self.encode_text(tokens)
        if self.world > 1:
            img, txt = gather_rows(img), gather_rows(txt)
        return clip_loss(img, txt, self.rest.logit_scale.exp())

    # -- training --------------------------------------------------------
    def _average_grads(self) -> None:
        """The gradients averaged over the 'dp' ranks: one all_reduce of
        them all, flat, on the first stage's device."""
        import torch.distributed as dist

        params = [p for _, p in self._named() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1).to(self.device)
                          for p in params])
        dist.all_reduce(flat)
        flat /= self.world
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))

    def train_step(self, images, tokens):
        """One optimizer step on a batch (on a rank, its rows of the global
        batch); returns the global batch's loss before the step."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        tokens = torch.as_tensor(tokens).to(self.device, torch.int64)
        self.optimizer.zero_grad()
        loss = self.loss(images, tokens)
        loss.backward()
        if self.world > 1:
            self._average_grads()
        self.optimizer.step()
        return loss.detach()

    # -- checkpoint / resume (parallel/train.py's layout; the params inside
    # are the PIPELINE tree: export a CLIP state_dict for serving with
    # restore_clip_params) -----------------------------------------------
    def save_checkpoint(self, ckpt_dir, step: int) -> Path:
        """Rank 0 writes the step; the other ranks wait for it."""
        path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
        if self.rank == 0:
            save_train_checkpoint(ckpt_dir, step, self.pp_tree(),
                                  self.optimizer.state_dict())
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()
        return path

    def restore_checkpoint(self, ckpt_dir, step: int = -1) -> int:
        """Load the latest (or the given) step; returns the step."""
        step, pp_params, opt_state = restore_train_checkpoint(ckpt_dir, step)
        self._load(pp_params)
        self.optimizer.load_state_dict(opt_state)
        return step

"""CLIP contrastive training (wise_tpu/parallel/train.py): on one device,
or data-parallel over ranks of ``torch.distributed``.

The reference's ``CLIPTrainer`` takes a mesh and lets GSPMD shard the batch
over 'dp' and the weights over 'mp'. Here the trainer takes a device, and
data parallelism is one process a rank (parallel/distributed.py): when the
default process group has more than one rank, the model runs under
``DistributedDataParallel`` on the rank's device and each rank's
``train_step`` takes its own rows of the global batch (rank r the r-th
slice). The loss is the global batch's, as the reference's (``clip_loss``
over replicated features): every rank's features are gathered with their
gradient (:func:`gather_rows`) and every rank computes the same loss.
Tensor parallelism (``_spec_for_path``, ``clip_param_shardings``) and the
pipeline-parallel trainer wait for ROADMAP Queue A item 12. What is kept,
name for name: ``build_optimizer`` (AdamW, warm-up + cosine schedule,
global-norm clip), ``clip_loss``, ``CLIPTrainer`` and the ``step_%08d``
checkpoints, here on ``torch.save`` / ``torch.load`` where the reference
uses orbax; rank 0 writes them.

**f32 master weights.** The trainer builds the towers with
``param_dtype=torch.float32`` (models/clip/model.py): every parameter is an
f32 tensor that the optimizer updates, and each use casts it to the compute
dtype with the gradient flowing back through the cast, as the reference's
flax modules do. A bf16 parameter would lose an update of lr 1e-5 whole: it
is smaller than half a bf16 ulp of most weights. The checkpoint holds the f32
tree.

**The optimizer, held to optax 0.2.6.** ``optax.adamw(schedule, wd)`` decays
every leaf (biases and LayerNorms too) and adds eps outside the root, which
is what ``torch.optim.AdamW`` over one parameter group computes. The
schedule counts from 0 at the first update. ``optax.clip_by_global_norm``
scales by ``max_norm / norm`` exactly when the norm exceeds the bound
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``), so the clip
is written out here.

PyTorch's idiom inside: the trainer owns its model and optimizer and
``train_step`` updates them in place, where the reference threads ``params``
and ``opt_state`` through a jitted function.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable

import torch

from ..models.clip.config import CLIPConfig
from ..models.clip.model import CLIP, init_random_
from ..utils.device import default_device
from .distributed import rank_device, world_env

#: the file inside a ``step_%08d`` directory
STATE_FILE = "train_state.pt"


def warmup_cosine_schedule(learning_rate: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), 0.01 * lr) as a function of the update count:
    linear from 0 to lr over the warm-up, then half a cosine down to
    0.01 * lr at ``total_steps``, constant after."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warm
    alpha = 0.0 if learning_rate == 0.0 else 0.01

    def schedule(count: int) -> float:
        if count < warm:
            return learning_rate * count / warm
        t = min(count - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return learning_rate * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Optimizer:
    """AdamW under a learning-rate schedule, after a global-norm clip: what
    ``optax.chain(clip_by_global_norm(c), adamw(schedule, wd))`` computes.
    ``count`` is the number of updates made."""

    def __init__(self, params, schedule: Callable[[int], float],
                 weight_decay: float, grad_clip: float):
        self.params = list(params)
        self.schedule, self.grad_clip, self.count = schedule, grad_clip, 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _clip(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        # g * (max_norm / norm) where the norm exceeds the bound, g otherwise;
        # a tensor factor keeps the host from waiting for the norm
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip and self.grad_clip > 0:
            self._clip()
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def build_optimizer(params, learning_rate: float, weight_decay: float,
                    warmup_steps: int = 0, total_steps: int = 0,
                    grad_clip: float = 0.0) -> Optimizer:
    """AdamW over ``params`` with an optional warm-up + cosine schedule
    (when either step count is given) and global-norm clipping."""
    if warmup_steps or total_steps:
        schedule = warmup_cosine_schedule(learning_rate, warmup_steps,
                                          total_steps)
    else:
        def schedule(count: int) -> float:
            return learning_rate
    return Optimizer(params, schedule, weight_decay, grad_clip)


def save_train_checkpoint(ckpt_dir, step: int, params, opt_state) -> Path:
    """{params, opt_state} under ``step_<N>/train_state.pt``; ``params`` is
    the f32 state_dict. Written to a temporary name first, so a reader never
    sees half a file."""
    path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (STATE_FILE + ".tmp")
    torch.save({"step": step, "params": params, "opt_state": opt_state}, tmp)
    tmp.replace(path / STATE_FILE)
    return path


def checkpoint_steps(ckpt_dir) -> list:
    """The steps that hold a torch checkpoint under ``ckpt_dir``, ascending."""
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                  if (p / STATE_FILE).is_file())


def restore_train_checkpoint(ckpt_dir, step: int = -1, map_location="cpu"):
    """The latest (or the given) step: (step, params, opt_state)."""
    d = Path(ckpt_dir).absolute()
    if step < 0:
        steps = checkpoint_steps(d)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {d}")
        step = steps[-1]
    state = torch.load(d / f"step_{step:08d}" / STATE_FILE,
                       map_location=map_location, weights_only=True)
    return step, state["params"], state["opt_state"]


def _process_group():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class _GatherRows(torch.autograd.Function):
    """Every rank's (B, ...) rows as one (W * B, ...) tensor, rank r's at
    rows r * B: an ``all_reduce`` of a zero f32 buffer that each rank fills
    at its own rows (exact: one term a row is not zero, and f32 holds the
    features of any compute dtype), since gloo reduces CUDA tensors but does
    not all-gather them. Every rank then computes the same global loss, so
    the backward sums the buffer's gradient over the ranks before it takes
    its own rows: without that sum, DDP's average would give the towers 1/W
    of their gradient and ``logit_scale``, which every rank differentiates
    whole, all of its."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        world, rank = _process_group()
        b = x.shape[0]
        buf = torch.zeros((world * b, *x.shape[1:]), dtype=torch.float32,
                          device=x.device)
        buf[rank * b:(rank + 1) * b] = x
        dist.all_reduce(buf)
        ctx.rows, ctx.dtype = (rank * b, (rank + 1) * b), x.dtype
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(grad)
        lo, hi = ctx.rows
        return grad[lo:hi].to(ctx.dtype)


def gather_rows(x):
    """The global batch's rows of ``x`` on every rank, with the gradient
    (:class:`_GatherRows`)."""
    return _GatherRows.apply(x)


def clip_loss(img_feats, txt_feats, logit_scale):
    """Symmetric InfoNCE over the batch."""
    logits = logit_scale * img_feats @ txt_feats.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    ce = torch.nn.functional.cross_entropy
    return 0.5 * (ce(logits, labels) + ce(logits.T, labels))


class CLIPTrainer:
    """Fine-tunes the CLIP towers of ``config`` on ``device`` (the card
    unless ``WISE_TORCH_DEVICE`` says otherwise; on a rank of a process
    group, the rank's device). With ``config.fused_block``
    the forward runs the saved-activation block kernels (ops/block.py
    ``*_train``) and, for an XLM-R text tower, the post-LN kernels
    (ops/postln_block.py ``*_train``); with ``fused_attention`` alone the
    attention middle's (ops/attention.py ``fused_attention_trainable``). The
    backward is plain PyTorch throughout."""

    def __init__(self, config: CLIPConfig, device=None,
                 learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: int = 0,
                 grad_clip: float = 0.0):
        self.config = config
        self.world, self.rank = _process_group()
        if device:
            self.device = torch.device(device)
        elif self.world > 1:
            self.device = rank_device(world_env()[2])
        else:
            self.device = default_device()
        self._opt_args = (learning_rate, weight_decay, warmup_steps,
                          total_steps, grad_clip)
        self.model = self._forward = None
        self.optimizer = None

    def init(self, seed: int = 0, params=None) -> "CLIPTrainer":
        """Build the f32 master model and its optimizer: seeded random
        weights (models/clip/model.py ``init_random_``), or ``params``, a
        state_dict such as ``convert.from_flax_params`` gives."""
        model = CLIP(self.config, param_dtype=torch.float32)
        if params is None:
            init_random_(model, seed)
        else:
            model.load_state_dict(params)
        self.model = self._forward = model.to(self.device).train()
        if self.world > 1:
            from torch.nn.parallel import DistributedDataParallel

            self._forward = DistributedDataParallel(self.model)
        self.optimizer = build_optimizer(self.model.parameters(),
                                         *self._opt_args)
        return self

    @property
    def params(self) -> dict:
        """The f32 master weights, by state_dict key."""
        return self.model.state_dict()

    def loss(self, images, tokens):
        """The loss of the global batch: on a rank, of every rank's rows."""
        img, txt, scale = self._forward(images, tokens)
        if self.world > 1:
            img, txt = gather_rows(img), gather_rows(txt)
        return clip_loss(img, txt, scale)

    def train_step(self, images, tokens):
        """One optimizer step on a batch: images (B, S, S, 3) float, tokens
        (B, ctx) int; on a rank, its own B rows of the global batch. Returns
        the global batch's loss before the step, a 0-d tensor on the device
        (reading it waits for the step)."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        tokens = torch.as_tensor(tokens).to(self.device, torch.int64)
        self.optimizer.zero_grad()
        loss = self.loss(images, tokens)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def save_checkpoint(self, ckpt_dir, step: int) -> Path:
        """Rank 0 writes the step; the other ranks wait for it."""
        path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
        if self.rank == 0:
            save_train_checkpoint(ckpt_dir, step, self.params,
                                  self.optimizer.state_dict())
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()
        return path

    def restore_checkpoint(self, ckpt_dir, step: int = -1) -> int:
        """Load the latest (or the given) step into this trainer; returns
        the step."""
        step, params, opt_state = restore_train_checkpoint(
            ckpt_dir, step, map_location=self.device)
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt_state)
        return step

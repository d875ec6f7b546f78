"""CLIP contrastive training (wise_tpu/parallel/train.py): on one device,
data-parallel over ranks of ``torch.distributed``, and tensor-parallel.

The reference's ``CLIPTrainer`` takes a mesh and lets GSPMD shard the batch
over 'dp' and the weights over 'mp'. Here the trainer takes a device, and
data parallelism is one process a rank (parallel/distributed.py): when the
default process group has more than one rank, the model runs under
``DistributedDataParallel`` on the rank's device and each rank's
``train_step`` takes its own rows of the global batch (rank r the r-th
slice). The loss is the global batch's, as the reference's (``clip_loss``
over replicated features): every rank's features are gathered with their
gradient (:func:`gather_rows`) and every rank computes the same loss.
What is kept, name for name: ``_spec_for_path`` and
``clip_param_shardings`` (the 'mp' sharding rule), ``build_optimizer``
(AdamW, warm-up + cosine schedule, global-norm clip), ``clip_loss``,
``CLIPTrainer`` and the ``step_%08d`` checkpoints, here on ``torch.save`` /
``torch.load`` where the reference uses orbax; rank 0 writes them. The
pipeline-parallel trainer is parallel/pp_train.py.

**Tensor parallelism** (``CLIPTrainer(..., mp=M)`` in a world of dp x M
ranks, parallel/distributed.py ``parallel_groups``). The reference's rule
(``_spec_for_path``): a 2-D leaf of ``in_proj`` or ``mlp_fc`` splits by
output column, of ``out_proj`` or ``mlp_proj`` by input row, every other leaf
is replicated; the XLM-R tower's names match none of the patterns. Where the
reference's ``P(None, 'mp')`` cuts in_proj's (D, 3D) columns in contiguous
thirds of the whole, which is not head-aligned, the port gives rank m whole
heads, [m H/mp, (m+1) H/mp) of q, of k and of v packed as its (D, 3E): the
same function in another layout, known only to ``shard_clip_params`` /
``gather_clip_params`` (and the blocks' bias columns, models/clip/model.py).
The model is built from the whole f32 master tree, each rank taking its
shards, so every rank starts from the tree one process would. The batch
splits over 'dp' only (the 'mp' ranks of a 'dp' group see the same rows);
DDP and ``gather_rows`` run over the 'dp' group. The global-norm clip sums
the squares of the sharded leaves over 'mp' and counts each replicated leaf
once; AdamW is elementwise, so it runs on the shards as they are. The
checkpoint is the whole f32 tree and its AdamW moments in the one-process
format, gathered by the 'mp' ranks of 'dp' rank 0: a ``--mp 2`` checkpoint
restores at ``--mp 1`` and serves through the extractor.

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
from ..utils.profiling import span
from .distributed import parallel_groups, rank_device, world_env

#: the file inside a ``step_%08d`` directory
STATE_FILE = "train_state.pt"


def _spec_for_path(path: str, leaf) -> tuple:
    """The reference's 'mp' rule on a state_dict key (the flax path joined
    by dots): a 2-D ``in_proj`` or ``mlp_fc`` leaf splits by output column,
    ``(None, 'mp')``; an ``out_proj`` or ``mlp_proj`` one by input row,
    ``('mp', None)``; anything else is replicated, ``()``."""
    if len(leaf.shape) == 2:
        if "in_proj" in path or "mlp_fc" in path:
            return (None, "mp")
        if "out_proj" in path or "mlp_proj" in path:
            return ("mp", None)
    return ()


def clip_param_shardings(params) -> dict:
    """{key: spec} of a state_dict (``_spec_for_path``); a spec names the
    axis alone, the mesh being the trainer's."""
    return {k: _spec_for_path(k, v) for k, v in params.items()}


def _shard_leaf(key: str, t, tp):
    """Rank ``tp.rank``'s piece of leaf ``key`` (a copy; the leaf itself
    when it is replicated)."""
    spec = _spec_for_path(key, t)
    if spec == (None, "mp"):
        cols = (tp.qkv_columns(t.shape[1] // 3) if "in_proj" in key
                else tp.columns(t.shape[1]))
        return t[:, cols].contiguous()
    if spec == ("mp", None):
        return t[tp.columns(t.shape[0])].contiguous()
    return t


def _gather_leaf(key: str, pieces: list):
    """The whole leaf from its ranks' ``pieces``, rank order."""
    spec = _spec_for_path(key, pieces[0])
    if spec == ("mp", None):
        return torch.cat(pieces, dim=0)
    if spec != (None, "mp"):
        return pieces[0]
    if "in_proj" not in key:
        return torch.cat(pieces, dim=1)
    thirds = [p.chunk(3, dim=1) for p in pieces]
    return torch.cat([third[i] for i in range(3) for third in thirds], dim=1)


def shard_clip_params(params: dict, tp) -> dict:
    """A whole state_dict -> rank ``tp.rank``'s of ``tp.size``: the head-split
    layout (module docstring). Raises where a split leaf does not divide."""
    return {k: _shard_leaf(k, v, tp) for k, v in params.items()}


def gather_clip_params(shards: list) -> dict:
    """The inverse of ``shard_clip_params``: the ranks' state_dicts, rank
    order -> the whole one (bit-equal to what was sharded)."""
    return {k: _gather_leaf(k, [s[k] for s in shards]) for k in shards[0]}


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
        #: under tensor parallelism, the 'mp' group and the parameters that
        #: are shards (:meth:`split_over`)
        self.tp, self.sharded = None, frozenset()

    def split_over(self, tp, sharded) -> None:
        """Count the parameters in ``sharded`` as shards over ``tp``'s ranks
        in the global norm: their squares are summed over the ranks, every
        other parameter's counted once."""
        self.tp, self.sharded = tp, frozenset(id(p) for p in sharded)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _norm(self, params):
        """The global norm of the parameters' gradients (on the first one's
        device: a pipeline's stages lie on several)."""
        norms = [torch.linalg.vector_norm(p.grad.float()) for p in params]
        dev = norms[0].device
        if self.tp is None:
            return torch.linalg.vector_norm(
                torch.stack([n.to(dev) for n in norms]))
        sq = {True: torch.zeros((), device=dev),
              False: torch.zeros((), device=dev)}
        for p, n in zip(params, norms):
            sq[id(p) in self.sharded] += n.to(dev).square()
        return torch.sqrt(sq[False] + self.tp.all_reduce(sq[True]))

    def _clip(self) -> None:
        params = [p for p in self.params if p.grad is not None]
        norm = self._norm(params)
        # g * (max_norm / norm) where the norm exceeds the bound, g otherwise;
        # a tensor factor keeps the host from waiting for the norm
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        by_device = {}
        for p in params:
            by_device.setdefault(p.grad.device, []).append(p.grad)
        for dev, grads in by_device.items():
            torch._foreach_mul_(grads, scale.to(dev))

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


def _process_group(group=None):
    """(world size, rank) of ``group`` (the default process group when
    None), (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group), dist.get_rank(group)
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
    whole, all of its. ``group``: the ranks whose rows are gathered (the
    'dp' group; the default group when None)."""

    @staticmethod
    def forward(ctx, x, group=None):
        import torch.distributed as dist

        world, rank = _process_group(group)
        b = x.shape[0]
        buf = torch.zeros((world * b, *x.shape[1:]), dtype=torch.float32,
                          device=x.device)
        buf[rank * b:(rank + 1) * b] = x
        dist.all_reduce(buf, group=group)
        ctx.rows, ctx.dtype = (rank * b, (rank + 1) * b), x.dtype
        ctx.group = group
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(grad, group=ctx.group)
        lo, hi = ctx.rows
        return grad[lo:hi].to(ctx.dtype), None


def gather_rows(x, group=None):
    """The global batch's rows of ``x`` on every rank of ``group``, with the
    gradient (:class:`_GatherRows`)."""
    return _GatherRows.apply(x, group)


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
    ``*_train``; their head-split forms under ``mp``) and, for an XLM-R text
    tower, the post-LN kernels (ops/postln_block.py ``*_train``); with
    ``fused_attention`` alone the attention middle's (ops/attention.py
    ``fused_attention_trainable``). The backward is plain PyTorch
    throughout. ``mp``: the ranks of the default process group that split
    the towers (module docstring); the rest of the world is 'dp'."""

    def __init__(self, config: CLIPConfig, device=None,
                 learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 warmup_steps: int = 0, total_steps: int = 0,
                 grad_clip: float = 0.0, mp: int = 1):
        self.config = config
        self.world, self.rank = _process_group()
        if mp < 1 or self.world % mp:
            raise ValueError(f"--mp {mp} does not divide {self.world} "
                             "rank(s)")
        self.mp, self.dp = mp, self.world // mp
        #: this rank's 'dp' index, and its 'dp' group (None: the default
        #: group, which is the 'dp' group without a split) and 'mp' group
        #: (None without a split)
        self.dp_rank = self.rank // mp
        self.dp_group, self.tp = (parallel_groups(mp) if mp > 1
                                  else (None, None))
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
        state_dict such as ``convert.from_flax_params`` gives. Under ``mp``
        the whole tree is made (or taken) first and each rank keeps its
        shards."""
        model = CLIP(self.config, param_dtype=torch.float32)
        if params is None:
            init_random_(model, seed)
        else:
            model.load_state_dict(params)
        if self.tp is not None:
            whole = model.state_dict()
            model = CLIP(self.config, param_dtype=torch.float32, tp=self.tp)
            model.load_state_dict(shard_clip_params(whole, self.tp))
            del whole
        self.model = self._forward = model.to(self.device).train()
        if self.dp > 1:
            from torch.nn.parallel import DistributedDataParallel

            self._forward = DistributedDataParallel(
                self.model, process_group=self.dp_group,
                broadcast_buffers=False)
        self.optimizer = build_optimizer(self.model.parameters(),
                                         *self._opt_args)
        if self.tp is not None:
            self.optimizer.split_over(self.tp, [
                p for name, p in self.model.named_parameters()
                if _spec_for_path(name, p)])
        return self

    @property
    def params(self) -> dict:
        """The f32 master weights, by state_dict key (under ``mp`` the
        rank's shards; ``whole`` gathers them)."""
        return self.model.state_dict()

    def _gather_pieces(self, t):
        """The ``mp`` pieces of ``t`` on 'mp' rank 0 (host tensors, rank
        order), None on the others; every 'mp' rank calls it."""
        import torch.distributed as dist

        nccl = dist.get_backend(self.tp.group) == "nccl"
        t = (t.detach() if nccl else t.detach().cpu()).contiguous()
        lead = self.rank - self.tp.rank
        pieces = ([torch.empty_like(t) for _ in range(self.mp)]
                  if self.tp.rank == 0 else None)
        dist.gather(t, pieces, dst=lead, group=self.tp.group)
        return None if pieces is None else [p.cpu() for p in pieces]

    def whole(self, tensors: dict):
        """``tensors`` by state_dict key (the rank's parameters, or their
        gradients) -> the whole tree on the host, on 'mp' rank 0 of each
        'dp' group (None on the other 'mp' ranks); a collective of the
        'mp' group. Without ``mp``, a host copy."""
        if self.tp is None:
            return {k: v.detach().cpu() for k, v in tensors.items()}
        out, lead = {}, self.tp.rank == 0
        for key, t in tensors.items():
            if _spec_for_path(key, t):
                pieces = self._gather_pieces(t)
                if lead:
                    out[key] = _gather_leaf(key, pieces)
            elif lead:
                out[key] = t.detach().cpu()
        return out if lead else None

    def grads(self) -> dict:
        """The parameters' gradients by state_dict key (the rank's)."""
        return {n: p.grad for n, p in self.model.named_parameters()
                if p.grad is not None}

    def _gather_rows(self, x):
        if self.dp_group is None:
            return gather_rows(x)
        return gather_rows(x, self.dp_group)

    def loss(self, images, tokens):
        """The loss of the global batch: on a rank, of every 'dp' rank's
        rows."""
        img, txt, scale = self._forward(images, tokens)
        if self.dp > 1:
            img, txt = self._gather_rows(img), self._gather_rows(txt)
        return clip_loss(img, txt, scale)

    def train_step(self, images, tokens):
        """One optimizer step on a batch: images (B, S, S, 3) float, tokens
        (B, ctx) int; on a rank, its 'dp' rank's B rows of the global batch.
        Returns the global batch's loss before the step, a 0-d tensor on the
        device (reading it waits for the step). Its three spans
        (utils/profiling.py) time the loss, the backward, and the clip and
        AdamW update, each on the host and on the device."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        tokens = torch.as_tensor(tokens).to(self.device, torch.int64)
        self.optimizer.zero_grad()
        with span("wise.train.forward", self.device):
            loss = self.loss(images, tokens)
        with span("wise.train.backward", self.device):
            loss.backward()
        with span("wise.train.optimizer", self.device):
            self.optimizer.step()
        return loss.detach()

    def _opt_whole(self) -> dict:
        """The optimizer's state with the sharded parameters' AdamW moments
        whole (on 'mp' rank 0; a collective of the 'mp' group)."""
        state = self.optimizer.state_dict()
        if self.tp is None:
            return state
        names = [n for n, _ in self.model.named_parameters()]
        adamw = state["adamw"]
        # new dicts: the packed state holds the optimizer's own per-parameter
        # dicts, which must keep their shards
        adamw["state"] = {i: dict(st) for i, st in adamw["state"].items()}
        for i, st in sorted(adamw["state"].items()):
            for k, v in st.items():
                if torch.is_tensor(v) and _spec_for_path(names[i], v):
                    pieces = self._gather_pieces(v)
                    st[k] = pieces and _gather_leaf(names[i], pieces)
        return state

    def save_checkpoint(self, ckpt_dir, step: int) -> Path:
        """Rank 0 writes the step (the whole tree, gathered by the 'mp'
        ranks of 'dp' rank 0); the other ranks wait for it."""
        path = Path(ckpt_dir).absolute() / f"step_{step:08d}"
        if self.dp_rank == 0:
            params, opt_state = self.whole(self.params), self._opt_whole()
            if self.rank == 0:
                save_train_checkpoint(ckpt_dir, step, params, opt_state)
        if self.world > 1:
            import torch.distributed as dist

            dist.barrier()
        return path

    def restore_checkpoint(self, ckpt_dir, step: int = -1) -> int:
        """Load the latest (or the given) step into this trainer (under
        ``mp``, each rank its shards of the whole tree); returns the
        step."""
        step, params, opt_state = restore_train_checkpoint(
            ckpt_dir, step, map_location="cpu" if self.tp else self.device)
        if self.tp is not None:
            params = shard_clip_params(params, self.tp)
            names = [n for n, _ in self.model.named_parameters()]
            for i, st in opt_state["adamw"]["state"].items():
                for k, v in st.items():
                    if torch.is_tensor(v):
                        st[k] = _shard_leaf(names[i], v, self.tp)
        self.model.load_state_dict(params)
        self.optimizer.load_state_dict(opt_state)
        return step

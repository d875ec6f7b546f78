"""Fine-tuning: ``CLIPTrainer.train_step`` on captioned frames.

Set-up builds one trainer (the train CLI's bf16 config: the block kernels'
training rules, f32 masters, AdamW after a global-norm clip) on the seed's
f32 masters, drives it through its first steps on the feed's first
batches, and hands that same trainer to the window. The feed is a pool of
batches made from the seed on the card: frames in [0, 1] as the train
CLI's feed yields them, and token rows as its XLM-R captions reach the
tower; every row of the pool differs, and the window cycles through it.

The reference follows the first steps after the window has closed and the
trainer is freed: each step's loss, the first gradient's norm by leaf (the
program's read from AdamW's first moment after one step, exp_avg / (1 -
beta1)), and the norm by leaf of the masters' change over the first steps
(the program's taken before the window's first step). Leaves are the
published model's: a packed in-projection counts as its query, key and
value (weights.leaf_norms).
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np

from h100bench import frames as F
from h100bench import reference, tracing, weights
from h100bench.harness import Check, Outcome, peak_bytes, sync

BETA1 = 0.9


def masters(ctx) -> dict:
    """The seed's f32 master weights, on the device."""
    import torch

    shapes = ctx.config["shapes"]
    spec = (weights.vision_spec(shapes["vision"])
            + weights.text_spec(shapes["text"]))
    out = weights.make(spec, ctx.seed, ctx.device,
                       lambda name, family: torch.float32)
    out["logit_scale"] = weights.logit_scale(ctx.device)
    return out


class Feed:
    """``pool_batches`` batches of (images (B, S, S, 3) f32 in [0, 1],
    tokens (B, L) int64) on the device, and each row's caption length."""

    def __init__(self, ctx):
        import torch

        tr, shapes = ctx.traffic, ctx.config["shapes"]
        t = shapes["text"]
        b, n = tr["batch_size"], tr["pool_batches"]
        size = shapes["vision"]["image_size"]
        frames = F.frames(ctx.seed, b * n, size)
        tokens = F.captions(ctx.seed, b * n, t["context_length"],
                            t["vocab_size"], tr["caption_tokens"],
                            t["pad_id"])
        self.lengths = (tokens != t["pad_id"]).sum(axis=1).reshape(n, b)
        self.images = (torch.from_numpy(frames).to(ctx.device).float()
                       / 255.0).reshape(n, b, size, size, 3)
        self.tokens = torch.from_numpy(tokens).to(ctx.device).reshape(n, b, -1)

    def __len__(self):
        return len(self.images)

    def batch(self, step: int):
        i = step % len(self)
        return self.images[i], self.tokens[i]


def _change_norms(params, p0) -> dict:
    return weights.leaf_norms({n: p.float() - p0[n]
                               for n, p in params.items()})


def run(ctx) -> Outcome:
    import torch
    from wise_tpu_torch.cli.train import training_clip_config
    from wise_tpu_torch.parallel.train import CLIPTrainer

    tr, port = ctx.traffic, ctx.config["port"]
    first = tr["compared_steps"]
    config = training_clip_config(port["model"], port["dtype"])
    trainer = CLIPTrainer(config, device=ctx.device,
                          learning_rate=tr["learning_rate"],
                          weight_decay=tr["weight_decay"],
                          grad_clip=tr["grad_clip"])
    p0 = masters(ctx)
    with torch.device(ctx.device):
        trainer.init(params=p0)
    del p0
    feed = Feed(ctx)
    losses, grads = [], None
    for step in range(first):
        losses.append(trainer.train_step(*feed.batch(step)))
        if step == 0:
            named = dict(trainer.model.named_parameters())
            state = trainer.optimizer.adamw.state
            # a leaf the optimizer holds no moment of got no gradient
            grads = weights.leaf_norms(
                {n: state[p]["exp_avg"] if "exp_avg" in state.get(p, {})
                 else torch.zeros_like(p) for n, p in named.items()},
                1 / (1 - BETA1))
    losses = [float(x) for x in losses]
    p0 = masters(ctx)
    change = _change_norms(trainer.params, p0)
    del p0
    sync(ctx.device)
    setup_peak = peak_bytes(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    spans = tracing.Spans()
    trace_path = ctx.tmp / "trace.json"
    step, pending, bad = first, None, 0
    with tracing.profiled(trace_path, ctx.trace):
        t0 = time.perf_counter()
        with spans.span(tracing.WINDOW):
            while True:
                with spans.span("trainer.train_step"):
                    loss = trainer.train_step(*feed.batch(step))
                step += 1
                if pending is not None:
                    # one step in flight: the host waits for the step
                    # before the one it just queued
                    with spans.span("wait.previous_loss"):
                        bad += not np.isfinite(float(pending))
                pending = loss
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            bad += not np.isfinite(float(pending))
            sync(ctx.device)
        window_s = time.perf_counter() - t0
    steps = step - first
    window_peak = peak_bytes(ctx.device)
    del trainer, loss, pending
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    b = tr["batch_size"]
    lengths = [int(n) for s in range(first, step)
               for n in feed.lengths[s % len(feed)]]
    readings = {
        "spans": dict(spans.seconds),
        "trace": tracing.read_trace(trace_path) if ctx.trace else None,
        "steps": steps,
        "samples": steps * b,
        "caption_lengths": lengths,
        "window_s": window_s,
        "window_peak_bytes": window_peak,
        "vision": ctx.config["shapes"]["vision"],
        "text": ctx.config["shapes"]["text"],
    }
    ref = reference_first_steps(ctx, feed)
    readings["compared"] = {"program": (losses, grads, change), "ref": ref}
    got = gaps(losses, grads, change, ref)
    checks = [Check(name, got[name], limit)
              for name, limit in ctx.limits.items()]
    return Outcome(
        end_to_end={"train_samples_per_s": steps * b / window_s,
                    "setup_s": t0 - ctx.t_start},
        readings=readings, checks=checks, attempted=steps, failed=bad,
        memory_peak_bytes=max(setup_peak, window_peak))


def reference_first_steps(ctx, feed, linear="f32", rows=None):
    """The reference over the feed's first batches from the seed's masters:
    (losses, {leaf: first clipped gradient's norm}, {leaf: change norm})."""
    tr = ctx.traffic
    params = masters(ctx)
    batches = [feed.batch(s) for s in range(tr["compared_steps"])]
    losses, first = reference.train_steps(
        params, ctx.config["shapes"], batches, tr["learning_rate"],
        tr["weight_decay"], tr["grad_clip"], linear=linear, rows=rows)
    change = _change_norms(params, masters(ctx))
    return losses, first, change


def gaps(losses, grads, change, ref):
    """The numbers of a run against the reference's ``ref``: the largest
    loss gap over the first steps; the first gradient's norm gap and the
    change's norm gap, each of the worst and of the median leaf, a leaf's
    gap taken against the larger of that leaf's reference
    norm and the median leaf's. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change: round-off
    alone moves them under AdamW. The limits file names the numbers that
    are compared."""
    r_losses, r_grads, r_change = ref
    loss_gap = max(abs(a - b) for a, b in zip(losses, r_losses))
    med_g = statistics.median(r_grads.values())
    grad = [abs(grads[n] - g) / max(g, med_g) for n, g in r_grads.items()]
    moved = [n for n, g in r_grads.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(r_change[n] for n in moved)
    change = [abs(change[n] - r_change[n]) / max(r_change[n], med_c)
              for n in moved]
    return {"loss_gap_max": loss_gap, "grad_norm_gap_max": max(grad),
            "grad_norm_gap_median": statistics.median(grad),
            "change_norm_gap_max": max(change),
            "change_norm_gap_median": statistics.median(change)}


def leaf_gaps(program, ref, top: int = 8):
    """The leaves that read the largest gaps, for a look at where a
    number comes from: {"grad": [...], "change": [...]} of (gap, leaf,
    program's norm, reference's norm)."""
    _, grads, change = program
    _, r_grads, r_change = ref
    med_g = statistics.median(r_grads.values())
    moved = [n for n, g in r_grads.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(r_change[n] for n in moved)
    out = {"grad": sorted(((abs(grads[n] - g) / max(g, med_g), n, grads[n],
                            g) for n, g in r_grads.items()), reverse=True),
           "change": sorted(((abs(change[n] - r_change[n])
                              / max(r_change[n], med_c), n, change[n],
                              r_change[n]) for n in moved), reverse=True)}
    return {k: v[:top] for k, v in out.items()}


def control(ctx):
    """The control's and the planted faults' readings against the float32
    reference (no program): the reference in float8 linear layers; the
    loss taken over the first half of each batch; a step that leaves the
    masters unchanged."""
    feed = Feed(ctx)
    ref = reference_first_steps(ctx, feed)
    out = {"control_fp8": gaps(*reference_first_steps(ctx, feed, "fp8"),
                               ref)}
    half = ctx.traffic["batch_size"] // 2
    out["half_batch"] = gaps(*reference_first_steps(ctx, feed, rows=(0, half)),
                             ref)
    out["state_unchanged"] = gaps(ref[0], ref[1],
                                  {n: 0.0 for n in ref[2]}, ref)
    return out

"""train CLI: contrastive CLIP fine-tuning on a project's caption metadata
(wise_tpu/cli/train.py).

Takes optimizer steps on one card (``WISE_TORCH_DEVICE=cpu`` for the CPU),
data-parallel (``--dp``), tensor-parallel (``--mp``) or pipeline-parallel
(``--pp`` with ``--microbatches``), with f32 master weights under AdamW,
checkpoints as ``step_%08d`` directories and can resume. bf16 runs go
through the saved-activation block kernels and the pooled last layer, the
XLM-R text tower of the default backbone through the post-LN kernels, and
with WISE_FUSED_BLOCK=0 the attention middle through its kernel; every
backward is plain PyTorch.

    python -m wise_tpu_torch.cli.train --project-dir P \\
        --metadata-id EK/ann/train --caption-column narration \\
        --model xlm-roberta-large-ViT-H-14 --steps 1000 --batch-size 32

    python -m wise_tpu_torch.cli.train --project-dir P \\
        --metadata-id EK/ann/train --caption-column narration \\
        --model ViT-B-32 --steps 1000 --batch-size 64

Point ``WISE_CHECKPOINT_DIR`` at a directory that holds the result as
``<model>/<pretrained>/step_*`` and the extractor serves it.

The steps run as one recording of the port's spans (utils/profiling.py):
at the end the lead rank logs a step's split into forward, backward and
optimizer, in device ms from CUDA events on a card (in host ms on the CPU;
none under ``--pp``, whose trainer has no such spans). With
``WISE_TRACE_DIR`` set each rank also writes a profiler trace of its steps
under ``$WISE_TRACE_DIR/train/``.

``--dp N`` (N > 1) starts N ranks itself, one process each, rank r on the
r-th of the mesh's devices in turn (every visible card, or the list that
``WISE_TORCH_DEVICE`` names; parallel/distributed.py picks NCCL when each
rank has a card of its own, else gloo); ``--dp -1``, the default, means one
rank a device, so one card runs the single-card trainer. Each rank decodes
and takes only its ``batch_size / dp`` rows of the global batch
(``caption_batches`` with its rank), whose loss every rank computes
(parallel/train.py), and rank 0 writes the checkpoints. Under
torchrun, the ranks are torchrun's.

``--mp M`` splits the CLIP towers' heads and MLP columns over M ranks
(parallel/train.py; the XLM-R tower stays whole); ``--dp N --mp M`` starts
N x M ranks, rank d * M + m, and ``--dp -1`` with ``--mp M`` means one 'dp'
rank for every M devices (at least one: on one card, ``--mp 2`` runs two
ranks that share it, under gloo). The 'mp' ranks of a 'dp' rank take the
same rows. The checkpoint is the whole tree, as one process writes it.

``--pp P --microbatches K`` runs both towers as P pipeline stages of K
microbatches (parallel/pp_train.py: the CLS-pooled causal CLIP family, the
kernels off, as in the reference); each 'dp' rank is one process that
drives its P stages, stage s on device s * dp + d of the mesh's devices
(repeated round and round when there are fewer: on one card the stages are
the card P times). Its checkpoint holds the pipeline tree;
``parallel.pp_train.restore_clip_params`` turns it into the tree the
extractor serves. ``--pp`` with ``--mp`` is refused, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

#: a training step's spans (parallel/train.py ``CLIPTrainer.train_step``)
PHASES = ("forward", "backward", "optimizer")


def build_parser():
    p = argparse.ArgumentParser(prog="train", description=__doc__)
    p.add_argument("--project-dir", required=True)
    p.add_argument("--metadata-id", required=True,
                   help="FOLDER/DB/TABLE with __filename/__starttime/__stoptime")
    p.add_argument("--caption-column", required=True)
    p.add_argument("--model", default="ViT-B-32")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel ranks (-1: one a device)")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel ranks that split the towers' heads "
                        "and MLP columns")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (GPipe over a 'pp' mesh "
                        "axis; excludes --mp, needs layer counts divisible "
                        "by it)")
    p.add_argument("--microbatches", type=int, default=2,
                   help="GPipe microbatches per step (only with --pp > 1)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true",
                   help="recompute transformer blocks in the backward "
                        "(about one more forward, for less activation "
                        "memory)")
    return p


def training_clip_config(model: str, dtype: str = "bfloat16", pp: int = 1,
                         remat: bool = False):
    """The train CLI's model config: bf16 fine-tuning runs the block kernels
    (their ``*_train`` rules: saved-activation forwards, plain backwards)
    and the pooled last layer by default. WISE_FUSED_BLOCK=0 /
    WISE_POOL_LAST=0 opt out; pipeline-parallel training keeps the kernels
    off, as in the reference.

    With WISE_FUSED_BLOCK=0 the attention middle stays a kernel
    (``fused_attention``, off with WISE_FUSED_ATTN=0), as the extractor's
    production config keeps it in both packages. The reference's training
    config leaves ``fused_attention`` at its default, off; the port trains
    through ``fused_attention_trainable`` instead (ROADMAP Queue C 10)."""
    from ..models.clip.config import get_clip_config

    bf16 = dtype == "bfloat16"
    return dataclasses.replace(
        get_clip_config(model),
        dtype="bfloat16" if bf16 else "float32",
        remat=remat,
        fused_attention=(
            bf16 and pp <= 1
            and os.environ.get("WISE_FUSED_ATTN", "1") != "0"
        ),
        fused_block=(
            bf16 and pp <= 1
            and os.environ.get("WISE_FUSED_BLOCK", "1") != "0"
        ),
        pool_last_block=(
            bf16 and pp <= 1
            and os.environ.get("WISE_POOL_LAST", "1") != "0"
        ),
    )


def training_tokenizer(config):
    """The captions' tokenizer. The XLM-R tower masks its pad id, 1, so its
    captions are padded with 1, as the extractor pads the queries it serves
    (models/clip/extractor.py); the reference's train CLI pads them with 0,
    which that tower reads as a real token (ROADMAP Queue C 10). Other
    towers take ``get_tokenizer``'s, as in the reference."""
    from ..models.clip.tokenizer import HashTokenizer, get_tokenizer

    if config.text_tower == "hf_xlm_roberta":
        return HashTokenizer(vocab_size=config.vocab_size,
                             context_length=config.context_length, pad_id=1)
    return get_tokenizer(None, vocab_size=config.vocab_size,
                         context_length=config.context_length)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("train")

    if args.pp > 1 and args.mp != 1:
        log.error("--pp and --mp are mutually exclusive")
        return 1
    if args.mp < 1 or args.pp < 1:
        log.error(f"--mp {args.mp} / --pp {args.pp} must be at least 1")
        return 1

    from ..parallel.distributed import maybe_initialize_distributed, spawn

    world, split, dp = _layout(args)
    ranks = dp * split
    if dp < 1 or (world > 1 and ranks != world):
        log.error(f"--dp {args.dp} --mp {args.mp} with {world} rank(s) in "
                  "the environment")
        return 1
    if args.pp > 1 and args.batch_size % (dp * args.microbatches):
        log.error(f"--batch-size {args.batch_size} must divide by "
                  f"dp*microbatches = {dp}*{args.microbatches}")
        return 1
    if args.batch_size % dp:
        log.error(f"--batch-size {args.batch_size} must divide by --dp {dp}")
        return 1
    if world > 1:
        maybe_initialize_distributed()
    elif ranks > 1:
        from torch.multiprocessing import ProcessExitedException

        try:
            spawn(_rank_main, ranks, argv)
        except ProcessExitedException as e:
            log.error(f"a rank failed: {e}")
            return e.exit_code or 1
        return 0
    return _train(args, log)


def _layout(args):
    """(ranks in the environment, processes a 'dp' rank, 'dp' ranks): a
    process a rank, 'dp' x 'mp' of them; under ``--pp`` a process a 'dp'
    rank, which drives its stages. ``--dp -1`` takes the environment's
    ranks, else one 'dp' rank for every mp x pp devices (at least one)."""
    from ..parallel.distributed import world_env
    from ..utils.device import default_devices

    world = world_env()[0]
    split = args.mp if args.pp == 1 else 1
    if args.dp != -1:
        return world, split, args.dp
    if world > 1:
        return world, split, world // split
    return world, split, max(1, len(default_devices()) // (args.mp * args.pp))


def _rank_main(argv) -> None:
    """One rank of ``--dp N`` / ``--mp M``, in a process of its own
    (parallel/distributed.py ``spawn``); a failed run ends the process with
    its code."""
    logging.basicConfig(level=logging.INFO)
    rc = _train(build_parser().parse_args(argv), logging.getLogger("train"))
    if rc:
        raise SystemExit(rc)


def _pp_trainer(args, config, dp: int):
    """The pipeline-parallel trainer of this process: the ('pp', 'dp') mesh
    over the devices (repeated round and round to pp x dp), this rank's
    'dp' column."""
    from ..parallel.mesh import get_pp_mesh
    from ..parallel.pp_train import PipelinedCLIPTrainer
    from ..utils.device import default_devices

    devices = default_devices()
    mesh = get_pp_mesh(args.pp, dp, [devices[i % len(devices)]
                                     for i in range(args.pp * dp)])
    return PipelinedCLIPTrainer(
        config, mesh, n_microbatches=args.microbatches,
        learning_rate=args.learning_rate, warmup_steps=args.warmup_steps,
        total_steps=args.steps, grad_clip=args.grad_clip, remat=args.remat,
    ).init(seed=0)


def step_split(timer) -> str:
    """A step's forward / backward / optimizer split from ``timer``'s spans:
    device ms from their CUDA events where the steps ran on a card (the
    newest it keeps), host ms otherwise."""
    names = {p: f"wise.train.{p}" for p in PHASES}
    dev = {p: timer.device_seconds(n) for p, n in names.items()}
    if all(dev.values()):
        unit, steps = "device", len(dev["forward"])
        ms = {p: 1e3 * sum(d) / len(d) for p, d in dev.items()}
    else:
        unit, steps = "host", timer.count(names["forward"])
        ms = {p: 1e3 * timer.host_seconds(n) / max(1, steps)
              for p, n in names.items()}
    split = " / ".join(f"{p} {ms[p]:.2f}" for p in PHASES)
    return f"{split} {unit} ms a step, over {steps} steps"


def _train(args, log) -> int:
    from ..parallel.train import CLIPTrainer
    from ..pipeline.train_data import caption_batches, load_caption_segments
    from ..project import WiseProject
    from ..utils.profiling import recording, trace

    project = WiseProject(args.project_dir)
    segments = load_caption_segments(
        project, args.metadata_id, args.caption_column
    )
    if not segments:
        log.error("no caption segments found")
        return 1

    config = training_clip_config(args.model, args.dtype, args.pp,
                                  remat=args.remat)
    if args.pp > 1:
        trainer = _pp_trainer(args, config, _layout(args)[2])
    else:
        trainer = CLIPTrainer(
            config, learning_rate=args.learning_rate,
            warmup_steps=args.warmup_steps, total_steps=args.steps,
            grad_clip=args.grad_clip, mp=args.mp,
        ).init(seed=0)
    lead = trainer.rank == 0
    if lead:
        log.info(f"{len(segments)} caption segments")
        if trainer.dp > 1:
            log.info(f"{trainer.dp} data-parallel ranks, "
                     f"{args.batch_size // trainer.dp} rows each")
        if args.mp > 1:
            log.info(f"{args.mp} tensor-parallel ranks a data-parallel one")
        if args.pp > 1:
            log.info(f"{args.pp} pipeline stages of {args.microbatches} "
                     "microbatches")
    start_step = 0
    ckpt_dir = args.checkpoint_dir or str(
        project.project_dir / "checkpoints" / args.model
    )
    if args.resume:
        try:
            start_step = trainer.restore_checkpoint(ckpt_dir)
            log.info(f"resumed from step {start_step}")
        except FileNotFoundError:
            log.info("no checkpoint found; starting fresh")
    tokenizer = training_tokenizer(config)

    batches = caption_batches(
        segments, tokenizer, args.batch_size, config.image_size,
        epochs=10_000, rank=trainer.dp_rank, world=trainer.dp,
    )
    t0 = time.time()
    step = start_step
    with trace("train"), recording() as timer:
        for images, tokens in batches:
            if step >= args.steps:
                break
            loss = trainer.train_step(images, tokens)
            step += 1
            if lead and (step % 10 == 0 or step == args.steps):
                log.info(
                    f"step {step}/{args.steps} loss={float(loss):.4f} "
                    f"({step - start_step}/{time.time()-t0:.0f}s)"
                )
            if args.checkpoint_every and step % args.checkpoint_every == 0:
                trainer.save_checkpoint(ckpt_dir, step)
    if lead and timer.count("wise.train.forward"):
        log.info(step_split(timer))
    if step == start_step:
        log.error(
            "no training steps ran — not enough decodable caption "
            "segments to fill a batch?"
        )
        return 1
    trainer.save_checkpoint(ckpt_dir, step)
    if lead:
        log.info(f"saved final checkpoint at step {step} to {ckpt_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

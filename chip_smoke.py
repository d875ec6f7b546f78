#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU. Serving:
OpenCLIP ViT-B/32, ViT-H/14, ViT-g-14, ViT-bigG-14, SigLIP
ViT-L-16-SigLIP-384 and the default
backbone xlm-roberta-large-ViT-H-14 (video frames, with one batch each of
ViT-L/14, ViT-B/16, ViT-L/14 at 336 px and ViT-B-16-SigLIP-256), CLAP 2023
(audio segments), and the production configuration with
WISE_FUSED_BLOCK=0. Training: CLIP fine-tuning steps of ViT-B/32 and
ViT-L/14 on the saved-activation block kernels, of the default backbone at
full width (ViT-H/14 and XLM-R large, the post-LN rules) and of ViT-B/32
with WISE_FUSED_BLOCK=0 (the attention middle's rule), and the train CLI on
the default backbone. Multi-device: the index's sharded searches and REST
server on a mesh (every card, or the one card twice), and data-parallel
training through the train CLI at --dp 2. Then the two paths whose gates ship
closed: ViT-H/14 on the padded-head block, and the embed fold. Last the two
plain-PyTorch paths: CLAP 2022 (CNN14 audio, BERT caption) and shot
detection.

    python3 chip_smoke.py                  # env, kernels, every slice
    python3 chip_smoke.py --phase kernels  # env and kernels only
    python3 chip_smoke.py --phase gemm     # env and the GEMM rows only
    python3 chip_smoke.py --phase swin     # env, the Swin rows, the audio
                                           # batch's breakdown
    python3 chip_smoke.py --phase vit_h    # env and the ViT-H/14 slice only
    python3 chip_smoke.py --phase vit_g    # env, the ViT-g-14 slice (the
                                           # doctor, a trace) and its
                                           # batch's breakdown
    python3 chip_smoke.py --phase vit_bigg # env, the ViT-bigG-14 slice and
                                           # its batch's breakdown
    python3 chip_smoke.py --phase siglip   # env, the SigLIP-384 slice and its
                                           # batch's breakdown
    python3 chip_smoke.py --phase xlmr     # env and the default backbone only
    python3 chip_smoke.py --phase hybrid   # env and WISE_FUSED_BLOCK=0 only
    python3 chip_smoke.py --phase index    # env and the 1M-vector index only
    python3 chip_smoke.py --phase multi    # env, the index (whose project it
                                           # needs) and the multi-device leg
    python3 chip_smoke.py --phase train    # env and the training steps only
    python3 chip_smoke.py --phase mp       # env, the head-split kernel rows
                                           # and tensor-parallel training
    python3 chip_smoke.py --phase pp       # env and pipeline-parallel
                                           # training only
    python3 chip_smoke.py --phase padded   # env and the padded-head block only
    python3 chip_smoke.py --phase embed_fold  # env and the embed fold only
    python3 chip_smoke.py --phase clap2022 # env and CLAP 2022 only
    python3 chip_smoke.py --phase shots    # env and shot detection only
    python3 chip_smoke.py --phase profile  # env and the audio breakdown
    python3 chip_smoke.py --phase pooled   # env, the pooled block rows and
                                           # the pooled attention alone
    python3 chip_smoke.py --phase pooled --parent  # the same from the
                                           # parent's checkout (timing)

Phases, one line each; any failure exits non-zero:

1. env: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the kernel build (nvcc, sm_90a, one process per source)
   from wise_tpu_torch/csrc.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serve paths' shapes and working dtypes, compared on the op's
   increment over its residual input: max abs error (must be <= 5% of the
   plain increment's max abs), minimum per-token cosine (must be >= 0.999),
   and ms per call of both. Planted faults must fail the same check. The
   CLIP block kernels at the ViT-B/32 vision, CLIP text and CLAP caption
   shapes, at ViT-H/14's vision (256 x 257 x 1280, head_dim 80) and text
   (8 x 77 x 1024) shapes with the split MLP pair and each of its halves,
   and the attention block at ViT-L/14's and ViT-B/16's; the SigLIP-384
   vision blocks (256 x 576 x 1024, bf16 stream, gelu_tanh, the split MLP
   and its halves; no pooled block) and text blocks (8 x 64 x 1024,
   non-causal, pooled at row 63), and ViT-L/14 at 336 px (64 x 577 x 1024,
   f32 stream, pooled at row 0), and ViT-g-14's and ViT-bigG-14's vision
   blocks (256 x 257 x 1408 and x 1664, head dims 88 and 104, f32 stream,
   the split MLP at F 5632 and 6656 and its halves, pooled at row 0);
   planted there: the head_dim-64 softmax
   scale, a query tile left unwritten (and a ragged last one), the keys
   past 272 dropped, h not activated, and at head dims 88 and 104 the last
   8 columns of every head dropped (zero in q and v). Every attention-block
   row (pooled
   ones, and the post-LN block with its key mask, included) carries
   F.scaled_dot_product_attention on the block's own q, k and v as
   ``library_ms`` (the attention part alone), every MLP-block row (the
   post-LN one included) torch.addmm on each of its two products.
   Each row also carries the least time the card could take for its work
   (``bound_ms``: the larger of its operations over 989 TFLOP/s and its
   bytes over 3.35 TB/s, from the shapes). The Swin kernels at HTSAT's
   four stages at batch 64, with the relative-bias table at std 1 and the
   planted faults zeroed logits, the shift mask dropped and rolled by one
   window (shifted blocks) and the relative bias dropped; each Swin row
   also carries each of its kernels' own device ms (``part_ms``,
   torch.profiler) and bound (stages 0-2: swin_attn_kernel and, for the
   block, swin_mlp_kernel; stage 3's chain: the window attention), and as
   ``library_ms`` ``F.scaled_dot_product_attention`` with the additive f32
   bias + mask on the same q, k, v (the attention part alone); each
   shifted stage's block also stands as a ``-map`` row on spatial rows
   through the block's token map (planted: the map rolled by one row, one
   F chunk of kernel B dropped). The post-LN
   blocks (attention block, MLP as "single" and as the split pair, each
   half) at the XLM-R shape 64 x 1024 at batch 8, 32 (training) and 256,
   and fused_short_attention at ViT-B/32's vision and text shapes (the text
   at batch 8 and at the training batch, 256), at 64 x 257
   tokens of width 1024, 1280, 1408 and 1664 and at 64 x 576 and 64 x 577
   of width 1024, with ``F.scaled_dot_product_attention``
   timed beside it (``library_ms``): these have no residual under their
   output and are held on the whole output (cosine >= 0.999, max abs error
   <= 4 bf16 ulps of the output's max abs); planted there: the key mask
   dropped, half the softmax scale, the LayerNorm's scale and bias left
   out, h not activated, the causal mask dropped, the keys past 272
   dropped. Every post-LN row that
   closes with the LayerNorm stands a second time ("-offset") on inputs
   whose closing bias carries a common offset of 200: the kernel must pass
   there too, and the residual sum rounded to bf16 before the LayerNorm
   must fail. The fused scan + top-k kernels at the index phase's database,
   1,048,576 x 512 (TOPK_ROWS: fused_topk_threshold at Q = 1, 8 and 16,
   k = 10 and 100; fused_topk at Q = 64, k = 100, f32 and bf16 storage, and
   at Q = 61 on bf16, which pads the queries to 64; both at Q = 32, k = 10
   on f32, the router's cut), and at 1,048,576 x 1280, ViT-bigG-14's
   joint space (TOPK_WIDE_ROWS: the threshold scan at Q = 1, 8 and 16, k =
   10, f32 and bf16; fused_topk at Q = 64, k = 100, both storage types;
   their launches are the wrappers' at width 1280 on the paths), each held
   against its plain version twice: on integer-valued vectors with planted
   ties (scores and rows must be identical) and on seeded unit-norm random
   vectors (scores within 2e-6, rows equal except among near-tied entries:
   ops.fused_topk.topk_agreement), with ``torch.topk(q @ db.T, k)`` timed
   beside them (``library_ms``: two library calls, used nowhere in the
   port); planted there: the n_valid mask dropped, ties resolved to the
   higher row, the threshold skip inverted, the last span left unscanned,
   and on the f32 fused_topk row a TF32-only product (torch ops) in place
   of the three-term kernel, which must fail the unit rows' 2e-6 check. The
   fused_topk rows also time the path's two kernels apart (CUDA events: the
   product into Sᵀ, the selection from it) and the merge, the
   fused_topk_threshold rows the scan without and with the merge by its
   last CTA, and a merge in torch ops beside it; every top-k row
   prints what its selection counted in one call on each database
   (fused_topk: ``overflows_*``, the (query, segment) selections that took
   the overflow branch; fused_topk_threshold: ``flushes_*``, the query
   lists that passed their capacity and were flushed).
   The GEMM (csrc/common.cuh, behind every block kernel) through its two
   one-GEMM entries, fused_ln_matmul and fused_residual_matmul, at the main
   paths' products (GEMM_SHAPES: ViT-H/14's qkv, fc and proj at 256 x 257
   rows, the XLM-R text embed's M = 512, HTSAT stage 0's K = 96), with
   ``torch.addmm`` on the same product as ``library_ms``; planted there:
   the last K step's rows of W zeroed, the last N tile left unwritten; and
   a W view off a 16-byte boundary, which both the wrapper and the C entry
   must refuse.
3. slice: a WiseProject built from seeded synthetic 224x224 uint8 frames,
   embedded by the port's OpenClipExtractor (ViT-B-32, production config,
   random weights) in batches of 256, written through the feature store and
   DB, indexed as IndexFlatIP, served by the port's REST server on
   localhost, and queried with text over HTTP. Checks the responses, that
   every block kernel launched during the run, and the served top-10 ids
   and distances against a plain-PyTorch run of the same queries in float32
   on the same weights (swaps and distances within 1e-3, plus the
   response's 3-decimal rounding).
4. audio: the same for 1,024 seeded synthetic 4 s segments at 48 kHz,
   embedded by the port's ClapExtractor (microsoft/clap/2023, production
   config: HTSAT + GPT2 at full width and depth, random weights) in the
   pipeline's audio batches of 32, searched with ``search_in=audio``; the
   Swin blocks must have launched two kernels each at stages 0-2 and the
   seven-launch chain at stage 3. Then
   one 64-segment batch through the HTSAT path of WISE_FUSED_SWIN_BLOCK=0,
   which must launch the window-attention kernel at every stage and agree
   with the block-kernel embeddings (cosine >= 0.999).

5. families: one 64-frame batch through the port's extractor for ViT-L/14,
   ViT-B/16, ViT-L/14 at 336 px (577 tokens) and ViT-B-16-SigLIP-256 (256
   tokens, MAP-pooled, width 768), full width and depth, random weights,
   frames at each model's size; embeddings against the plain-PyTorch path
   (cosine >= 0.999), kernels launched at their shapes.
6. siglip: phase 3 for ViT-L-16-SigLIP-384, upstream WISE's integration-test
   model (vision 576 tokens x 1024, 24 layers, bf16 stream, MAP pooling;
   text 64 x 1024, 12 bidirectional layers pooled at the last token, biased
   head; 32,000-token vocabulary through the hash tokenizer) on 512 frames
   at 384 px in batches of 256: the ingest must launch exactly batches x 24
   attention blocks and split MLPs and no pooled block; a text batch 11 of
   each and one pooled block at row 63. One 64-frame batch also runs the
   path of WISE_FUSED_BLOCK=0.
7. vit_h: phase 3 for OpenCLIP ViT-H/14 (vision 257 tokens x 1280, head_dim
   80, 32 layers; text 77 x 1024, 24 layers; 1024-d joint space) on 512
   frames in batches of 256; the launch counts of the ingest must equal
   batches x (layers - 1) for the attention block and the split MLP, and
   batches for the pooled block. One 64-frame batch also runs the path of
   WISE_FUSED_BLOCK=0 (as does each tower of phase 5).
7a. vit_g, vit_bigg: phase 7 for OpenCLIP ViT-g-14 (vision 257 x 1408,
   head_dim 88, 40 layers; text 77 x 1024, 24 layers; 1024-d) and
   ViT-bigG-14 (vision 257 x 1664, head_dim 104, 48 layers; text 77 x
   1280, 20 heads, 32 layers; 1280-d), each on 512 frames in 2 batches; the
   served searches must launch one fused_topk_threshold a search batch at
   the tower's width and nothing else of the top-k, and a search_batch of
   64 stored vectors at k = 100 one fused_topk, within 2e-6 of a plain
   top-k. On ViT-g-14's project the doctor CLI runs in a process of its
   own (the card, the product on it, nvcc, the kernel library, FTS5 and
   the project must pass) and one ingest batch runs inside
   utils.profiling.trace, which must write its trace.
8. xlmr: phase 3 for the reference's default backbone,
   xlm-roberta-large-ViT-H-14 (ViT-H/14's vision tower; the XLM-R large text
   tower: 64 tokens x 1024, 24 post-LN layers, 250,002-token vocabulary,
   the "mlp" projection head), 1,024 frames; a text batch must launch 24
   post-LN attention blocks and 24 MLP pairs, the batches counted apart
   from the launch counters. The MLP as "single" is held in phase 2 alone:
   at width 1024 the port's table, like the reference's, picks the split
   pair, so the path must launch it no time and the summary says 0.
9. hybrid: the production configuration with WISE_FUSED_BLOCK=0 (block
   kernels off, the attention middle a kernel) for ViT-B/32: one 256-frame
   batch and the 8 queries against the fully plain twin (min embedding
   cosine >= 0.9995); fused_short_attention must launch once for every
   non-pooled layer.

10. index: the index and query leg at deployment size. A WiseProject of
   1,048,576 vectors of 512 dimensions (256 ViT-B/32 embeddings of one
   seeded clip, the rest seeded synthetic unit vectors clustered by clip)
   written through the port's feature store and DB; ``create-index``
   through the port's CLI entry; the port's REST server, the 8 queries x 3
   and a burst, k = 10, against a plain-PyTorch run; fused_topk_threshold
   must launch once per served search batch (the batches counted apart from
   the launch counter) and fused_topk in a ``search_batch`` of 64 vectors
   at k = 100. Then the same index under bf16 and int8 storage, the
   approximate scan at recall target 0.95, and IndexIVFFlat built from the
   same store and searched at nprobe 1024. Last IndexIVFPQ from the same
   store at the reference's defaults (M 8, OPQ, int8 refine codes, rerank
   of 4 x k ADC candidates) at nprobe 1024: its plain-torch paged ADC
   (``ivfpq_search_paged``, no kernel: no top-k kernel may launch in the
   leg) must return the numpy host ADC's candidates for 8 queries, up to
   swaps between scores within 1e-5; recall@10 against the flat result with
   the flat-sibling rerank, with the int8 refine rerank and with none, the
   first at least the last; every perturbed stored frame's source found in
   its top 10 (R1@10 >= 0.9).
   multi, on the index phase's project (phase_multi): a mesh of every card
   when there are two or more, else the one card twice (two shards, two
   ranks on it; the line names the layout and the ranks' backend, NCCL for
   a card a rank, else gloo). ``sharded_scan_topk`` on the f32 and bf16
   rows (shards of the single card's copy: views of it on one card) at
   Q 1 k 10, Q 16 k 10 and Q 64 k 100 against the single card's
   ``flat_topk``: ids identical up to ties within 2e-6, scores within 2e-6,
   the routed wrapper launched once a shard, both timed by CUDA events. A
   FeatureSearchIndex on the mesh (``WISE_TORCH_DEVICE`` names it) with
   int8 storage, IndexIVFFlat and IndexIVFPQ at nprobe 1024 against the
   index phase's single-card results of the 64 queries, recall@10 beside
   theirs; the REST server on the mesh: the 8 queries' top-10 the single
   card's, the threshold scan once a shard a served batch, its HTTP p50.
   Then the train CLI at --dp 2 (it spawns its two ranks): ViT-B/32 on the
   kernel path at global batch 256, 128 rows a rank, 3 steps, against the
   single-card trainer from the same seed-0 masters and the same batches
   (whole-tree first-step gradient cosine >= 0.999, losses within 1e-3,
   the norm of each tower's and logit_scale's gradient within 1e-3 of the
   single card's, which the planted gather (its backward without the
   all_reduce) must fail, each rank's steps exactly the kernel path's
   launches; step ms and peak memory a rank), one checkpoint, which the
   extractor serves. Its
   searches' top-k launches join the index's in the kernels summary.

11. train: CLIP fine-tuning through the port's CLIPTrainer at full width
   and depth. ViT-B/32 (``training_clip_config("ViT-B-32", "bfloat16")``:
   block kernels, pooled last layer, f32 master weights) on a batch of 256
   seeded synthetic frames and hash-tokenised captions: three steps on the
   kernel path and on a plain twin (``fused_block``, ``pool_last_block``
   and ``fused_attention`` off) from one master tree, losses within 5e-2 step by step and the first
   step's gradients per parameter (cosine >= 0.95 each, >= 0.99 over the
   whole tree); a step must launch exactly 22 fused_attn_block_res, 22
   fused_mlp_block_res, one of each pooled kernel and no serve twin, the
   plain twin nothing; after one step at lr 1e-5 a master weight has moved
   by less than a bf16 ulp and its bf16 cast has not; one batch repeated for
   30 steps makes the loss fall, and below ln(batch), the loss of uniform
   logits that a collapsed model would reach; a checkpoint restored into a fresh trainer
   gives the same next loss, and the port's OpenClipExtractor serves it with
   embeddings that differ from the seed-0 weights'. Then two steps of
   ViT-L/14 at batch 32, whose width takes fused_mlp_split_res: 34
   fused_attn_block_res, 23 fused_mlp_fc_res and fused_mlp_proj, 11
   fused_mlp_block_res and the two pooled kernels a step. ms a step by CUDA
   events (forward, backward, optimizer; median) for both paths, and the
   peak device memory. Then the default backbone at full width and a
   quarter of its depth (``training_clip_config("xlm-roberta-large-ViT-H-
   14")`` at XLMR_TRAIN_DEPTH: ViT-H/14, 8 of its 32 layers at 257 x 1280,
   and XLM-R large, 6 of its 24 post-LN layers at 64 x 1024) at batch 32,
   and ViT-B/32 under WISE_FUSED_BLOCK=0
   (the attention middle a kernel, everything else plain) at batch 256:
   three steps each against a plain twin from one master tree, one trainer
   on the card at a time (the master tree and the first step's gradients
   wait on the host), with the same bars; a default-backbone step must
   launch exactly 6 fused_postln_attn_block, 6 fused_postln_fc and
   fused_postln_proj, 7 fused_attn_block_res, 7 fused_mlp_fc_res and
   fused_mlp_proj, and one fused_attn_block_pooled, a WISE_FUSED_BLOCK=0
   step 11 fused_short_attention a tower; ms a step, peak device memory and
   a step's launches by (wrapper, SP, D) for each path. Last the train CLI
   (``wise_tpu_torch.cli.train.main``) on the default backbone (at the same
   depth), 3 steps at batch 32 (its captions' segments and frames from seeded stand-ins for
   the metadata table and the decoder): exactly 3 steps' launches, and the
   port's extractor serves its checkpoint (every tensor the checkpoint's,
   cast to bf16; finite unit embeddings; the queries' text embeddings moved
   from the seed-0 weights').

   mp (phase_mp): the head-split kernel rows (MP_SHAPES: rank 0's half of
   ViT-H/14's vision tower at 32 x 257 x 1280, of ViT-B/32's at 256 x 50 x
   768 and its causal text at 256 x 77 x 512; the attention chain, the MLP's
   fc and proj halves, the pooled chain; the bound the whole block's over
   two, SDPA on the rank's heads and torch.addmm on each product slice as
   the library), then the train CLI at --mp 2 (two ranks; on one card they
   share it under gloo) on the default backbone at batch 32 (at
   XLMR_TRAIN_DEPTH) and ViT-B/32 at 256, 3 steps each at 1e-4, every rank's steps exactly the head-split launches,
   against the single card's run of the same CLI from the same masters and
   batches ([train]'s default-backbone CLI run, recorded): whole-tree
   first-step gradient cosine >= 0.999, losses within 5e-3, the towers' and
   logit_scale's gradient norms within 1.5e-2 of the single card's (about
   twice what --phase mp_witness shows the single card parting from itself
   by when only its f32 sums are reordered); the first step once more without the all_reduce of LN(x)'s
   cotangent, which must fail them; step ms and peak memory a rank; the
   checkpoint the whole tree, ViT-B/32's served.
   pp (phase_pp): the train CLI at --pp 2 --microbatches 4 on ViT-B/32 at
   256 (the kernels off, the two stages the card twice) against the single
   card's plain run, with the same bars; the first step once more with the
   activations detached between the stages, which must fail them; the
   pipeline checkpoint restored and served.

12. padded: ViT-H/14's vision tower (production config, random weights
   from seed 0) on one 64-frame batch with the padded-head block opened for
   its shape (head_dim 80 in 128-lane slots: three fused_ln_matmul, the
   attention middle at head_dim 128, fused_residual_matmul a layer): the
   run must launch exactly 93 / 31 / 31 of them, 31 split MLP pairs, one
   pooled block and no monolithic block; embeddings against the monolithic
   and the plain path (cosine >= 0.999); one layer timed against
   fused_attn_block, there and at ViT-g-14's and ViT-bigG-14's shapes
   (head dims 88 and 104); the training rule's gradients at 32 x 257 x 1280
   against autograd through the plain block (cosine >= 0.999 per tensor);
   and the three kernels' rows (phase_padded).
13. embed_fold: fused_embed_attn_block at ViT-B/32's geometry (512 x 50
   tokens, patch 32, width 768): one counted call, the kernel against its
   plain version with the stream in f32 and bf16, and timed against the
   split entry (phase_embed_fold).
14. clap2022: phase 4 for microsoft/clap/2022 (CNN14 to 2,048 channels,
   BERT-base 12 x 768 over 100 tokens, plain PyTorch, seeded weights, the
   hash tokenizer): the served top-10 against a direct run of the
   extractor, unit embeddings that are not collapsed, a float32 batch
   against the bf16 path, a caption unchanged by its padding; the ingest
   may launch no kernel of csrc/ (phase_clap2022).
15. shots: detect_shots on a seeded ten-minute 720p video at 2 fps with 40
   cuts, on the card against the planted spans and against its CPU run,
   then the detect-shots CLI on a project whose decoder is a seeded
   stand-in (phase_shots).

The kernels phase also times kernels alone inside their blocks (ALONE:
layernorm_kernel at ViT-H/14's and ViT-B/32's f32 rows beside
F.layer_norm; attention_pooled_kernel at every pooled shape of the paths
beside SDPA on the same pooled q, and called alone through
ops.block.pooled_attention at the kernel's head group and at each other,
each held to its plain version on the whole output; gather_rows_kernel at
the text tower's per-example rows beside ``y[arange, rows]``; ``alone=``
lines), checks that no static pooled row launches the gather, and the
whole run prints each one's launches on the paths. The pooled block rows
plant two more faults: the last key tile dropped (on inputs where the last
key carries a share of the attention) and, on the per-example causal rows,
the keys past each row kept. ``--phase pooled`` runs those rows alone; run
from the parent commit's checkout with ``--parent`` it times the parent's
kernels the same way, for runs in turns.

The kernels phase also holds the three training forwards at the training
shapes (TRAIN_SHAPES, ViT-H/14's at 32 x 257 x 1280 among them), output and
residual, with the faults "residual written after the activation" and
"residual left unwritten" planted, and the autograd rules' gradients against
autograd through the plain blocks (``[backward]`` lines, with the bound of
scripts/train_bounds.py): the five block rules, ViT-H/14's attention and
split-MLP rules, the two post-LN rules at 32 x 64 x 1024 and the attention
middle's at 256 x 50 x 768 and, causal, 256 x 77 x 512. Planted: a backward
that ignores the saved residual; for the recompute rules one that ignores
the saved input, one with the key mask (or the causal mask) dropped, and
for the post-LN MLP one without its activation.

The line before the last is the kernels' JSON summary ("kernels": those of
the paths, with their launches there; "off_path": the "single" post-LN MLP
rows, launches 0); the last is {"ok": true, "device": {...}}. Needs one
CUDA card; imports no JAX.

``--phase gemm`` runs the env phase and the GEMM rows alone (GEMM_SHAPES;
the kernels phase runs them too); it prints no summary. ``--phase topk``
does the same for the top-k rows (TOPK_ROWS), ``--phase swin`` for the Swin
rows (SWIN_STAGES), followed by the 64-segment audio batch's breakdown of
``--phase profile``.

``--phase profile`` runs the env phase, then breaks one 64-segment audio
batch, one 256-frame ViT-H/14 batch and one text embed of the default
backbone on the kernel path, and one train step each of ViT-B/32 (batch
256) and of the default backbone (batch 32), down on
``[profile]`` lines (see phase_profile, profile_image_batch,
profile_xlmr_text, profile_train_step); ``--phase siglip``, ``--phase
vit_g`` and ``--phase vit_bigg`` end with a 256-frame batch's of their
model; it checks only that no roll, permute or copy kernel
runs inside the audio batch's Swin blocks, and prints no summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 4096  # synthetic 224x224 frames ingested by the slice phase
MODEL_ID = "mlfoundations/open_clip/ViT-B-32/laion2b_s34b_b79k"
VIT_H_ID = "mlfoundations/open_clip/ViT-H-14/laion2b_s32b_b79k"
#: two batches of 256: the xlmr phase runs the same vision tower on 1,024
VIT_H_FRAMES = 512
#: the reference's default backbone: ViT-H/14 vision, XLM-R large text
XLMR_ID = ("mlfoundations/open_clip/xlm-roberta-large-ViT-H-14/"
           "frozen_laion5b_s13b_b90k")
XLMR_FRAMES = 1024
XLMR_MODEL = "xlm-roberta-large-ViT-H-14"
#: the default backbone's training legs ([train]'s twin and CLI runs, [mp])
#: run at full width and a quarter of its depth: two
#: gloo ranks on one card spend a step in ~124 host round trips of 42 MB at
#: 32 vision layers, which with 14 GB checkpoints put the whole smoke at
#: 1,286 s of its 1,200 on a slow host (NVIDIA H100 80GB HBM3, 700 W)
XLMR_TRAIN_DEPTH = dict(vision_layers=8, text_layers=6)
#: set while the cut is on, so that the CLI's spawned ranks take it too
TRAIN_DEPTH_ENV = "WISE_SMOKE_TRAIN_DEPTH"
#: upstream WISE's integration-test model: MAP-pooled vision at 576 tokens,
#: the bidirectional last-token text tower; two batches of 256 at 384 px
SIGLIP_ID = "mlfoundations/open_clip/ViT-L-16-SigLIP-384/webli"
SIGLIP_FRAMES = 512
#: the registry's two largest towers: vision head dims 88 (ViT-g-14, 1408
#: wide, 40 layers) and 104 (ViT-bigG-14, 1664 wide, 48 layers, a 1280-d
#: joint space); two batches of 256 each
VIT_G_ID = "mlfoundations/open_clip/ViT-g-14/laion2b_s34b_b88k"
VIT_BIGG_ID = "mlfoundations/open_clip/ViT-bigG-14/laion2b_s39b_b160k"
WIDE_FRAMES = 512
#: further towers the extended attention kernels open: one batch each, at
#: each model's own frame size
FAMILY_IDS = ["mlfoundations/open_clip/ViT-L-14/laion2b_s32b_b82k",
              "mlfoundations/open_clip/ViT-B-16/laion2b_s34b_b88k",
              "mlfoundations/open_clip/ViT-L-14-336/openai",
              "mlfoundations/open_clip/ViT-B-16-SigLIP-256/webli"]
QUERIES = ["a dog running on the beach", "people cooking in a kitchen",
           "a red car at night", "snow on the mountains", "a cat asleep",
           "children playing football", "a city street in the rain",
           "fireworks over a river"]
AUDIO_ID = "microsoft/clap/2023/four-datasets"
SEGMENTS = 1024  # synthetic 4 s segments at 48 kHz ingested by the audio phase
#: msclap 2022 (CNN14 audio, BERT caption) at full width and depth
CLAP2022_ID = "microsoft/clap/2022/msclap"
#: the shots phase's video: ten minutes at the reference's 2 fps, 720p,
#: with seeded cuts
SHOT_FRAMES, SHOT_SIZE, SHOT_CUTS = 1200, (720, 1280), 40
AUDIO_QUERIES = ["a dog barking", "rain on a window", "a violin solo",
                 "people talking in a cafe", "a car engine starting",
                 "birds singing at dawn", "applause in a hall",
                 "a door slamming"]
#: the index phase's database, and the top-k kernel rows': vectors x width
#: (a multiple of the index's group of 4096 rows, so N_pad = N)
INDEX_N, INDEX_D = 1 << 20, 512
#: the widest rows the top-k kernels take: ViT-bigG-14's joint space
WIDE_D = 1280
#: the kernels behind fused_topk, two a chunk: the product into Sᵀ (bf16
#: storage the GEMM, f32 storage the three-term TF32 product) and the
#: selection, one for both
TOPK_SOURCES = {
    "bfloat16": ("wise_tpu_torch/csrc/common.cuh gemm_kernel + "
                 "wise_tpu_torch/csrc/topk_kernels.cu topk_select_kernel"),
    "float32": ("wise_tpu_torch/csrc/topk_kernels.cu topk_gemm_f32_kernel + "
                "wise_tpu_torch/csrc/topk_kernels.cu topk_select_kernel")}
#: wrapper -> (source, TPU kernel it replaces); a row may name its own
#: source (the fused_topk rows: TOPK_SOURCES by storage)
KERNELS = {
    "fused_topk": (" ; ".join(TOPK_SOURCES.values()),
                   "wise_tpu/ops/pallas_topk.py:82"),
    "fused_topk_threshold": ("wise_tpu_torch/csrc/topk_kernels.cu "
                             "topk_scan_kernel",
                             "wise_tpu/ops/pallas_topk.py:221"),
    "fused_attn_block": ("wise_tpu_torch/csrc/block_kernels.cu",
                         "wise_tpu/ops/block.py:466"),
    "fused_mlp_block": ("wise_tpu_torch/csrc/block_kernels.cu",
                        "wise_tpu/ops/block.py:916"),
    "fused_attn_block_pooled": ("wise_tpu_torch/csrc/block_kernels.cu",
                                "wise_tpu/ops/block.py:634"),
    "fused_attn_block_pooled_dyn": ("wise_tpu_torch/csrc/block_kernels.cu",
                                    "wise_tpu/ops/block.py:811"),
    "fused_mlp_split": ("wise_tpu_torch/csrc/block_kernels.cu",
                        "wise_tpu/ops/block.py:1209"),
    "fused_mlp_fc": ("wise_tpu_torch/csrc/block_kernels.cu",
                     "wise_tpu/ops/block.py:1129"),
    "fused_mlp_proj": ("wise_tpu_torch/csrc/block_kernels.cu",
                       "wise_tpu/ops/block.py:1158"),
    "fused_swin_block": ("wise_tpu_torch/csrc/swin_kernels.cu",
                         "wise_tpu/ops/swin_block.py:227"),
    "fused_window_attention": ("wise_tpu_torch/csrc/swin_kernels.cu",
                               "wise_tpu/ops/swin_attention.py:129"),
    "fused_postln_attn_block": ("wise_tpu_torch/csrc/postln_kernels.cu",
                                "wise_tpu/ops/postln_block.py:184"),
    "fused_postln_mlp_block": ("wise_tpu_torch/csrc/postln_kernels.cu",
                               "wise_tpu/ops/postln_block.py:277"),
    "fused_postln_mlp_split": ("wise_tpu_torch/csrc/postln_kernels.cu",
                               "wise_tpu/ops/postln_block.py:277"),
    "fused_postln_fc": ("wise_tpu_torch/csrc/postln_kernels.cu",
                        "wise_tpu/ops/postln_block.py:257"),
    "fused_postln_proj": ("wise_tpu_torch/csrc/postln_kernels.cu",
                          "wise_tpu/ops/postln_block.py:265"),
    "fused_short_attention": ("wise_tpu_torch/csrc/block_kernels.cu",
                              "wise_tpu/ops/attention.py:125"),
    "fused_attn_block_res": ("wise_tpu_torch/csrc/block_kernels.cu",
                             "wise_tpu/ops/block.py:1586"),
    "fused_mlp_block_res": ("wise_tpu_torch/csrc/block_kernels.cu",
                            "wise_tpu/ops/block.py:1635"),
    "fused_mlp_split_res": ("wise_tpu_torch/csrc/block_kernels.cu",
                            "wise_tpu/ops/block.py:1681"),
    "fused_mlp_fc_res": ("wise_tpu_torch/csrc/block_kernels.cu",
                         "wise_tpu/ops/block.py:1708"),
    "fused_ln_matmul": ("wise_tpu_torch/csrc/block_kernels.cu",
                        "wise_tpu/ops/block.py:1303"),
    "fused_residual_matmul": ("wise_tpu_torch/csrc/block_kernels.cu",
                              "wise_tpu/ops/block.py:1340"),
    "fused_embed_attn_block": ("wise_tpu_torch/csrc/block_kernels.cu",
                               "wise_tpu/ops/embed_block.py:138"),
    # the head-split entries (--mp): the same Pallas kernels under the
    # reference's 'mp' sharding (wise_tpu/parallel/train.py:31-46)
    "fused_attn_block_mp": ("wise_tpu_torch/csrc/block_kernels.cu "
                            "wt_attn_block_partial",
                            "wise_tpu/ops/block.py:1586"),
    "fused_mlp_fc_mp": ("wise_tpu_torch/csrc/block_kernels.cu wt_mlp_fc_res",
                        "wise_tpu/ops/block.py:1635"),
    "fused_mlp_proj_mp": ("wise_tpu_torch/csrc/block_kernels.cu "
                          "wt_mlp_proj_partial",
                          "wise_tpu/ops/block.py:1635"),
    "fused_attn_block_pooled_mp": ("wise_tpu_torch/csrc/block_kernels.cu "
                                   "wt_attn_block_pooled_partial",
                                   "wise_tpu/ops/block.py:634"),
    "fused_attn_block_pooled_dyn_mp": ("wise_tpu_torch/csrc/block_kernels.cu "
                                       "wt_attn_block_pooled_partial",
                                       "wise_tpu/ops/block.py:811"),
}
#: HTSAT's window batches at batch 64: (tag, windows N, C, heads, n_win of
#: the shift mask or None); L = 64 tokens (window 8) throughout
SWIN_STAGES = [("stage0", 4096, 96, 4, None),
               ("stage0-shifted", 4096, 96, 4, 64),
               ("stage1-shifted", 1024, 192, 8, 16),
               ("stage2-shifted", 256, 384, 16, 4),
               ("stage3", 64, 768, 32, None)]
#: the kernels one HTSAT block must launch, by whether its C is at most
#: 384: two on stages 0-2, the seven-launch chain on stage 3 (PERF.md)
SWIN_BLOCK_KERNELS = {
    True: {"swin_attn_kernel": 1, "swin_mlp_kernel": 1},
    False: {"layernorm_kernel": 2, "gemm_kernel": 4,
            "window_attention_kernel": 1}}
#: kernel B's F columns a chunk (csrc/swin_kernels.cu kMlpChunk): the
#: planted fault drops the second chunk
SWIN_MLP_CHUNK = 64


#: published dense peaks of one H100 SXM: bf16 operations/s, HBM bytes/s
PEAK_OPS, PEAK_BYTES = 989e12, 3.35e12
#: f32 operations/s outside the tensor cores (the scan kernel on f32 rows)
PEAK_OPS_F32 = 67e12
#: TF32 operations/s on the tensor cores (fused_topk's f32 product: three
#: TF32 products for one f32 one)
PEAK_OPS_TF32 = 495e12


class PhaseError(RuntimeError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _timed(phase: str, fn, *args, **kwargs):
    """Run one phase and print the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    say("time", name=phase, seconds=f"{time.perf_counter() - t0:.1f}")
    return out


def phase_env(torch, verbose_build: bool) -> str:
    from wise_tpu_torch.ops import build

    card = card_line()
    t0 = time.perf_counter()
    build.build(verbose=verbose_build)
    build.load_library()
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        build_s=f"{time.perf_counter() - t0:.3f}",
        nvcc_s=f"{build.build_seconds:.3f}")
    return card


def _cuda_ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _block_inputs(torch, b, sp, d, dtype, seed, mlp=False, x_std=1.0):
    """x ~ N(0, x_std²); kernels at 1/sqrt(fan_in), as init_random_ draws
    them, so that each block adds about as much as x carries; biases and the
    LayerNorm offsets N(0, 0.02)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    x = r(b, sp, d, scale=x_std).to(dtype)
    ln = (1.0 + r(d), r(d))
    w = (r(*first, scale=d ** -0.5), r(first[1]), r(f, d, scale=f ** -0.5),
         r(d))
    return x, ln, tuple(t.to(torch.bfloat16) for t in w)


def _zero_q(w, d):
    """wqkv and bqkv with the q columns zeroed: every logit 0, so softmax
    attends uniformly over the unmasked keys."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :d] = 0
    bqkv[:d] = 0
    return (wqkv, bqkv, *w[2:])


def _bound(ops: float, nbytes: float, peak_ops: float = PEAK_OPS):
    """(ms, which) of the least time the card could take: the larger of the
    operations over the peak of their type (bf16 unless given) and the bytes
    over the memory rate."""
    by_ops, by_bytes = 1e3 * ops / peak_ops, 1e3 * nbytes / PEAK_BYTES
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def _check_row(torch, results, name, tag, key, x, kernel, plain, base,
               faults, work, library=None, parts=()):
    """Hold ``kernel()`` against ``plain()`` on their increment over
    ``base`` (ops.block.increment_agreement), or with ``base`` None on the
    whole output (ops.block.output_agreement: a post-LN block, the attention
    middle). Every zero-argument callable in ``faults`` (a planted fault)
    must fail the same check: it returns the faulty output, held against
    ``plain()``, or (faulty output, reference, kernel output) on inputs of
    its own, where the kernel's output must pass and the faulty one fail.
    Times both with CUDA events and appends the row to ``results``. ``work``
    is the call's (operations, bytes): each input read once, each output
    written once. ``library`` is the one PyTorch call that computes the same
    function, where there is one (timed as ``library_ms``, used nowhere in
    the port); a residual block has none, and the rows of a GEMM or a half
    of a block carry torch.addmm on their product alone. ``parts`` are
    ``(kernel name, (operations, bytes))`` of kernels inside the call, each
    of whose device ms a call (torch.profiler's self time, _device_kernels)
    and bound stand on the row beside the call's (``part_ms``,
    ``part_bound_ms``, in the order of ``part``)."""
    from wise_tpu_torch.ops.block import (increment_agreement,
                                          output_agreement)

    def agree(got, want):
        if base is None:
            return output_agreement(got, want)
        return increment_agreement(got, want, base)

    def plant(fault, want):
        out = fault()
        if not isinstance(out, tuple):
            return agree(out, want)
        bad, ref, good = out
        return dict(agree(bad, ref), control_ok=agree(good, ref)["ok"])

    with torch.inference_mode():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise PhaseError(f"{name}[{tag}]: {tuple(got.shape)} {got.dtype} "
                             f"vs {tuple(want.shape)} {want.dtype}")
        check = agree(got, want)
        planted = {k: plant(f, want) for k, f in faults.items()}
        ms = _cuda_ms(torch, kernel, 20)
        plain_ms = _cuda_ms(torch, plain, 20)
        library_ms = _cuda_ms(torch, library, 20) if library else None
    caught = not any(c["ok"] or not c.get("control_ok", True)
                     for c in planted.values())
    ok = check["ok"] and caught
    bound_ms, bound_by = _bound(*work)
    more = {}
    if parts:
        for _ in range(3):  # a profile may now and then record no kernel
            found = _device_kernels(torch, kernel)
            part_ms = [sum(k[0] for k in found if kname in k[2])
                       for kname, _ in parts]
            if all(part_ms):
                break
        bounds = [_bound(*work) for _, work in parts]
        more = dict(part=",".join(kname for kname, _ in parts),
                    part_ms=",".join(f"{v:.4f}" if v else "not measured"
                                     for v in part_ms),
                    part_bound_ms=",".join(f"{b:.4f}" for b, _ in bounds),
                    part_bound_by=",".join(by for _, by in bounds))
    say("kernels", name=f"{name}[{tag}]",
        shape="x".join(map(str, x.shape)), dtype=str(x.dtype)[6:],
        max_abs_err=f"{check['max_abs_err']:.6g}",
        err_bound=f"{check['err_bound']:.6g}",
        min_cos=f"{check['min_cos']:.6f}",
        planted_min_cos=",".join(f"{k}:{c['min_cos']:.4f}"
                                 for k, c in planted.items()),
        planted="FAIL(expected)" if caught else "PASSED(wrong)",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        library_ms="none" if library_ms is None else f"{library_ms:.4f}",
        **more, status="ok" if ok else "FAIL")
    results.append(dict(name=name, tag=tag, key=key,
                        max_abs_err=check["max_abs_err"], ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, ok=ok))


#: the block kernels' serve shapes. ViT-B/32: vision (B=256 bucket, f32
#: stream), CLIP text and the CLAP caption tower (B=8, SP=77, bf16 stream,
#: causal). ViT-H/14: vision (257 tokens, head_dim 80) and text (width
#: 1024), whose MLP is the split pair. ViT-L/14 and ViT-B/16: the attention
#: block alone, at the batch the families phase runs. SigLIP-384: vision
#: (576 tokens, bf16 stream, gelu_tanh; no pooled layer: ``pooled`` False)
#: and text (64 tokens, non-causal, pooled at the static row 63); ViT-L/14 at
#: 336 px (577 tokens: the last query tile holds one row) at the families
#: batch. Every attention-block row carries F.scaled_dot_product_attention
#: on the block's own q, k and v as ``library_ms`` (the attention part
#: alone; for the per-example pooled block with each example's row and its
#: causal mask), and every MLP-block row torch.addmm on each of its two
#: products (the products alone, one after the other).
#: ``x_std``: the stream's scale. The LayerNorm makes a block's increment
#: independent of it, and over 576 keys the attention averages ~200 of them:
#: at x ~ N(0, 1) the increment's max is ~1/10 of x's, so 5% of it falls
#: under one bf16 ulp of the output at |x| >= 4 (0.031), where a bf16
#: stream's kernel and plain version, which round the residual sum at other
#: points, part by that ulp. SigLIP's rows draw x at std 0.25, which brings
#: the increment back to about the scale of x.
BLOCK_SHAPES = {
    "vision": dict(b=256, sp=50, d=768, heads=12, f32=True, causal=False,
                   act="gelu", seeds=(1, 11, 3)),
    "text": dict(b=8, sp=77, d=512, heads=8, f32=False, causal=True,
                 act="gelu", seeds=(2, 12, 4)),
    "caption": dict(b=8, sp=77, d=768, heads=12, f32=False, causal=True,
                    act="gelu_tanh", seeds=(5, 15, 6)),
    "vit_h": dict(b=256, sp=257, d=1280, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(31, 32, 33)),
    "vit_h_text": dict(b=8, sp=77, d=1024, heads=16, f32=False, causal=True,
                       act="gelu", seeds=(34, 35, 36)),
    "vit_l": dict(b=64, sp=257, d=1024, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(37, 0, 0), only_attn=True),
    "vit_b16": dict(b=64, sp=197, d=768, heads=12, f32=True, causal=False,
                    act="gelu", seeds=(38, 0, 0), only_attn=True),
    "siglip": dict(b=256, sp=576, d=1024, heads=16, f32=False, causal=False,
                   act="gelu_tanh", seeds=(61, 62, 0), pooled=False,
                   x_std=0.25),
    "siglip_text": dict(b=8, sp=64, d=1024, heads=16, f32=False,
                        causal=False, act="gelu_tanh", seeds=(63, 64, 65),
                        pool_row=63),
    "vit_l336": dict(b=64, sp=577, d=1024, heads=16, f32=True, causal=False,
                     act="gelu", seeds=(66, 67, 68)),
    "vit_g": dict(b=256, sp=257, d=1408, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(71, 72, 73)),
    "vit_bigg": dict(b=256, sp=257, d=1664, heads=16, f32=True,
                     causal=False, act="gelu", seeds=(74, 75, 76)),
}
#: head dims the attention kernels carry zero-filled to the next multiple
#: of 16 columns: rows there plant a kernel that drops the last 8
WIDE_HEAD_DIMS = (88, 104)
#: the gate before SigLIP: rows over it plant a kernel that drops the keys
#: past it
OLD_MAX_SEQ = 272
#: bytes of one LayerNorm's f32 scale and bias, per channel
_LN_BYTES = 8


def _attn_work(b, sp, d, xb, keys, pooled=False):
    """(operations, bytes) of the attention block on x (b, sp, d) of ``xb``
    bytes an element, each query attending to ``keys`` keys on average
    (causal: what the mask leaves). Pooled: k/v for every row, q, attention
    and out-proj for one row an example."""
    m = b * sp
    weights = (4 * d * d + 4 * d) * 2 + _LN_BYTES * d
    if pooled:
        return (4 * m * d * d + 4 * b * d * d + 4 * b * keys * d,
                m * d * xb + b * d * xb + weights)
    return 8 * m * d * d + 4 * m * keys * d, 2 * m * d * xb + weights


def _mlp_work(m, d, f, xb, half=None):
    """(operations, bytes) of the MLP block on m rows; ``half`` "fc" (x in,
    h out) or "proj" (h and x in, out)."""
    if half == "fc":
        return (2 * m * d * f,
                m * d * xb + (d * f + f) * 2 + _LN_BYTES * d + m * f * 2)
    if half == "proj":
        return 2 * m * d * f, m * f * 2 + (d * f + d) * 2 + 2 * m * d * xb
    return (4 * m * d * f,
            2 * m * d * xb + (2 * d * f + f + d) * 2 + _LN_BYTES * d)


def _wrong_scale(w, d, hd):
    """wqkv and bqkv with the q columns scaled so that the logits come out
    as if the softmax scale were 1/8 (head_dim 64's) instead of
    1/sqrt(hd)."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, :d] *= 0.125 * math.sqrt(hd)
    bqkv[:d] *= 0.125 * math.sqrt(hd)
    return (wqkv, bqkv, *w[2:])


def _head_tail_dropped(w, d, hd):
    """wqkv and bqkv with the last 8 columns of every head zeroed in the q
    and v slots: what a kernel that took hd // 16 k16 steps and n-tile
    pairs alone at head_dim 88 or 104 would compute (those columns in no
    logit, the output's zero)."""
    wqkv, bqkv = w[0].clone(), w[1].clone()
    for slot in (0, 2):
        cols = wqkv[:, slot * d:(slot + 1) * d].view(-1, d // hd, hd)
        cols[..., hd - 8:] = 0
        bqkv[slot * d:(slot + 1) * d].view(d // hd, hd)[:, hd - 8:] = 0
    return (wqkv, bqkv, *w[2:])


def _sdpa_of_block(torch, x, ln, w, heads, causal, row=None, rows=None,
                   km=None):
    """F.scaled_dot_product_attention on the attention block's own q, k, v
    (the post-bias in-projection of LN(x), as (B, H, SP, hd) views; with
    ``row`` q of that row alone, with ``rows`` (B,) q of each example's row
    and the keys up to it): the library call for the attention part of a
    block row. With ``km`` (B, 1, SP), a post-LN block's additive key mask,
    the in-projection is of x itself and the mask goes in as a boolean."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from wise_tpu_torch.ops import block as K

    with torch.inference_mode():
        qkv = (x @ w[0] + w[1] if km is not None
               else K.qkv_stage(x, *ln, *w[:2]))
    b, sp, d3 = qkv.shape
    q, k, v = (t.reshape(b, sp, heads, d3 // 3 // heads).transpose(1, 2)
               for t in qkv.split(d3 // 3, dim=-1))
    mask = None
    if km is not None:
        mask = (km == 0)[:, None]
    if row is not None:
        q = q[:, :, row:row + 1]
    if rows is not None:
        q = q[torch.arange(b, device=x.device), :, rows.long()][:, :, None]
        mask = (torch.arange(sp, device=x.device)[None, :]
                <= rows.long()[:, None])[:, None, None]
        causal = False
    return lambda: sdpa(q, k, v, attn_mask=mask, is_causal=causal)


def _sdpa_bshd(torch, q, k, v, heads, causal):
    """F.scaled_dot_product_attention on (B, SP, D) q, k, v as (B, H, SP,
    hd) views, back as (B, SP, D): the attention middle's library call."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, sp, d = q.shape
    q4, k4, v4 = (t.view(b, sp, heads, d // heads).transpose(1, 2)
                  for t in (q, k, v))
    return sdpa(q4, k4, v4, is_causal=causal).transpose(1, 2).reshape(
        b, sp, d)


def _addmm_pair(torch, y, fc, h, proj):
    """The library yardstick of an MLP row: torch.addmm on each of its two
    products (y @ wfc + bfc, then h @ wproj + bproj, on the block's own
    bf16 operands), the products alone."""
    first, second = _addmm(torch, y, *fc), _addmm(torch, h, *proj)
    return lambda: (first(), second())


def _block_rows(torch, results, tag, s):
    """The attention and MLP blocks at one shape, and its pooled block
    (static row 0 for vision, or ``pool_row``; per-example rows for the
    causal towers; none with ``pooled`` False); the MLP is the wrapper
    ``mlp_choice`` gives the width, and the split pair also goes half by
    half. Planted faults: the kernel with its logits zeroed (for the MLP:
    its activation dropped), a block that returns its residual input; at
    head_dim 80 the head_dim-64 softmax scale; over 64 tokens a query tile
    (rows 64..127) left as the residual input, and a ragged last query tile
    so left; over OLD_MAX_SEQ tokens the keys past it dropped."""
    from wise_tpu_torch.ops import block as K

    b, sp, d, h, causal = s["b"], s["sp"], s["d"], s["heads"], s["causal"]
    dtype = torch.float32 if s["f32"] else torch.bfloat16
    xb = 4 if s["f32"] else 2
    seed_attn, seed_mlp = s["seeds"][:2]
    x_std = s.get("x_std", 1.0)
    kw = dict(heads=h, n_valid=sp, causal=causal)
    keys = (sp + 1) / 2 if causal else sp

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, seed_attn, x_std=x_std)

    def attn(w=w, n_valid=sp):
        return K.fused_attn_block(x, *ln, *w, **{**kw, "n_valid": n_valid})

    def rows_left(lo, hi):
        out = attn().clone()
        out[:, lo:hi] = x[:, lo:hi]
        return out

    faults = {"faulted_kernel": lambda: attn(_zero_q(w, d)),
              "block_skipped": lambda: x}
    if d // h != 64:
        faults["scale_of_hd64"] = lambda: attn(_wrong_scale(w, d, d // h))
    if d // h in WIDE_HEAD_DIMS:
        faults["last_8_head_cols_dropped"] = lambda: attn(
            _head_tail_dropped(w, d, d // h))
    if sp > 64:
        faults["tile_dropped"] = lambda: rows_left(64, 128)
    if sp > 64 and sp % 64:
        faults["last_tile_dropped"] = lambda: rows_left(sp - sp % 64, sp)
    if sp > OLD_MAX_SEQ:
        faults["keys_past_272_dropped"] = lambda: attn(n_valid=OLD_MAX_SEQ)
    library = _sdpa_of_block(torch, x, ln, w, h, causal)
    _check_row(torch, results, "fused_attn_block", tag,
               ("fused_attn_block", sp, d), x, attn,
               lambda: K.plain_attn_block(x, *ln, *w, **kw), x, faults,
               _attn_work(b, sp, d, xb, keys), library=library)
    del library
    if s.get("only_attn"):
        return

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, seed_mlp, mlp=True,
                             x_std=x_std)
    act, f = s["act"], 4 * d
    fc, proj = w[:2], w[2:]
    with torch.inference_mode():
        y = K.layer_norm_f32(x, *ln).to(torch.bfloat16)
        hid = K.plain_mlp_fc(x, *ln, *fc, act=act)
    library = _addmm_pair(torch, y, fc, hid, proj)
    if K.mlp_choice(d) == "single":
        _check_row(torch, results, "fused_mlp_block", tag,
                   ("fused_mlp_block", sp, d), x,
                   lambda: K.fused_mlp_block(x, *ln, *w, act=act),
                   lambda: K.plain_mlp_block(x, *ln, *w, act=act), x,
                   {"faulted_kernel": lambda: K.fused_mlp_block(
                       x, *ln, *w, act="none"),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb), library=library)
    else:
        _check_row(torch, results, "fused_mlp_split", tag,
                   ("fused_mlp_split", sp, d), x,
                   lambda: K.fused_mlp_split(x, *ln, *w, act=act),
                   lambda: K.plain_mlp_split(x, *ln, *w, act=act), x,
                   {"h_not_activated": lambda: K.fused_mlp_split(
                       x, *ln, *w, act="none"),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb), library=library)
        # the first half has no residual: its increment is its whole output
        _check_row(torch, results, "fused_mlp_fc", tag,
                   ("fused_mlp_fc", sp, d), x,
                   lambda: K.fused_mlp_fc(x, *ln, *fc, act=act),
                   lambda: K.plain_mlp_fc(x, *ln, *fc, act=act),
                   torch.zeros((), device="cuda"),
                   {"h_not_activated": lambda: K.fused_mlp_fc(
                       x, *ln, *fc, act="none")},
                   _mlp_work(b * sp, d, f, xb, "fc"),
                   library=_addmm(torch, y, *fc))
        with torch.inference_mode():
            raw = K.plain_mlp_fc(x, *ln, *fc, act="none")
        _check_row(torch, results, "fused_mlp_proj", tag,
                   ("fused_mlp_proj", sp, d), x,
                   lambda: K.fused_mlp_proj(hid, *proj, x),
                   lambda: K.plain_mlp_proj(hid, *proj, x), x,
                   {"h_not_activated": lambda: K.fused_mlp_proj(
                       raw, *proj, x),
                    "block_skipped": lambda: x},
                   _mlp_work(b * sp, d, f, xb, "proj"),
                   library=_addmm(torch, hid, *proj))
        del raw
    del y, hid, library

    if s.get("pooled", True) is not False:
        _pooled_rows(torch, results, tag, s)


#: the per-example pooled rows of the causal towers' shapes (B = 8): the
#: last token, the first, and rows between
DYN_ROWS = [3, 76, 0, 40, 11, 76, 25, 7]


def _last_key_inputs(torch, x, ln, w, rows, d):
    """Inputs of the pooled block's own, (x, ln, w), on which its last key
    carries a share of the attention: each example's pooled row as in x;
    the last row that row plus half the next one (where the last row is not
    itself the pooled row); every other row constant, which the LayerNorm
    maps to its bias (zero here); the k projection the q one, and the k and
    v biases zero. So the other keys have logit 0 and v 0, the pooled row's
    own key a logit of |q|² / sqrt(hd) ~ sqrt(hd), and the last key a logit
    near it and a v of its own."""
    b, sp, _ = x.shape
    ar = torch.arange(b, device=x.device)
    r = rows.long()
    xc = torch.ones_like(x)
    xc[ar, r] = x[ar, r]
    near = x[ar, r] + 0.5 * x[ar, (r + 1) % sp]
    xc[:, sp - 1] = torch.where((r == sp - 1)[:, None], x[:, sp - 1], near)
    wqkv, bqkv = w[0].clone(), w[1].clone()
    wqkv[:, d:2 * d] = wqkv[:, :d]
    bqkv[d:] = 0
    return xc, (ln[0], torch.zeros_like(ln[1])), (wqkv, bqkv, *w[2:])


def _pooled_rows(torch, results, tag, s):
    """The pooled block at one shape: static row 0 (or ``pool_row``) for
    the non-causal towers, DYN_ROWS for the causal ones. Planted faults:
    the logits zeroed, the block skipped, at head_dim 80 the head_dim-64
    scale, over OLD_MAX_SEQ tokens the keys past it dropped; the last key
    tile dropped (the kernel at n_valid = SP - 1 on _last_key_inputs,
    against the plain version at SP: a kernel that skips its last key tile
    skips at least the last key, which there carries a share of the
    attention); on the per-example rows, the keys past each row kept (the
    kernel with causal off)."""
    from wise_tpu_torch.ops import block as K

    b, sp, d, h, causal = s["b"], s["sp"], s["d"], s["heads"], s["causal"]
    dtype = torch.float32 if s["f32"] else torch.bfloat16
    xb = 4 if s["f32"] else 2
    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][2],
                             x_std=s.get("x_std", 1.0))
    kw = dict(heads=h, n_valid=sp, causal=causal)
    row = s.get("pool_row", 0)
    if causal:
        name = "fused_attn_block_pooled_dyn"
        rows = torch.tensor(DYN_ROWS, dtype=torch.int32, device="cuda")
        base = x[torch.arange(b, device="cuda"), rows.long()]
        keys = float(rows.float().mean()) + 1

        def pooled(w=w, x=x, ln=ln, n_valid=sp, causal=causal):
            return K.fused_attn_block_pooled_dyn(
                x, rows, *ln, *w, heads=h, n_valid=n_valid, causal=causal)

        def plain(x=x, ln=ln, w=w):
            return K.plain_attn_block_pooled_dyn(x, rows, *ln, *w, **kw)

        library = _sdpa_of_block(torch, x, ln, w, h, causal, rows=rows)
    else:
        name, base = "fused_attn_block_pooled", x[:, row]
        rows = torch.full((b,), row, dtype=torch.int32, device="cuda")
        keys = row + 1 if causal else sp

        def pooled(w=w, x=x, ln=ln, n_valid=sp, causal=causal):
            return K.fused_attn_block_pooled(
                x, *ln, *w, pool_row=row, heads=h, n_valid=n_valid,
                causal=causal)

        def plain(x=x, ln=ln, w=w):
            return K.plain_attn_block_pooled(x, *ln, *w, pool_row=row, **kw)

        library = _sdpa_of_block(torch, x, ln, w, h, causal, row)

    lone = _last_key_inputs(torch, x, ln, w, rows, d)
    faults = {"faulted_kernel": lambda: pooled(_zero_q(w, d)),
              "block_skipped": lambda: base,
              "last_key_tile_dropped": lambda: (
                  pooled(x=lone[0], ln=lone[1], w=lone[2], n_valid=sp - 1),
                  plain(*lone),
                  pooled(x=lone[0], ln=lone[1], w=lone[2]))}
    if d // h != 64:
        faults["scale_of_hd64"] = lambda: pooled(_wrong_scale(w, d, d // h))
    if d // h in WIDE_HEAD_DIMS:
        faults["last_8_head_cols_dropped"] = lambda: pooled(
            _head_tail_dropped(w, d, d // h))
    if sp > OLD_MAX_SEQ:
        faults["keys_past_272_dropped"] = lambda: pooled(n_valid=OLD_MAX_SEQ)
    if causal:
        faults["causal_keys_past_row_kept"] = lambda: pooled(causal=False)
    _check_row(torch, results, name, tag, (name, sp, d), x, pooled, plain,
               base, faults, _attn_work(b, sp, d, xb, keys, pooled=True),
               library=library)


def _swin_inputs(torch, n, c, heads, n_win, seed):
    """A window batch (N, 64, C) bf16 ~ N(0, 1); kernels at 1/sqrt(fan_in),
    biases and LayerNorm offsets N(0, 0.02); the relative-bias table at
    std 1 (at 0.02 a kernel that dropped it would still pass); the shift
    mask of a res x res map (n_win windows) or None."""
    from wise_tpu_torch.models.clap.model import (relative_position_index,
                                                  shift_attn_mask)

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf, ff, window, l = torch.bfloat16, 4 * c, 8, 64

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x = r(n, l, c, scale=1.0).to(bf)
    table = r((2 * window - 1) ** 2, heads, scale=1.0)
    idx = torch.from_numpy(relative_position_index(window).reshape(-1))
    bias = table[idx.cuda()].reshape(l, l, heads).permute(2, 0, 1)
    mask = None
    if n_win:
        res = window * math.isqrt(n_win)
        mask = torch.from_numpy(shift_attn_mask(res, res, window,
                                                window // 2)).cuda()
    attn = (r(c, 3 * c, scale=c ** -0.5).to(bf), r(3 * c).to(bf),
            r(c, c, scale=c ** -0.5).to(bf), r(c).to(bf))
    ln = (1.0 + r(c), r(c), 1.0 + r(c), r(c))
    mlp = (r(c, ff, scale=c ** -0.5).to(bf), r(ff).to(bf),
           r(ff, c, scale=ff ** -0.5).to(bf), r(c).to(bf))
    return x, attn, bias.contiguous(), mask, ln, mlp


def _sdpa_inputs(y, wqkv, bqkv, bias, mask, heads):
    """q, k, v (B, n_win·H, L, hd) of the window batch y (N, L, C), N = B x
    n_win windows (n_win 1 without a mask), and the additive f32 mask
    bias[h] + mask[r] (1, n_win·H, L, L) that broadcasts over the examples:
    the window attention as one scaled_dot_product_attention call."""
    n, l, c = y.shape
    n_win = 1 if mask is None else mask.shape[0]
    qkv = (y @ wqkv + bqkv).reshape(n // n_win, n_win, l, 3, heads,
                                     c // heads)
    q, k, v = (qkv[:, :, :, i].permute(0, 1, 3, 2, 4).reshape(
        n // n_win, n_win * heads, l, c // heads).contiguous()
        for i in range(3))
    add = bias[None] if mask is None else bias[None] + mask[:, None]
    return q, k, v, add.reshape(1, n_win * heads, l, l).contiguous()


def _swin_parts(name, m, c, tables, route):
    """(kernel, (operations, bytes)) of the kernels one Swin call launches
    (64-token windows, bf16 stream, f32 bias and mask): on the fused route
    kernel A (qkv and out-proj products and the attention; x in, out or o
    out, its weights, LN1's and the tables) and, for the block, kernel B
    (fc1 and fc2; o in, out out, its weights, LN2's); on the chain the
    window attention alone (qkv in, att out, the tables)."""
    att_ops = 4 * m * 64 * c
    if route == "chain":
        return [("window_attention_kernel",
                 (att_ops, 2 * m * 3 * c + 2 * m * c + tables))]
    block = name == "fused_swin_block"
    a = (8 * m * c * c + att_ops, 2 * m * c * 2 + (4 * c * c + 4 * c) * 2
         + tables + (_LN_BYTES * c if block else 0))
    parts = [("swin_attn_kernel", a)]
    if block:
        parts.append(("swin_mlp_kernel", (16 * m * c * c, 2 * m * c * 2
                                          + (8 * c * c + 5 * c) * 2
                                          + _LN_BYTES * c)))
    return parts


def _swin_rows(torch, results):
    """Both Swin kernels at HTSAT's window batches (batch 64). Planted
    faults: zeroed logits (q weights, relative bias and mask all zero:
    uniform attention), the relative bias dropped, and on shifted blocks
    the shift mask dropped and the mask rolled by one window (window w
    takes w - 1's). The window attention has no residual: its increment is
    its whole output. Each row also carries each of its kernels' own
    device ms (``part_ms``) and bound, and as ``library_ms``
    ``F.scaled_dot_product_attention`` on the same q, k, v with the
    additive f32 mask bias[h] + mask[r] (built outside the timed call):
    the attention part alone, used nowhere in the port. Each shifted stage
    also has a ``-map`` row of the block: x as the stage's spatial rows
    (64 images), the shift's roll and window partition read through the
    block's token map, against the plain version through the map; planted
    there: the map rolled by one row, and one F chunk of kernel B dropped
    (Wproj's rows of the second chunk zeroed)."""
    from wise_tpu_torch.ops import swin_attention as SA
    from wise_tpu_torch.ops import swin_block as SB
    from wise_tpu_torch.ops.block import layer_norm_f32

    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "wise_tpu_torch/csrc/swin_kernels.cu "
    sources = {  # (block, route) -> the kernels' sources
        (True, "fused"): src + "swin_attn_kernel + swin_mlp_kernel",
        (False, "fused"): src + "swin_attn_kernel",
        (True, "chain"): (src + "window_attention_kernel + wise_tpu_torch/"
                          "csrc/common.cuh gemm_kernel, layernorm_kernel"),
        (False, "chain"): (src + "window_attention_kernel + wise_tpu_torch/"
                           "csrc/common.cuh gemm_kernel")}
    for i, (tag, n, c, heads, n_win) in enumerate(SWIN_STAGES):
        x, attn, bias, mask, ln, mlp = _swin_inputs(torch, n, c, heads,
                                                    n_win, 20 + i)
        no_bias = torch.zeros_like(bias)
        route = SA.swin_route(c)
        for name, kernel_fn, plain_fn, base in (
                ("fused_window_attention", SA.fused_window_attention,
                 SA.plain_window_attention, torch.zeros((), device="cuda")),
                ("fused_swin_block", SB.fused_swin_block,
                 SB.plain_swin_block, x)):
            block = name == "fused_swin_block"

            def call(fn, attn=attn, bias=bias, mask=mask, block=block):
                if block:
                    return fn(x, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                              heads=heads)
                return fn(x, *attn, bias, mask, heads=heads)

            faults = {
                "logits_zeroed": lambda k=kernel_fn: call(
                    k, _zero_q(attn, c), no_bias, None),
                "bias_dropped": lambda k=kernel_fn: call(k, bias=no_bias)}
            if mask is not None:
                faults["mask_dropped"] = lambda k=kernel_fn: call(k,
                                                                  mask=None)
                faults["mask_rolled"] = lambda k=kernel_fn: call(
                    k, mask=mask.roll(1, 0))
            # 64-token windows: qkv + out-proj GEMMs and the attention, the
            # block also its MLP (F = 4C); bf16 stream, f32 bias and mask
            m = n * 64
            ops = 8 * m * c * c + 4 * m * 64 * c
            tables = (bias.numel() * 4
                      + (mask.numel() * 4 if mask is not None else 0))
            nbytes = 2 * m * c * 2 + (4 * c * c + 4 * c) * 2 + tables
            if block:
                ops += 16 * m * c * c
                nbytes += (8 * c * c + 5 * c) * 2 + 2 * _LN_BYTES * c
            with torch.inference_mode():
                y = (layer_norm_f32(x, *ln[:2]).to(torch.bfloat16) if block
                     else x)
                qkv_mask = _sdpa_inputs(y, attn[0], attn[1], bias, mask,
                                        heads)
            library = (lambda a=qkv_mask: sdpa(*a[:3], attn_mask=a[3]))
            _check_row(torch, results, name, tag,
                       (name, 64, c, n_win is not None), x,
                       lambda k=kernel_fn: call(k),
                       lambda p=plain_fn: call(p), base, faults,
                       (ops, nbytes), library=library,
                       parts=_swin_parts(name, m, c, tables, route))
            results[-1]["source"] = sources[block, route]
            if not block or mask is None:
                continue
            # the block path's entry: spatial rows through the token map
            res = 8 * math.isqrt(n_win)
            tmap = SB.token_map(res, res, 8, 4).cuda()
            xs = x.reshape(n // n_win, res * res, c)
            wproj = mlp[2].clone()
            wproj[SWIN_MLP_CHUNK:2 * SWIN_MLP_CHUNK] = 0

            def mapped(fn, tmap=tmap, mlp=mlp):
                return fn(xs, *ln[:2], *attn, bias, mask, *ln[2:], *mlp,
                          heads=heads, token_map=tmap)

            _check_row(torch, results, name, f"{tag}-map",
                       (name, 64, c, True), xs,
                       lambda: mapped(SB.fused_swin_block),
                       lambda: mapped(SB.plain_swin_block), xs,
                       {"map_rolled": lambda: mapped(SB.fused_swin_block,
                                                     tmap=tmap.roll(1)),
                        "chunk_dropped": lambda: mapped(
                            SB.fused_swin_block,
                            mlp=(*mlp[:2], wproj, mlp[3]))},
                       (ops, nbytes + 4 * tmap.numel()), library=library,
                       parts=_swin_parts(name, m, c, tables, route))
            results[-1]["source"] = sources[block, route]


#: the training forwards' shapes: ViT-B/32's towers at the training batch
#: (as many captions as frames), ViT-L/14's vision tower at batch 32, whose
#: width takes the split pair, and ViT-H/14's (the default backbone's
#: vision tower, head_dim 80) at batch 32
TRAIN_SHAPES = {
    "train-vision": dict(b=256, sp=50, d=768, heads=12, f32=True,
                         causal=False, act="gelu", seeds=(61, 62)),
    "train-text": dict(b=256, sp=77, d=512, heads=8, f32=False, causal=True,
                       act="gelu", seeds=(63, 64)),
    "train-vit_l": dict(b=32, sp=257, d=1024, heads=16, f32=True,
                        causal=False, act="gelu", seeds=(65, 66)),
    "train-vit_h": dict(b=32, sp=257, d=1280, heads=16, f32=True,
                        causal=False, act="gelu", seeds=(67, 68)),
}


def _check_res_row(torch, results, name, tag, x, kernel, plain, twin, base,
                   res_faults, work, faults=None, library=None):
    """A training forward's row: ``kernel()`` and ``plain()`` return (out,
    residual). The output is held as its serve twin's is (``_check_row`` on
    the increment over ``base``; planted ``faults``, by default the skipped
    block), the residual on
    the whole tensor (``output_agreement``), and every callable in
    ``res_faults`` returns a faulty residual that must fail that check.
    ``twin`` is the serve wrapper on the same inputs, timed beside;
    ``library`` the serve twin's library call (SDPA on the block's q, k, v;
    torch.addmm on each product)."""
    from wise_tpu_torch.ops.block import output_agreement

    _check_row(torch, results, name, tag, (name, *x.shape[1:]), x,
               lambda: kernel()[0], lambda: plain()[0], base,
               faults or {"block_skipped": lambda: base}, work,
               library=library)
    with torch.inference_mode():
        got, want = kernel()[1], plain()[1]
        torch.cuda.synchronize()
        same = got.shape == want.shape and got.dtype == want.dtype
        check = output_agreement(got, want) if same else dict(
            ok=False, max_abs_err=math.inf, err_bound=0.0, min_cos=0.0)
        planted = {k: output_agreement(f(), want)
                   for k, f in res_faults.items()}
        twin_ms = _cuda_ms(torch, twin, 20)
    caught = not any(c["ok"] for c in planted.values())
    ok = same and check["ok"] and caught
    say("kernels", name=f"{name}[{tag}]", residual="x".join(
            map(str, got.shape)), res_dtype=str(got.dtype)[6:],
        res_max_abs_err=f"{check['max_abs_err']:.6g}",
        res_err_bound=f"{check['err_bound']:.6g}",
        res_min_cos=f"{check['min_cos']:.6f}",
        res_planted_min_cos=",".join(f"{k}:{c['min_cos']:.4f}"
                                     for k, c in planted.items()),
        res_planted="FAIL(expected)" if caught else "PASSED(wrong)",
        serve_twin_ms=f"{twin_ms:.4f}", status="ok" if ok else "FAIL")
    results[-1]["ok"] = results[-1]["ok"] and ok


def _train_rows(torch, results, tag, s):
    """fused_attn_block_res and the MLP's training forward (the wrapper
    ``mlp_choice`` gives the width; the split pair's fc half also alone) at
    one training shape. Bound: the serve twin's, plus the residual's bytes
    written (2 M 3D, or 2 M F). Library: the serve twin's (SDPA on the
    block's q, k and v; torch.addmm on each of the MLP's products, or on the
    fc half's). Planted on the residual: left unwritten (zeros), and for the
    MLP written after the activation (h in its place)."""
    from wise_tpu_torch.ops import block as K

    b, sp, d, h, causal = s["b"], s["sp"], s["d"], s["heads"], s["causal"]
    dtype = torch.float32 if s["f32"] else torch.bfloat16
    xb = 4 if s["f32"] else 2
    m, f, act = b * sp, 4 * d, s["act"]
    kw = dict(heads=h, n_valid=sp, causal=causal)
    keys = (sp + 1) / 2 if causal else sp

    def more(work, nbytes):
        return work[0], work[1] + nbytes

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][0])
    _check_res_row(
        torch, results, "fused_attn_block_res", tag, x,
        lambda: K.fused_attn_block_res(x, *ln, *w, **kw),
        lambda: K.plain_attn_block_res(x, *ln, *w, **kw),
        lambda: K.fused_attn_block(x, *ln, *w, **kw), x,
        {"res_unwritten": lambda: torch.zeros(
            b, sp, 3 * d, dtype=torch.bfloat16, device="cuda")},
        more(_attn_work(b, sp, d, xb, keys), 2 * m * 3 * d),
        library=_sdpa_of_block(torch, x, ln, w, h, causal))

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][1], mlp=True)
    with torch.inference_mode():
        y = K.layer_norm_f32(x, *ln).to(torch.bfloat16)
        hid = K.plain_mlp_fc(x, *ln, *w[:2], act=act)
    res_faults = {
        "res_after_activation": lambda: K.fused_mlp_fc(x, *ln, *w[:2],
                                                       act=act),
        "res_unwritten": lambda: torch.zeros(
            b, sp, f, dtype=torch.bfloat16, device="cuda")}
    split = K.mlp_choice(d) == "split"
    name = "fused_mlp_split_res" if split else "fused_mlp_block_res"
    res_fn, plain_fn, twin = (
        (K.fused_mlp_split_res, K.plain_mlp_split_res, K.fused_mlp_split)
        if split else
        (K.fused_mlp_block_res, K.plain_mlp_block_res, K.fused_mlp_block))
    _check_res_row(
        torch, results, name, tag, x,
        lambda: res_fn(x, *ln, *w, act=act),
        lambda: plain_fn(x, *ln, *w, act=act),
        lambda: twin(x, *ln, *w, act=act), x, res_faults,
        more(_mlp_work(m, d, f, xb), 2 * m * f),
        library=_addmm_pair(torch, y, w[:2], hid, w[2:]))
    if split:
        # the fc half alone: no residual stream under h, so h is held whole
        _check_res_row(
            torch, results, "fused_mlp_fc_res", tag, x,
            lambda: K.fused_mlp_fc_res(x, *ln, *w[:2], act=act),
            lambda: K.plain_mlp_fc_res(x, *ln, *w[:2], act=act),
            lambda: K.fused_mlp_fc(x, *ln, *w[:2], act=act),
            torch.zeros((), device="cuda"), res_faults,
            more(_mlp_work(m, d, f, xb, "fc"), 2 * m * f),
            faults={"h_not_activated": lambda: K.fused_mlp_fc_res(
                x, *ln, *w[:2], act="none")[0]},
            library=_addmm(torch, y, *w[:2]))


#: kernels timed alone at a main path's shape: tag -> (kernel, BLOCK_SHAPES
#: entry, the wrappers whose launch chains hold one launch of it at that
#: (SP, D)). layernorm_kernel: ViT-H/14's 65,792 x 1280 and ViT-B/32's
#: 12,800 x 768 f32 rows (the MLP's LayerNorm is in the single block, or in
#: the split pair's fc half); attention_pooled_kernel at every shape a path
#: launches it: the static pooled row (row 0; SigLIP text row 63) of the
#: non-causal towers, DYN_ROWS of the causal ones; gather_rows_kernel, the
#: per-example rows of LN(x) (no static row gathers), at the CLIP text
#: tower's shape
ALONE = {
    "vit_h": ("layernorm_kernel", "vit_h", (
        "fused_attn_block", "fused_mlp_fc", "fused_attn_block_pooled")),
    "vision": ("layernorm_kernel", "vision", (
        "fused_attn_block", "fused_mlp_block", "fused_attn_block_pooled")),
    **{f"{tag}-pooled": ("attention_pooled_kernel", tag, (
        "fused_attn_block_pooled_dyn" if s["causal"]
        else "fused_attn_block_pooled",))
       for tag, s in BLOCK_SHAPES.items()
       if s.get("pooled", True) and not s.get("only_attn")},
    "text-gather": ("gather_rows_kernel", "text",
                    ("fused_attn_block_pooled_dyn",)),
}
#: heads a block of attention_pooled_kernel may take (ops.block
#: pooled_attention's ``group``): the alone rows time each that divides the
#: shape's heads
POOL_GROUPS = (1, 2, 4, 8, 16)


def _profiled_ms(torch, fn, kname=""):
    """Device ms a call of ``fn`` of the CUDA kernels whose names hold
    ``kname`` (all of them where empty): torch.profiler self time over 10
    calls (_device_kernels), retried where a profile recorded none."""
    for _ in range(3):
        ms = sum(k[0] for k in _device_kernels(torch, fn, reps=10)
                 if kname in k[2])
        if ms:
            return ms
    raise PhaseError(f"the profile recorded no {kname or 'kernel'}")


def _pooled_alone(torch, K, q, kv, h, sp, pool, causal, plain, library):
    """The pooled attention kernel called alone (ops.block.pooled_attention)
    on the block's own q and kv, at the kernel's choice of head group and at
    each of POOL_GROUPS, and the library call on the same inputs, all by
    device time (_profiled_ms): (ms at its choice, "g:ms,...", library ms).
    Each output is held to the plain version on the whole output
    (output_agreement); a disagreement raises."""
    rows = pool if causal else None
    row = 0 if causal else int(pool[0])
    timed = {}
    for g in (0,) + POOL_GROUPS:
        if g and h % g:
            continue

        def call(g=g):
            return K.pooled_attention(q, kv, h, sp, rows, row, causal, g)

        with torch.inference_mode():
            check = K.output_agreement(call(), plain())
        if not check["ok"]:
            raise PhaseError(f"pooled_attention group {g} disagrees "
                             f"with its plain version: {check}")
        timed[g] = _profiled_ms(torch, call, "attention_pooled_kernel")
    return (timed[0], ",".join(f"{g}:{ms:.4f}" for g, ms in timed.items()
                               if g), _profiled_ms(torch, library))


def _alone_rows(torch, kinds=None, parent=False):
    """Kernels timed alone (ALONE; only those named in ``kinds`` where
    given): the kernel's own device ms inside the call of a wrapper that
    launches it (torch.profiler self time over 10 calls, as a Swin row's
    ``part_ms``), beside its plain PyTorch version and its library call on
    the same inputs (CUDA events) and its bound. LayerNorm: K.layer_norm_f32
    cast to bf16 (the kernel's output), F.layer_norm (which writes f32); 8
    f32 operations an element at PEAK_OPS_F32, x read once, bf16 y written
    once. Pooled attention: the softmax over each example's kept keys of q
    at its pooled row (f32 logits, bf16 p) times v, and SDPA on that q;
    bytes: k and v of the keys each row keeps, q and the output. Unless
    ``parent`` (this script run from the parent commit's checkout, to time
    its kernels: it predates these), a pooled row also times the kernel
    called alone on the same q and kv as the library call (``alone_ms``,
    and ``group_ms`` at each head group, device time, beside the library
    call's, ``library_device_ms``) and holds each to the plain version, and
    a static row's block must launch no gather_rows_kernel. The gather: y[arange(B), rows] on LN(x), with
    the clamp (plain) and without (library). Returns the rows, each with
    the wrappers whose launches on the paths it counts."""
    from torch.nn.functional import layer_norm

    from wise_tpu_torch.ops import block as K

    rows = []
    for tag, (kname, shape, via) in ALONE.items():
        if kinds and kname not in kinds:
            continue
        s = BLOCK_SHAPES[shape]
        b, sp, d, h, causal = (s["b"], s["sp"], s["d"], s["heads"],
                               s["causal"])
        dtype = torch.float32 if s["f32"] else torch.bfloat16
        xb = 4 if s["f32"] else 2
        x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][2],
                                 x_std=s.get("x_std", 1.0))
        kw = dict(heads=h, n_valid=sp, causal=causal)
        more = {}
        if kname == "layernorm_kernel":
            if K.mlp_choice(d) == "split":
                via = tuple(v.replace("fused_mlp_block", "fused_mlp_fc")
                            for v in via)
            m = b * sp
            ops, nbytes, peak = 8 * m * d, m * d * (xb + 2) + _LN_BYTES * d, \
                PEAK_OPS_F32

            def call():
                return K.fused_attn_block(x, *ln, *w, **kw)

            def plain():
                return K.layer_norm_f32(x, *ln).to(torch.bfloat16)

            def library():
                return layer_norm(x, (d,), ln[0], ln[1], eps=K.EPS)
        else:
            hd = d // h
            ar = torch.arange(b, device="cuda")
            row = s.get("pool_row", 0)
            if causal:
                pool = torch.tensor(DYN_ROWS, dtype=torch.int32,
                                    device="cuda")

                def call():
                    return K.fused_attn_block_pooled_dyn(x, pool, *ln, *w,
                                                         **kw)

                sdpa = _sdpa_of_block(torch, x, ln, w, h, causal, rows=pool)
            else:
                pool = torch.full((b,), row, dtype=torch.int32,
                                  device="cuda")

                def call():
                    return K.fused_attn_block_pooled(x, *ln, *w,
                                                     pool_row=row, **kw)

                sdpa = _sdpa_of_block(torch, x, ln, w, h, causal, row=row)
            with torch.inference_mode():
                qkv = K.qkv_stage(x, *ln, *w[:2])
            kept = (pool.long() + 1 if causal
                    else torch.full((b,), sp, device="cuda"))
            keys = float(kept.float().mean())
            if kname == "gather_rows_kernel":
                with torch.inference_mode():
                    y = K.layer_norm_f32(x, *ln).to(torch.bfloat16)
                pl = pool.long()

                def plain():
                    return y[ar, pl.clamp(0, sp - 1)]

                def library():
                    return y[ar, pl]

                ops, nbytes, peak = 0, 2 * 2 * b * d + 4 * b, PEAK_OPS
            else:
                q = qkv[ar, pool.long(), :d].reshape(b, h, hd)
                k = qkv[..., d:2 * d].reshape(b, sp, h, hd)
                v = qkv[..., 2 * d:].reshape(b, sp, h, hd)
                col = torch.arange(sp, device="cuda")[None, :]
                keep = (col < kept[:, None])[:, None, :]

                def plain():
                    return K._softmax_attend(q, k, v, keep, torch.bfloat16)

                library = sdpa
                ops, nbytes, peak = (4 * b * keys * d,
                                     2 * 2 * d * float(kept.sum())
                                     + 2 * 2 * b * d, PEAK_OPS)
                if not parent:
                    alone_ms, group_ms, library_device_ms = _pooled_alone(
                        torch, K, q.reshape(b, d).contiguous(),
                        qkv[..., d:].contiguous(), h, sp, pool, causal,
                        lambda: plain().reshape(b, d), library)
                    more = dict(alone_ms=f"{alone_ms:.4f}",
                                group_ms=group_ms,
                                library_device_ms=f"{library_device_ms:.4f}")
        for _ in range(3):  # a profile may now and then record no kernel
            found = _device_kernels(torch, call, reps=10)
            hits = [k for k in found if kname in k[2]]
            if hits:
                break
        if not hits:
            raise PhaseError(f"{kname}[{tag}]: the profile of "
                             f"{via[0]} recorded no {kname}")
        if kname == "attention_pooled_kernel" and not causal:
            gathers = sum(k[1] for k in found
                          if "gather_rows_kernel" in k[2])
            more["gathers_per_call"] = f"{gathers:g}"
            if gathers and not parent:
                raise PhaseError(f"{via[0]}[{tag}]: a static pooled row "
                                 f"launched gather_rows_kernel")
        ms, per_call = sum(k[0] for k in hits), sum(k[1] for k in hits)
        with torch.inference_mode():
            plain_ms = _cuda_ms(torch, plain, 20)
            library_ms = _cuda_ms(torch, library, 20)
        bound_ms, bound_by = _bound(ops, nbytes, peak)
        say("kernels", alone=f"{kname}[{tag}]",
            shape="x".join(map(str, x.shape)), dtype=str(x.dtype)[6:],
            ms=f"{ms:.4f}", launches_per_call=f"{per_call:g}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            timed_in=via[0], **more)
        rows.append(dict(name=kname, tag=tag, via=via, sp=sp, d=d,
                         per_call=per_call))
    return rows


#: the bars of a backward row: per-tensor cosine of the gradients, and max
#: abs error as a share of the plain gradient's max abs (bf16 class: the
#: cosine is the bar tests/test_block_train.py holds the reference's rules to)
GRAD_COS_MIN, GRAD_ERR_SHARE = 0.999, 0.05


def _grad_agreement(got, want) -> dict:
    err = max((g.float() - w.float()).abs().max().item() / max(
        w.float().abs().max().item(), 1e-30) for g, w in zip(got, want))
    cos = min(_flat_cos(g, w) for g, w in zip(got, want))
    finite = all(bool(g.isfinite().all()) for g in got)
    return dict(min_cos=cos, max_rel_err=err,
                ok=finite and cos >= GRAD_COS_MIN and err <= GRAD_ERR_SHARE)


def _flat_cos(a, b) -> float:
    import torch

    return torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()


def _backward_rows(torch):
    """Each autograd rule on the card: the gradients of a seeded scalar loss
    (sum of the output times a fixed N(0, 1) tensor) with respect to x (or
    q, k, v) and every parameter, against autograd through the plain block
    on the same tensors: per-tensor cosine >= GRAD_COS_MIN and max abs error
    <= GRAD_ERR_SHARE of the plain gradient's max abs. The five block rules
    at ViT-B/32's and ViT-L/14's training shapes, and the default
    backbone's: ViT-H/14's attention block and split MLP at 32 x 257 x 1280,
    the post-LN rules at XLM-R's 32 x 64 x 1024 (each example's keys cut at
    another length), and the attention middle of WISE_FUSED_BLOCK=0 at
    ViT-B/32's 256 x 50 x 768 and, causal, 256 x 77 x 512. Planted, each of
    which must fail: for the saved-activation rules a backward that ignores
    the saved residual (the forward's residual replaced by zeros); for the
    recompute rules (the post-LN blocks, the attention middle) a recompute
    that ignores the saved input (x or q times 0) and, where the rule masks
    keys, one with the mask dropped (km 0; the causal mask off), and for
    the post-LN MLP one without its activation. Times a forward + backward
    of both (CUDA events, 10 calls after 3) beside the bound of
    scripts/train_bounds.py and, for the attention middle, the library
    call's: F.scaled_dot_product_attention forward and backward on the same
    q, k and v (``library_fwd_bwd_ms``; no one call computes a block)."""
    from scripts.train_bounds import work
    from wise_tpu_torch.ops import attention as A
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import postln_block as P

    def zeroed(fn):
        def call(*a, **kw):
            out, res = fn(*a, **kw)
            return out, torch.zeros_like(res)
        return call

    def block_args(s, seed, mlp):
        dtype = torch.float32 if s["f32"] else torch.bfloat16
        x, ln, w = _block_inputs(torch, s["b"], s["sp"], s["d"], dtype,
                                 seed, mlp=mlp)
        return [t.requires_grad_() for t in (x, *ln, *w)], None

    def postln_args(s, seed, mlp):
        x, km, ln, w = _postln_inputs(torch, s["b"], seed, mlp=mlp)
        return [t.requires_grad_() for t in (x, *ln, *w)], km

    def qkv_args(s, seed, mlp):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn(s["b"], s["sp"], 3 * s["d"], generator=g,
                          device="cuda").to(torch.bfloat16)
        return [t.contiguous().requires_grad_()
                for t in qkv.split(s["d"], dim=-1)], None

    bad = []
    vis, txt, vit_l, vit_h = (TRAIN_SHAPES[k] for k in (
        "train-vision", "train-text", "train-vit_l", "train-vit_h"))
    xlmr = dict(b=POSTLN_SHAPES["train"]["b"], sp=POSTLN_SP, d=POSTLN_D,
                heads=POSTLN_HEADS, f32=False, causal=False, act="gelu")
    rows_of = torch.randint(1, 77, (txt["b"],), dtype=torch.int32,
                            device="cuda",
                            generator=torch.Generator("cuda").manual_seed(70))
    real_pa, real_pm = P.plain_postln_attn_block, P.plain_postln_mlp_block
    real_sa = A.plain_short_attention
    attn_rule = (
        lambda a, s, e: K.fused_attn_block_train(*a, s["heads"], s["sp"],
                                                 s["causal"]),
        lambda a, s, e: K.plain_attn_block(*a, s["heads"], s["sp"],
                                           s["causal"]))
    split_rule = (lambda a, s, e: K.fused_mlp_split_train(*a, s["act"]),
                  lambda a, s, e: K.plain_mlp_split(*a, s["act"]))
    short_rule = (
        lambda a, s, e: A.fused_attention_trainable(*a, s["heads"], s["sp"],
                                                    s["causal"]),
        lambda a, s, e: real_sa(*a, s["heads"], s["sp"], s["causal"]))
    q_ignored = {"input_ignored": (A, "plain_short_attention",
                                   lambda q, *r: real_sa(q * 0, *r))}
    # name, tag, shape, make the inputs, (rule, plain), planted faults
    # {name: residual wrapper to zero} or {name: (module, attr, stand-in)},
    # (kind, stream bytes) for scripts/train_bounds.py
    cases = [
        ("fused_attn_block_train", "train-vision", vis, block_args, False,
         attn_rule, {"res_zeroed": "fused_attn_block_res"}, ("attn", 4)),
        ("fused_attn_block_train", "train-text", txt, block_args, False,
         attn_rule, {"res_zeroed": "fused_attn_block_res"}, ("attn", 2)),
        ("fused_mlp_block_train", "train-vision", vis, block_args, True,
         (lambda a, s, e: K.fused_mlp_block_train(*a, s["act"]),
          lambda a, s, e: K.plain_mlp_block(*a, s["act"])),
         {"res_zeroed": "fused_mlp_block_res"}, ("mlp", 4)),
        ("fused_mlp_split_train", "train-vit_l", vit_l, block_args, True,
         split_rule, {"res_zeroed": "fused_mlp_fc_res"}, ("mlp", 4)),
        ("fused_attn_block_pooled_train", "train-vision", vis, block_args,
         False,
         (lambda a, s, e: K.fused_attn_block_pooled_train(
             *a, s["heads"], s["sp"], 0, s["causal"]),
          lambda a, s, e: K.plain_attn_block_pooled(
              *a, s["heads"], s["sp"], 0, s["causal"])), {}, ("pooled", 4)),
        ("fused_attn_block_pooled_dyn_train", "train-text", txt, block_args,
         False,
         (lambda a, s, e: K.fused_attn_block_pooled_dyn_train(
             a[0], rows_of, *a[1:], s["heads"], s["sp"], s["causal"]),
          lambda a, s, e: K.plain_attn_block_pooled_dyn(
              a[0], rows_of, *a[1:], s["heads"], s["sp"], s["causal"])), {},
         ("pooled", 2)),
        ("fused_attn_block_train", "train-vit_h", vit_h, block_args, False,
         attn_rule, {"res_zeroed": "fused_attn_block_res"}, ("attn", 4)),
        ("fused_mlp_split_train", "train-vit_h", vit_h, block_args, True,
         split_rule, {"res_zeroed": "fused_mlp_fc_res"}, ("mlp", 4)),
        ("fused_postln_attn_block_train", "train-xlmr", xlmr, postln_args,
         False,
         (lambda a, s, km: P.fused_postln_attn_block_train(
             a[0], km, *a[1:], s["heads"]),
          lambda a, s, km: real_pa(a[0], km, *a[1:], s["heads"])),
         {"input_ignored": (P, "plain_postln_attn_block",
                            lambda x, *r: real_pa(x * 0, *r)),
          "mask_dropped": (P, "plain_postln_attn_block",
                           lambda x, km, *r: real_pa(
                               x, torch.zeros_like(km), *r))},
         ("postln_attn", 2)),
        ("fused_postln_mlp_block_train", "train-xlmr", xlmr, postln_args,
         True,
         (lambda a, s, e: P.fused_postln_mlp_block_train(*a, s["act"]),
          lambda a, s, e: real_pm(*a, s["act"])),
         {"input_ignored": (P, "plain_postln_mlp_block",
                            lambda x, *r: real_pm(x * 0, *r)),
          "activation_dropped": (P, "plain_postln_mlp_block",
                                 lambda *r: real_pm(*r[:7], "none"))},
         ("postln_mlp", 2)),
        ("fused_attention_trainable", "train-vision", vis, qkv_args, False,
         short_rule, q_ignored, ("attention", 2)),
        ("fused_attention_trainable", "train-text", txt, qkv_args, False,
         short_rule, {**q_ignored, "mask_dropped": (
             A, "plain_short_attention",
             lambda q, k, v, h, n, c, scale=None: real_sa(q, k, v, h, n,
                                                          False))},
         ("attention", 2)),
    ]
    names = {False: ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo"),
             True: ("x", "ln_s", "ln_b", "wfc", "bfc", "wproj", "bproj")}
    for i, (name, tag, s, make, mlp, (rule, plain), faults,
            (kind, xb)) in enumerate(cases):
        args, extra = make(s, 80 + i, mlp)
        g = torch.Generator(device="cuda").manual_seed(90 + i)
        with torch.no_grad():
            shape = rule(args, s, extra).shape
        weight = torch.randn(shape, generator=g, device="cuda")

        def grads(fn):
            return torch.autograd.grad(
                (fn(args, s, extra).float() * weight).sum(), args)

        got, want = grads(rule), grads(plain)
        torch.cuda.synchronize()
        check = _grad_agreement(got, want)
        labels = ("q", "k", "v") if make is qkv_args else names[mlp]
        per = {n: _flat_cos(a, b) for n, a, b in zip(labels, got, want)}
        planted = {}
        for fault, how in faults.items():
            mod, attr, stand_in = ((K, how, zeroed(getattr(K, how)))
                                   if isinstance(how, str) else how)
            real = getattr(mod, attr)
            setattr(mod, attr, stand_in)
            try:
                planted[fault] = _grad_agreement(grads(rule), want)
            finally:
                setattr(mod, attr, real)
        ms = _cuda_ms(torch, lambda: grads(rule), 10)
        plain_ms = _cuda_ms(torch, lambda: grads(plain), 10)
        library_ms = None
        if make is qkv_args:
            library_ms = _cuda_ms(torch, lambda: grads(
                lambda a, s, e: _sdpa_bshd(torch, *a, s["heads"],
                                           s["causal"])), 10)
        ops, nbytes = work(kind, s["b"], s["sp"], s["d"], xb, s["causal"])
        bound_ms, bound_by = _bound(ops, nbytes)
        ok = check["ok"] and not any(p["ok"] for p in planted.values())
        say("backward", name=f"{name}[{tag}]",
            shape="x".join(map(str, args[0].shape)),
            dtype=str(args[0].dtype)[6:],
            min_cos=f"{check['min_cos']:.6f}", cos_bar=GRAD_COS_MIN,
            max_rel_err=f"{check['max_rel_err']:.6g}",
            err_bar=GRAD_ERR_SHARE,
            cos=",".join(f"{n}:{c:.6f}" for n, c in per.items()),
            planted=",".join(
                f"{k}:min_cos:{p['min_cos']:.4f}:"
                + ("PASSED(wrong)" if p["ok"] else "FAIL(expected)")
                for k, p in planted.items()) or "none",
            fwd_bwd_ms=f"{ms:.4f}", plain_fwd_bwd_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            library_fwd_bwd_ms=("none" if library_ms is None
                                else f"{library_ms:.4f}"),
            status="ok" if ok else "FAIL")
        if not ok:
            bad.append(f"{name}[{tag}]")
        del args, extra, got, want, weight
    torch.cuda.empty_cache()
    if bad:
        raise PhaseError(f"autograd rules off the plain blocks' gradients, "
                         f"or a planted fault passed: {bad}")


#: the XLM-R tower's shape (64 tokens x 1024, 16 heads, F = 4096) at a
#: served query batch, at the default backbone's training batch and at the
#: batch the reference calibrated its kernels
POSTLN_SHAPES = {"query": dict(b=8, seeds=(41, 42)),
                 "train": dict(b=32, seeds=(45, 46)),
                 "ingest": dict(b=256, seeds=(43, 44))}
POSTLN_SP, POSTLN_D, POSTLN_HEADS = 64, 1024, 16
#: fused_short_attention's shapes: (B, SP, D, heads, causal) of ViT-B/32's
#: vision and text towers, ViT-L/14's and ViT-H/14's (head_dim 80) vision,
#: SigLIP-384's (576 tokens), ViT-L/14's at 336 px (577), ViT-g-14's (88)
#: and ViT-bigG-14's (104), at the batch of the WISE_FUSED_BLOCK=0 batches
#: that launch them; ViT-B/32's text tower also at the training batch (256
#: captions)
SHORT_ATTN_SHAPES = {"vit_b32": (256, 50, 768, 12, False),
                     "text": (8, 77, 512, 8, True),
                     "train_text": (256, 77, 512, 8, True),
                     "vit_l": (64, 257, 1024, 16, False),
                     "vit_h": (64, 257, 1280, 16, False),
                     "siglip": (64, 576, 1024, 16, False),
                     "vit_l336": (64, 577, 1024, 16, False),
                     "vit_g": (64, 257, 1408, 16, False),
                     "vit_bigg": (64, 257, 1664, 16, False)}


def _postln_inputs(torch, b, seed, mlp=False):
    """x (b, 64, 1024) bf16 ~ N(0, 1), kernels at 1/sqrt(fan_in), biases
    N(0, 0.02); the closing LayerNorm's scale 1 + N(0, 0.25) and bias
    N(0, 0.25), so that a kernel that left them out would show; km masks a
    different tail of each example (1 to 64 tokens kept)."""
    sp, d = POSTLN_SP, POSTLN_D
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    f = 4 * d if mlp else d
    first = (d, 4 * d) if mlp else (d, 3 * d)
    x = r(b, sp, d, scale=1.0).to(torch.bfloat16)
    ln = (1.0 + r(d, scale=0.25), r(d, scale=0.25))
    w = tuple(t.to(torch.bfloat16) for t in (
        r(*first, scale=d ** -0.5), r(first[1]), r(f, d, scale=f ** -0.5),
        r(d)))
    kept = torch.randint(1, sp + 1, (b,), generator=g, device="cuda")
    km = torch.zeros(b, 1, sp, device="cuda").masked_fill(
        torch.arange(sp, device="cuda")[None, None, :] >= kept[:, None, None],
        -math.inf)
    return x, km, ln, w


def _postln_work(b, half=None, attn=False):
    """(operations, bytes) of a post-LN block on x (b, 64, 1024) bf16: the
    attention block (every key computed, km added), the MLP, or one half of
    the split pair ("fc": x in, h out; "proj": h and x in, out)."""
    sp, d, f = POSTLN_SP, POSTLN_D, 4 * POSTLN_D
    m = b * sp
    if attn:
        return (8 * m * d * d + 4 * m * sp * d,
                2 * m * d * 2 + (4 * d * d + 4 * d) * 2 + _LN_BYTES * d
                + 4 * b * sp)
    if half == "fc":
        return 2 * m * d * f, m * d * 2 + (d * f + f) * 2 + m * f * 2
    if half == "proj":
        return (2 * m * d * f,
                m * f * 2 + (d * f + d) * 2 + 2 * m * d * 2 + _LN_BYTES * d)
    return (4 * m * d * f,
            2 * m * d * 2 + (2 * d * f + f + d) * 2 + _LN_BYTES * d)


def _postln_rows(torch, results, tag, s):
    """The post-LN attention block, the MLP as "single" and as the split
    pair, and each half, at one batch of the XLM-R shape, on their whole
    outputs. Planted faults: the key mask dropped, the softmax at half its
    scale, the LayerNorm's scale and bias replaced by ones and zeros, h not
    activated. Every row that closes with the LayerNorm stands a second
    time (``tag``-offset) on the same inputs with a common offset of 200 on
    the closing bias, which the LayerNorm takes out: the f32 sum keeps the
    signal under it, so the kernel must pass there as well, and the planted
    fault, the residual sum rounded to bf16 before the LayerNorm, loses it
    and must fail (on ordinary inputs that fault moves the output by less
    than an ulp)."""
    from wise_tpu_torch.ops import postln_block as P
    from wise_tpu_torch.ops.block import layer_norm_f32

    b, (seed_attn, seed_mlp) = s["b"], s["seeds"]
    sp, d, heads = POSTLN_SP, POSTLN_D, POSTLN_HEADS
    bf = torch.bfloat16
    ident = (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda"))

    def offset(bias):
        return (bias.float() + 200.0).to(bf)

    def sum_rounded(h, w, bias, x, ln):
        """LN over the sum rounded to bf16 first: the planted fault."""
        res = x.float() + (h @ w).float() + bias.float()
        return layer_norm_f32(res.to(bf), *ln).to(bf)

    x, km, ln, w = _postln_inputs(torch, b, seed_attn)
    w_off = (*w[:3], offset(w[3]))

    def attn(w=w, km=km, ln=ln):
        return P.fused_postln_attn_block(x, km, *ln, *w, heads)

    half_q = (w[0].clone(), w[1].clone(), *w[2:])
    half_q[0][:, :d] *= 0.5
    half_q[1][:d] *= 0.5
    name, key = "fused_postln_attn_block", ("fused_postln_attn_block", sp, d)
    library = _sdpa_of_block(torch, x, None, w, heads, False, km=km)
    _check_row(torch, results, name, tag, key, x, attn,
               lambda: P.plain_postln_attn_block(x, km, *ln, *w, heads), None,
               {"mask_dropped": lambda: attn(km=torch.zeros_like(km)),
                "half_scale": lambda: attn(half_q),
                "ln_identity": lambda: attn(ln=ident)},
               _postln_work(b, attn=True), library=library)
    _check_row(torch, results, name, f"{tag}-offset", key, x,
               lambda: attn(w_off),
               lambda: P.plain_postln_attn_block(x, km, *ln, *w_off, heads),
               None,
               {"sum_rounded_bf16": lambda: sum_rounded(
                   P.plain_postln_attention(x, km, *w[:2], heads), w[2],
                   w_off[3], x, ln)},
               _postln_work(b, attn=True), library=library)
    del library

    x, _, ln, w = _postln_inputs(torch, b, seed_mlp, mlp=True)
    fc, proj = w[:2], w[2:]
    proj_off = (proj[0], offset(proj[1]))
    with torch.inference_mode():
        hid = P.plain_postln_fc(x, *fc)
        raw = P.plain_postln_fc(x, *fc, "none")
    rounded = {"sum_rounded_bf16": lambda: sum_rounded(hid, *proj_off, x, ln)}
    library = _addmm_pair(torch, x, fc, hid, proj)

    for name, variant in (("fused_postln_mlp_block", "single"),
                          ("fused_postln_mlp_split", "split")):

        def mlp(ln=ln, proj=proj, act="gelu", variant=variant):
            return P.fused_postln_mlp_block(x, *ln, *fc, *proj, act,
                                            variant=variant)

        _check_row(torch, results, name, tag, (name, sp, d), x, mlp,
                   lambda: P.plain_postln_mlp_block(x, *ln, *w), None,
                   {"ln_identity": lambda m=mlp: m(ln=ident),
                    "h_not_activated": lambda m=mlp: m(act="none")},
                   _postln_work(b), library=library)
        _check_row(torch, results, name, f"{tag}-offset", (name, sp, d), x,
                   lambda m=mlp: m(proj=proj_off),
                   lambda: P.plain_postln_mlp_block(x, *ln, *fc, *proj_off),
                   None, rounded, _postln_work(b), library=library)
    _check_row(torch, results, "fused_postln_fc", tag,
               ("fused_postln_fc", sp, d), x,
               lambda: P.fused_postln_fc(x, *fc),
               lambda: P.plain_postln_fc(x, *fc), None,
               {"h_not_activated": lambda: P.fused_postln_fc(x, *fc, "none")},
               _postln_work(b, "fc"), library=_addmm(torch, x, *fc))
    name, key = "fused_postln_proj", ("fused_postln_proj", sp, d)
    _check_row(torch, results, name, tag, key, x,
               lambda: P.fused_postln_proj(hid, *proj, x, *ln),
               lambda: P.plain_postln_proj(hid, *proj, x, *ln), None,
               {"ln_identity": lambda: P.fused_postln_proj(hid, *proj, x,
                                                           *ident),
                "h_not_activated": lambda: P.fused_postln_proj(raw, *proj, x,
                                                               *ln)},
               _postln_work(b, "proj"), library=_addmm(torch, hid, *proj))
    _check_row(torch, results, name, f"{tag}-offset", key, x,
               lambda: P.fused_postln_proj(hid, *proj_off, x, *ln),
               lambda: P.plain_postln_proj(hid, *proj_off, x, *ln), None,
               rounded, _postln_work(b, "proj"),
               library=_addmm(torch, hid, *proj_off))


def _last_whole_tile(sp: int) -> int:
    """The keys of the attention kernel's whole key tiles below sp: n_valid
    as a loop that stopped one tile early would take it."""
    from wise_tpu_torch.ops.attention import KEY_TILE

    return (sp - 1) // KEY_TILE * KEY_TILE


def _short_attention_rows(torch, results):
    """fused_short_attention at SHORT_ATTN_SHAPES on its whole output, q, k
    and v being the three column ranges of one packed (B, SP, 3D) bf16
    in-projection ~ N(0, 1), as the model hands them over. Planted faults:
    the softmax at half its scale, the key mask dropped (n_valid = SP where
    the reference masks the last 7 keys), the causal mask dropped, over
    one key tile the last tile unscanned (the kernel at n_valid cut to the
    last whole tile, against the reference at SP), and over OLD_MAX_SEQ
    tokens the keys past it dropped. The
    library call that computes the same function is
    ``F.scaled_dot_product_attention`` on the same q, k and v as (B, H, SP,
    hd) views."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from wise_tpu_torch.ops import attention as A

    for i, (tag, (b, sp, d, heads, causal)) in enumerate(
            SHORT_ATTN_SHAPES.items()):
        g = torch.Generator(device="cuda").manual_seed(50 + i)
        qkv = torch.randn(b, sp, 3 * d, generator=g, device="cuda").to(
            torch.bfloat16)
        q, k, v = qkv.split(d, dim=-1)
        hd = d // heads
        q4, k4, v4 = (t.reshape(b, sp, heads, hd).transpose(1, 2)
                      for t in (q, k, v))

        def call(fn, n_valid=sp, causal=causal, scale=None):
            return fn(q, k, v, heads, n_valid, causal, scale)

        faults = {
            "half_scale": lambda: call(A.fused_short_attention,
                                       scale=0.5 / math.sqrt(hd)),
            "mask_dropped": lambda: (
                call(A.fused_short_attention),
                call(A.plain_short_attention, n_valid=sp - 7),
                call(A.fused_short_attention, n_valid=sp - 7))}
        if causal:
            faults["causal_dropped"] = lambda: call(A.fused_short_attention,
                                                    causal=False)
        if sp > A.KEY_TILE:
            faults["last_tile_unscanned"] = lambda: call(
                A.fused_short_attention, n_valid=_last_whole_tile(sp))
        if sp > OLD_MAX_SEQ:
            faults["keys_past_272_dropped"] = lambda: call(
                A.fused_short_attention, n_valid=OLD_MAX_SEQ)
        if hd in WIDE_HEAD_DIMS:
            def tail_dropped():
                cut = [t.clone().view(b, sp, heads, hd) for t in (q, v)]
                for t in cut:
                    t[..., hd - 8:] = 0
                qc, vc = (t.view(b, sp, d) for t in cut)
                return A.fused_short_attention(qc, k, vc, heads, sp, causal)
            faults["last_8_head_cols_dropped"] = tail_dropped
        keys = (sp + 1) / 2 if causal else sp
        _check_row(torch, results, "fused_short_attention", tag,
                   ("fused_short_attention", sp, d), q,
                   lambda: call(A.fused_short_attention),
                   lambda: call(A.plain_short_attention), None, faults,
                   (4 * b * sp * keys * d, 4 * b * sp * d * 2),
                   library=lambda: sdpa(q4, k4, v4, is_causal=causal))
        del qkv


#: the top-k kernel rows, all at INDEX_N x INDEX_D: (tag, wrapper, Q, k,
#: storage). The served query (Q = 1), a coalesced burst (Q = 8, and 16: the
#: coalescer's max_batch), a page of 100, Q = 32 on both wrappers (where
#: ops.topk's router cuts between them), and the batched search
TOPK_ROWS = [("q1-k10-f32", "fused_topk_threshold", 1, 10, "float32"),
             ("q1-k10-bf16", "fused_topk_threshold", 1, 10, "bfloat16"),
             ("q8-k10-f32", "fused_topk_threshold", 8, 10, "float32"),
             ("q1-k100-f32", "fused_topk_threshold", 1, 100, "float32"),
             ("q16-k10-f32", "fused_topk_threshold", 16, 10, "float32"),
             ("q16-k10-bf16", "fused_topk_threshold", 16, 10, "bfloat16"),
             ("q32-k10-f32", "fused_topk_threshold", 32, 10, "float32"),
             ("q32-k10-f32", "fused_topk", 32, 10, "float32"),
             ("q64-k100-f32", "fused_topk", 64, 100, "float32"),
             ("q64-k100-bf16", "fused_topk", 64, 100, "bfloat16"),
             ("q61-k100-bf16", "fused_topk", 61, 100, "bfloat16")]
#: the same kernels at WIDE_D (ViT-bigG-14's joint space), INDEX_N rows:
#: the served query and the coalesced bursts on both storage types, and
#: the batched search. No path serves 1M rows of that width: their
#: launches are the wrappers' at WIDE_D on the paths (the bigG index of
#: [vit_bigg]), whatever the rows (the key's N_pad is None)
TOPK_WIDE_ROWS = [("q1-k10-f32-d1280", "fused_topk_threshold", 1, 10,
                   "float32"),
                  ("q8-k10-f32-d1280", "fused_topk_threshold", 8, 10,
                   "float32"),
                  ("q16-k10-f32-d1280", "fused_topk_threshold", 16, 10,
                   "float32"),
                  ("q1-k10-bf16-d1280", "fused_topk_threshold", 1, 10,
                   "bfloat16"),
                  ("q8-k10-bf16-d1280", "fused_topk_threshold", 8, 10,
                   "bfloat16"),
                  ("q16-k10-bf16-d1280", "fused_topk_threshold", 16, 10,
                   "bfloat16"),
                  ("q64-k100-f32-d1280", "fused_topk", 64, 100, "float32"),
                  ("q64-k100-bf16-d1280", "fused_topk", 64, 100,
                   "bfloat16")]
TOPK_GROUP = 4096  # FeatureSearchIndex.GROUP


def _topk_inputs(torch, d=INDEX_D):
    """The two databases of the top-k rows, INDEX_N x ``d``, on the card,
    f32 and bf16.
    "unit": seeded unit-norm random vectors and queries. "tied": vectors of
    small non-negative integers (every score exact, ties everywhere, the
    k-th boundary included), the last 1,000 rows zero like padding
    (n_valid = N - 1000), all-zero rows planted among the valid ones
    (inside one tile, across spans, in the last group); query 0 has only
    negative coefficients, so it scores every row below the zero rows, and
    unmasked padding would tie with the planted best."""
    n = INDEX_N
    g = torch.Generator(device="cuda").manual_seed(1234 + d - INDEX_D)
    unit = torch.randn(n, d, generator=g, device="cuda")
    unit /= unit.norm(dim=1, keepdim=True)
    uq = torch.randn(64, d, generator=g, device="cuda")
    uq /= uq.norm(dim=1, keepdim=True)
    tied = torch.randint(0, 4, (n, d), generator=g, device="cuda",
                         dtype=torch.int8).float()
    n_valid = n - 1000
    tied[n_valid:] = 0
    tied[[5, 77, 78, 79, n // 2 + 3, n_valid - 1]] = 0
    tq = torch.randint(-2, 3, (64, d), generator=g, device="cuda").float()
    tq[0] = -(tq[0].abs() + 1)
    return {"unit": {"float32": unit, "bfloat16": unit.bfloat16(), "q": uq,
                     "n_valid": n},
            "tied": {"float32": tied, "bfloat16": tied.bfloat16(), "q": tq,
                     "n_valid": n_valid}, "d": d}


def _tf32_only(FT, q, db, n_valid, k, group):
    """fused_topk on f32 storage with a TF32-only product (torch ops: both
    operands rounded to TF32, products exact, sums f32) in place of the
    three-term kernel, and the real selection: a planted fault that the
    unit rows' 2e-6 check must catch."""
    def product(db_rows, qp, st):
        st.copy_((FT.tf32(qp) @ FT.tf32(db_rows).T).T)

    return FT.group_topk_chunks(q, db, n_valid, k, group, product,
                                FT.select_groups_cuda)


def _topk_row(torch, results, data, tag, name, qn, k, storage):
    """One top-k kernel row: identical to the plain version on the "tied"
    database, within 2e-6 on the "unit" one, every planted fault caught on
    the "tied" one (the TF32-only product of the f32 fused_topk rows on the
    "unit" one); times on the "unit" one. Every row also prints what its
    selection counted in one call on each database (fused_topk:
    ops.fused_topk.overflow_count; fused_topk_threshold: flush_count), and
    the time of its parts apart (_topk_parts, _threshold_parts)."""
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.ops import topk as TK

    fn, plain = getattr(FT, name), getattr(FT, name + "_plain")
    group, n, d = TOPK_GROUP, INDEX_N, data["d"]
    tied, unit = data["tied"], data["unit"]
    tdb, tq, nv = tied[storage], tied["q"][:qn], tied["n_valid"]
    udb, uq = unit[storage], unit["q"][:qn]
    grouped = name == "fused_topk"

    def ties_to_the_higher_row():
        """The kernel on the valid rows in reverse, rows mapped back: tied
        scores then come highest row first."""
        flipped = torch.cat([tdb[:nv].flip(0), tdb[nv:]])
        s, r = fn(tq, flipped, nv, k, group)
        return s, nv - 1 - r

    def skip_inverted():
        """What an inverted threshold skip leaves: once a buffer is full
        nothing better gets in, so each group gives its first k rows."""
        rows = (torch.arange(n // group, device="cuda")[:, None] * group
                + torch.arange(k, device="cuda")).reshape(-1)
        rows = rows[rows < nv]
        s, pos = TK._stable_topk(TK._scores(tq, tdb[rows]), k)
        return s, rows[pos]

    faults = {
        "mask_dropped": lambda: fn(tq, tdb, n, k, group),
        "ties_to_higher_row": ties_to_the_higher_row,
        "skip_inverted": skip_inverted,
        "last_span_unscanned": lambda: fn(tq, tdb[:n - group], n - group, k,
                                          group)}

    counted, reset = ((FT.overflow_count, FT.reset_overflows) if grouped
                      else (FT.flush_count, FT.reset_flushes))

    def events(q, db, n_valid):
        reset(db.device)
        fn(q, db, n_valid, k, group)
        return counted(db.device)

    with torch.inference_mode():
        want = plain(tq, tdb, nv, k, group)
        exact = FT.topk_agreement(fn(tq, tdb, nv, k, group), want)
        unit_want = plain(uq, udb, n, k, group)
        check = FT.topk_agreement(fn(uq, udb, n, k, group), unit_want,
                                  tol=2e-6)
        torch.cuda.synchronize()
        planted = {f: FT.topk_agreement(fault(), want)
                   for f, fault in faults.items()}
        if grouped and storage == "float32":
            planted["tf32_only_product"] = FT.topk_agreement(
                _tf32_only(FT, uq, udb, n, k, group), unit_want,
                tol=2e-6)
        what = "overflows" if grouped else "flushes"
        more = {f"{what}_unit": events(uq, udb, n),
                f"{what}_tied": events(tq, tdb, nv)}
        ms = _cuda_ms(torch, lambda: fn(uq, udb, n, k, group), 10)
        plain_ms = _cuda_ms(torch, lambda: plain(uq, udb, n, k, group), 5)
        lq = uq.to(udb.dtype)
        library_ms = _cuda_ms(
            torch, lambda: torch.topk((lq @ udb.T).float(), k), 10)
        parts = (_topk_parts(torch, FT, uq, udb, n, k, group) if grouped
                 else _threshold_parts(torch, FT, uq, udb, n, k))
        parts.pop("flushes", None)  # the row has them as flushes_unit
    caught = not any(c["ok"] for c in planted.values())
    ok = exact["ok"] and check["ok"] and caught
    itemsize = udb.element_size()
    ops = 2 * qn * n * d
    if grouped and storage == "float32":
        ops, peak = 3 * ops, PEAK_OPS_TF32
    else:
        peak = PEAK_OPS_F32 if storage == "float32" else PEAK_OPS
    bound_ms, bound_by = _bound(
        ops, n * d * itemsize + qn * d * 4 + qn * k * 12, peak)
    say("kernels", name=f"{name}[{tag}]", shape=f"{qn}x{n}x{d}", k=k,
        dtype=storage, tied_identical=exact["ok"],
        tied_mismatched=exact["mismatched"],
        max_abs_err=f"{check['max_abs_err']:.3g}", err_bound="2e-06",
        near_tie_swaps=check["mismatched"],
        planted_mismatched=",".join(f"{f}:{c['mismatched']}"
                                    for f, c in planted.items()),
        planted="FAIL(expected)" if caught else "PASSED(wrong)",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
        library_ms=f"{library_ms:.4f}", library="torch.topk(q@db.T,k)",
        **more,
        **{f: f"{v:.3g}" if f.endswith("err") else f"{v:.4f}"
           for f, v in parts.items()},
        status="ok" if ok else "FAIL")
    results.append(dict(name=name, tag=tag,
                        key=(name, n if d == INDEX_D else None, d),
                        max_abs_err=check["max_abs_err"], ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms, ok=ok,
                        **({"source": TOPK_SOURCES[storage]}
                           if grouped else {})))


def _topk_parts(torch, FT, q, db, n_valid, k, group) -> dict:
    """ms of the fused_topk path's parts on one chunk (every query, all
    groups: Q <= ops.fused_topk.CHUNK_QUERIES), CUDA events: the product
    into Sᵀ (wt_topk_gemm on bf16 storage, wt_topk_gemm_f32 with its query
    split on f32), the selection from it (wt_topk_select), the merge of the
    candidates (one torch.topk); and the product's Sᵀ against its plain
    version (``gemm_max_abs_err``). Not counted as launches."""
    qn, d = q.shape
    q_pad = -(-qn // 8) * 8
    if db.dtype == torch.bfloat16:
        op = torch.zeros((d, q_pad), dtype=torch.bfloat16, device="cuda")
        op[:, :qn] = q.to(torch.bfloat16).T
        product, plain = FT.scores_t_cuda, FT.scores_t_plain
    else:
        op = torch.zeros((q_pad, d), device="cuda")
        op[:qn] = q
        product, plain = FT.scores_t_f32_cuda, FT.scores_t_f32_plain
    st = torch.empty((db.shape[0], q_pad), device="cuda")
    out_s = torch.empty((db.shape[0] // group, qn, k), device="cuda")
    out_r = torch.empty(out_s.shape, dtype=torch.int32, device="cuda")
    gemm_ms = _cuda_ms(torch, lambda: product(db, op, st), 10)
    select_ms = _cuda_ms(torch, lambda: FT.select_groups_cuda(
        st, 0, n_valid, k, group, out_s, out_r, 0, qn), 10)
    merge_ms = _cuda_ms(torch, lambda: FT._merge(out_s, out_r, k), 10)
    want = torch.empty_like(st)
    plain(db, op, want)
    err = float((st - want).abs().max())
    del want, st
    return {"gemm_ms": gemm_ms, "select_ms": select_ms, "merge_ms": merge_ms,
            "gemm_max_abs_err": err}


def _threshold_parts(torch, FT, q, db, n_valid, k) -> dict:
    """ms of fused_topk_threshold's parts, CUDA events: the scan alone
    (wt_topk_threshold into its (ranges, Q, k) candidates, no merge), the
    same launch with the merge by the last CTA (``kernel_ms``, what the
    wrapper launches), the merge's share (their difference), and a merge of
    the candidates in torch ops (``_merge``: one keyed torch.topk, used by
    the group path) for comparison, and the lists one call with the merge
    flushed. Not counted as launches."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    qn = q.shape[0]
    ranges = FT.scan_plan(db.shape[0], qn, k, sms)[0]
    out_s = torch.empty((ranges, qn, k), device="cuda")
    out_r = torch.empty(out_s.shape, dtype=torch.int32, device="cuda")
    top = (torch.empty((qn, k), device="cuda"),
           torch.empty((qn, k), dtype=torch.int64, device="cuda"))
    q = q.float().contiguous()
    scan_ms = _cuda_ms(torch, lambda: FT.threshold_scan_cuda(
        q, db, n_valid, k, out_s, out_r), 10)
    kernel_ms = _cuda_ms(torch, lambda: FT.threshold_scan_cuda(
        q, db, n_valid, k, out_s, out_r, top), 10)
    torch_merge_ms = _cuda_ms(torch, lambda: FT._merge(out_s, out_r, k), 10)
    FT.reset_flushes(db.device)
    FT.threshold_scan_cuda(q, db, n_valid, k, out_s, out_r, top)
    return {"scan_ms": scan_ms, "kernel_ms": kernel_ms,
            "merge_ms": kernel_ms - scan_ms,
            "torch_merge_ms": torch_merge_ms,
            "flushes": FT.flush_count(db.device)}


def _topk_rows(torch, results):
    for d, rows in ((INDEX_D, TOPK_ROWS), (WIDE_D, TOPK_WIDE_ROWS)):
        data = _topk_inputs(torch, d)
        for row in rows:
            _topk_row(torch, results, data, *row)
        del data
        torch.cuda.empty_cache()


def phase_kernels(torch):
    """Each kernel against its plain version at the serve paths' shapes
    (BLOCK_SHAPES, SWIN_STAGES, POSTLN_SHAPES, SHORT_ATTN_SHAPES), on the
    op's increment over its residual input (on the whole output where it
    has none), with planted faults that must fail the same check; the top-k
    kernels at TOPK_ROWS on their (scores, rows). Returns (the rows, the
    rows of the kernels timed alone: ALONE)."""
    results = []
    for tag, shape in BLOCK_SHAPES.items():
        _block_rows(torch, results, tag, shape)
    for tag, shape in TRAIN_SHAPES.items():
        _train_rows(torch, results, tag, shape)
    _swin_rows(torch, results)
    for tag, shape in POSTLN_SHAPES.items():
        _postln_rows(torch, results, tag, shape)
    _short_attention_rows(torch, results)
    alone = _alone_rows(torch)
    _gemm_rows(torch, results)
    _gemm_refuses_misaligned(torch)
    _topk_rows(torch, results)
    _require_rows(results)
    _backward_rows(torch)
    return results, alone


def _pooled_phase(torch, results, parent=False):
    """``--phase pooled``: the pooled block rows at every shape that has
    one (with their planted faults), then the pooled attention and the
    gather alone (ALONE). Run from the parent's checkout with ``parent``
    to time its kernels in turns with this tree's."""
    for tag, shape in BLOCK_SHAPES.items():
        if shape.get("pooled", True) and not shape.get("only_attn"):
            _pooled_rows(torch, results, tag, shape)
    _alone_rows(torch, ("attention_pooled_kernel", "gather_rows_kernel"),
                parent)


def _require_rows(results) -> None:
    bad = [f"{r['name']}[{r['tag']}]" for r in results if not r["ok"]]
    if bad:
        raise PhaseError(f"kernels disagree with their plain versions, or "
                         f"the check missed a planted fault: {bad}")


def _frames(seed: int, n: int, size: int):
    """Seeded synthetic frames: a coarse random 7x7 colour layout upsampled
    to the frame size, plus pixel noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cell = -(-size // 7)
    base = rng.integers(0, 256, (n, 7, 7, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, cell, 1), cell, 2)[:, :size, :size]
    img = img + rng.integers(-20, 21, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _ingest(project_dir: Path, extractor, model_id: str, clips,
            audio: bool = False):
    """Register one media row per clip and embed it through the extract
    pipeline's batched embedder, feature store and DB writes: a clip is a
    (frames, 224, 224, 3) uint8 VIDEO at 2 fps, in batches of 256, or with
    ``audio`` an (n, 192000) float32 AUDIO file of n 4 s segments at
    48 kHz, in the pipeline's audio batches of 256 // 8 = 32."""
    import numpy as np
    from wise_tpu_torch import config, data_models as dm, db, project, store
    from wise_tpu_torch.db import repository
    from wise_tpu_torch.pipeline.extract import (ExtractionStats,
                                                 _BatchedEmbedder)

    modality = "audio" if audio else "video"
    cfg = config.WiseConfig()
    proj = project.WiseProject(project_dir, create_project=True)
    proj.save_config(cfg)
    conn = db.init_project(proj.db_path)
    sc = repository.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(project_dir / "media"),
        type=dm.SourceCollectionType.DIR))
    fstore = store.FeatureStoreFactory.create_store(
        cfg.store.store_type, modality, proj.create_features_dir(model_id))
    fstore.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
    stats = ExtractionStats()
    embedder = _BatchedEmbedder(
        extractor, fstore, conn, dm.ModalityType(modality),
        256 // 8 if audio else 256, stats, f"num_{modality}_vectors")
    seg_s = cfg.audio.segment_length
    t0 = time.perf_counter()
    for i, clip in enumerate(clips):
        if audio:
            meta = dict(path=f"clip{i:03d}.wav", media_type=dm.MediaType.AUDIO,
                        format="wav", width=0, height=0,
                        duration=seg_s * len(clip))
        else:
            meta = dict(path=f"clip{i:03d}.mp4", media_type=dm.MediaType.VIDEO,
                        format="mp4", width=clip.shape[2],
                        height=clip.shape[1], num_frames=len(clip),
                        duration=len(clip) / 2)
        media = repository.MediaRepo().create(conn, dm.MediaMetadata(
            source_collection_id=sc.id, **meta))
        if audio:
            for j, seg in enumerate(clip):
                embedder.add_segment(media.id, seg, seg_s * j, seg_s * (j + 1))
        else:
            embedder.add_frames(media.id, clip,
                                np.arange(len(clip), dtype=np.float64) / 2)
    embedder.finish()
    fstore.close()
    conn.commit()
    conn.close()
    n = stats.audio_segments_embedded if audio else stats.frames_embedded
    return n, time.perf_counter() - t0


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=300) as r:
        if r.status != 200:
            raise PhaseError(f"GET {url}: HTTP {r.status}")
        return json.loads(r.read())


def _served_top(resp, k: int, media: str = "video"):
    """(vector ids, distances) of a /search response, best first."""
    vr = resp.get(f"{media}_results") or {}
    wins = vr.get("unmerged_windows")
    if not isinstance(wins, list) or len(wins) != k or not vr.get(f"{media}s"):
        raise PhaseError(f"malformed search response: {str(resp)[:300]}")
    pairs = [(int(w["vector_id"]), float(w["distance"])) for w in wins]
    if not all(math.isfinite(d) and -1.01 <= d <= 1.01 for _, d in pairs):
        raise PhaseError(f"non-finite or out-of-range distances: {pairs}")
    pairs.sort(key=lambda p: (-p[1], p[0]))
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _check_against_plain(served_ids, served_d, plain_scores, ids, k, tol):
    """The served top-k against the plain run's ranking: the same ids up to
    swaps between scores within ``tol``, distances within ``tol`` (plus the
    response's 3-decimal rounding) of the plain scores. Returns the largest
    distance gap, that rounding included."""
    import numpy as np

    by_id = dict(zip(ids.tolist(), plain_scores.tolist()))
    order = np.lexsort((ids, -plain_scores))[:k]
    plain_top = plain_scores[order]
    got = np.array([by_id[i] for i in served_ids])
    if np.abs(np.sort(got)[::-1] - plain_top).max() > tol:
        raise PhaseError(
            f"served ids {served_ids} are not the plain top-{k} "
            f"{ids[order].tolist()} (plain scores {got} vs {plain_top})")
    gap = float(np.abs(got - np.array(served_d)).max())
    if gap > tol + 5e-4:
        raise PhaseError(f"served distances {served_d} vs plain {got}")
    return gap


def _serve_queries(project_dir: Path, config, queries, k: int,
                   media: str = "video"):
    """Serve the project over REST on localhost (coalescing on) and send a
    warm-up, every query three times in turn, and a burst of every query at
    once. Returns ({query: (ids, distances)}, sequential latencies in s);
    the burst must return what the sequential requests did."""
    from wise_tpu_torch.api.server import create_server

    config.serve.coalesce = True
    server = create_server(project_dir, "127.0.0.1", 0, config=config)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = (f"http://127.0.0.1:{server.server_address[1]}/"
            f"{project_dir.name}/search?search_in={media}&end={k}&q=")
    served, lat, burst = {}, [], {}

    def fetch(q, out):
        out[q] = _served_top(_get_json(base + urllib.parse.quote(q)), k,
                             media)

    try:
        _get_json(base + "warm")
        for _ in range(3):
            for q in queries:
                t0 = time.perf_counter()
                fetch(q, served)
                lat.append(time.perf_counter() - t0)
        workers = [threading.Thread(target=fetch, args=(q, burst))
                   for q in queries]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    if set(burst) != set(queries):
        raise PhaseError("concurrent requests failed")
    for q in queries:
        if burst[q][0] != served[q][0]:
            raise PhaseError(f"{q!r}: concurrent and sequential top-{k} "
                             f"differ: {burst[q][0]} vs {served[q][0]}")
    return served, lat


def _vector_ids(project_dir: Path):
    import numpy as np
    from wise_tpu_torch import db, project

    conn = db.connect(project.WiseProject(project_dir).db_path, readonly=True)
    ids = np.array([r[0] for r in conn.execute(
        "SELECT id FROM vectors ORDER BY id")])
    conn.close()
    return ids


def _twin(torch, extractor, fused_block=False, fused_attention=False,
          dtype=None):
    """The extractor on another path with the same weights: a shallow copy
    around a second model on the card. Both switches off is the plain
    PyTorch path (with ``fused_block`` alone off, the attention middle would
    still be a kernel); ``fused_attention`` alone on is the path of
    WISE_FUSED_BLOCK=0. ``dtype`` "float32" computes and keeps the weights
    in f32 (each bf16 weight is exact there; TF32 is off)."""
    import copy
    import dataclasses

    from wise_tpu_torch.models.clip.model import CLIP

    with torch.device(extractor.device):
        model = CLIP(dataclasses.replace(
            extractor.config, fused_block=fused_block,
            fused_attention=fused_attention,
            dtype=dtype or extractor.config.dtype))
    model.load_state_dict(extractor.model.state_dict())
    twin = copy.copy(extractor)
    twin.config = model.config
    twin.model = model.eval().requires_grad_(False)
    return twin


#: the two-kernel MLP pairs: (pair, first half, second half). A pair launches
#: nothing of its own, so its count is derived from its halves'
SPLIT_PAIRS = [("fused_mlp_split", "fused_mlp_fc", "fused_mlp_proj"),
               ("fused_mlp_split_res", "fused_mlp_fc_res", "fused_mlp_proj"),
               ("fused_postln_mlp_split", "fused_postln_fc",
                "fused_postln_proj")]


def _launch_modules():
    from wise_tpu_torch.ops import (attention, block, embed_block, fused_topk,
                                    postln_block)

    return block, postln_block, attention, fused_topk, embed_block


def _reset_launches():
    for mod in _launch_modules():
        mod.reset_launches()


def _block_launches():
    """The block, post-LN and attention wrappers' launch counts by (wrapper,
    SP, D), and the top-k wrappers' by (wrapper, N_pad, D). A split MLP pair launches nothing of its own (its halves count
    themselves), so its count at a shape is derived here: the lesser of its
    halves' counts."""
    counts = {}
    for mod in _launch_modules():
        counts.update(mod.LAUNCHES_BY_SHAPE)
    for pair, first, second in SPLIT_PAIRS:
        for (name, *shape), n in list(counts.items()):
            if name == first:
                both = min(n, counts.get((second, *shape), 0))
                if both:
                    counts[(pair, *shape)] = both
    return counts


def _vision_tokens(config) -> int:
    """The vision tower's tokens: the patches, and the class token unless
    the tower is MAP-pooled (SigLIP)."""
    c = config
    return (c.image_size // c.patch_size) ** 2 + int(c.vision_pool == "cls")


def _tower_keys(config):
    """(vision keys, text keys) of the launch counters a CLIP config's
    towers reach: (wrapper, tokens, width) of the attention block, the MLP
    wrapper its width takes, and the pooled last layer (none for a
    MAP-pooled vision tower, whose every layer runs whole; the static-row
    block for SigLIP's last-token text tower, the per-example one for EOT
    pooling); for the XLM-R text tower the post-LN attention block and the
    MLP variant its width takes (every layer runs whole: the tower pools by
    a mean)."""
    from wise_tpu_torch.ops.block import mlp_choice
    from wise_tpu_torch.ops.postln_block import postln_mlp_choice

    def keys(sp, d, pooled):
        mlp = ("fused_mlp_block" if mlp_choice(d) == "single"
               else "fused_mlp_split")
        return [("fused_attn_block", sp, d), (mlp, sp, d)] + (
            [(pooled, sp, d)] if pooled else [])

    c = config
    vision = keys(_vision_tokens(c), c.vision_width,
                  "fused_attn_block_pooled" if c.vision_pool == "cls"
                  else None)
    if c.text_tower == "hf_xlm_roberta":
        mlp = ("fused_postln_mlp_block"
               if postln_mlp_choice(c.text_width) == "single"
               else "fused_postln_mlp_split")
        return vision, [("fused_postln_attn_block", c.context_length,
                         c.text_width), (mlp, c.context_length, c.text_width)]
    return vision, keys(c.context_length, c.text_width,
                        "fused_attn_block_pooled" if c.text_pool == "last"
                        else "fused_attn_block_pooled_dyn")


@contextlib.contextmanager
def _text_batches():
    """Counts the text batches embedded while the block runs, by every CLIP
    model of the process (the server builds its own): the list gains one
    entry, the bucket-padded batch's rows, for each ``CLIP.encode_text``
    call. It reads no launch counter, so the counters can be held to it."""
    from wise_tpu_torch.models.clip.model import CLIP

    sizes, encode_text = [], CLIP.encode_text

    def counted(self, tokens):
        sizes.append(len(tokens))
        return encode_text(self, tokens)

    CLIP.encode_text = counted
    try:
        yield sizes
    finally:
        CLIP.encode_text = encode_text


def _check_text_launches(phase, config, text, launches, batches):
    """The text tower's counts over the served requests, held to the
    ``batches`` that ``_text_batches`` counted and to what the code implies:
    a CLIP text batch launches layers - 1 attention blocks and MLPs and one
    pooled last layer; an XLM-R batch launches every layer's attention block
    and MLP pair."""
    got = [launches.get(key, 0) for key in text]
    layers = config.text_layers
    if config.text_tower == "hf_xlm_roberta":
        want = [batches * layers] * 2
    else:
        want = [batches * (layers - 1)] * 2 + [batches]
    if not batches or got != want:
        raise PhaseError(f"{phase}: text launches {dict(zip(text, got))} over "
                         f"{batches} text batches, expected {want}")


def _hybrid_batch(torch, extractor, plain, frames, queries=()):
    """``frames`` (and ``queries``) through the extractor's twin with
    ``fused_block`` off and ``fused_attention`` on, the path of
    WISE_FUSED_BLOCK=0: every non-pooled layer must launch
    fused_short_attention once a batch and no block kernel, and the
    embeddings must agree with the plain twin's (min cosine >= 0.9995).
    Returns (launches by (wrapper, SP, D), min cosine, device ms of the
    image batch on the hybrid path)."""
    from wise_tpu_torch.ops import attention as A

    c = extractor.config
    hybrid = _twin(torch, extractor, fused_attention=True)
    A.reset_launches()
    before = _block_launches()
    got = [hybrid.extract_image_features(frames)]
    expect = {("fused_short_attention", _vision_tokens(c), c.vision_width):
              c.vision_layers - int(c.pool_last_block
                                    and c.vision_pool == "cls")}
    if queries:
        got.append(hybrid.extract_text_features(list(queries)))
        expect[("fused_short_attention", c.context_length, c.text_width)] = (
            c.text_layers - int(c.pool_last_block))
    counts = dict(A.LAUNCHES_BY_SHAPE)
    if counts != expect or _block_launches() != {**before, **counts}:
        raise PhaseError(f"hybrid: launched {counts}, expected {expect} and "
                         f"no other kernel")
    want = [plain.extract_image_features(frames)]
    if queries:
        want.append(plain.extract_text_features(list(queries)))
    cos = min(torch.nn.functional.cosine_similarity(
        torch.from_numpy(g), torch.from_numpy(w), dim=-1).min().item()
        for g, w in zip(got, want))
    if not cos >= 0.9995:
        raise PhaseError(f"hybrid: embeddings off the plain path (min cos "
                         f"{cos:.6f} < 0.9995)")
    return counts, cos, _encode_rates(torch, hybrid, frames)[1]


def _check_searches(phase, extractor, launches, searched) -> dict:
    """The served queries' searches on the index at the tower's width D:
    one ``fused_topk_threshold`` launch a search batch (_search_batches),
    and no ``fused_topk`` and no top-k off the kernels."""
    d = extractor.config.embed_dim
    thr = sum(n for key, n in launches.items()
              if key[0] == "fused_topk_threshold" and key[2] == d)
    grp = sum(n for key, n in launches.items()
              if key[0] == "fused_topk" and key[2] == d)
    if not searched or (thr, grp) != (len(searched), 0):
        raise PhaseError(f"{phase}: {len(searched)} served search batches "
                         f"(rows {searched}) launched {thr} threshold scans "
                         f"and {grp} batched top-k at D {d}; expected one "
                         f"scan a batch")
    return dict(search_batches=len(searched), threshold_launches=thr,
                embed_dim=d)


def _batched_search(torch, phase, project_dir, model_id, k=100):
    """The loaded IndexFlatIP's batched search (``search_batch``) at Q = 64,
    k = 100, the stored vectors' first 64 as queries: exactly one
    ``fused_topk`` launch at the index's width, and (scores, rows) within
    2e-6 of a plain top-k over the index's own rows (_stable_topk of the
    product)."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.config import IndexConfig
    from wise_tpu_torch.index.feature_index import FeatureSearchIndex
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.ops import topk as TK

    asset = project.WiseProject(project_dir).discover_assets()["video"][
        model_id]
    idx = FeatureSearchIndex("video", model_id, asset, config=IndexConfig())
    if not idx.load_index("IndexFlatIP"):
        raise PhaseError(f"{phase}: no IndexFlatIP file")
    db = idx._ensure_device_db()
    n_valid, d = int(idx._metadata["count"]), db.shape[1]
    q = db[:64].float().cpu().numpy()
    before = dict(FT.LAUNCHES_BY_SHAPE)
    got = idx.search_batch(q, k)
    new = {key: n - before.get(key, 0)
           for key, n in FT.LAUNCHES_BY_SHAPE.items()
           if n != before.get(key, 0)}
    if new != {("fused_topk", db.shape[0], d): 1}:
        raise PhaseError(f"{phase}: search_batch(64, k={k}) launched {new}")
    with torch.inference_mode():
        want = TK._stable_topk(torch.from_numpy(q).cuda()
                               @ db[:n_valid].float().T, k)
    want_ids = np.asarray(idx._arrays["ids"])[want[1].cpu().numpy()]
    check = FT.topk_agreement(
        (torch.from_numpy(got[0]), torch.from_numpy(got[1])),
        (want[0].cpu(), torch.from_numpy(want_ids)), tol=2e-6)
    if not check["ok"]:
        raise PhaseError(f"{phase}: search_batch(64, k={k}) off the plain "
                         f"top-k: {check}")
    return dict(batched_search=f"q64_k{k}",
                batched_max_abs_err=f"{check['max_abs_err']:.3g}")


def phase_slice(torch, card, model_id=MODEL_ID, n_frames=FRAMES,
                phase="slice", topk_1m=True, size=224, k=10,
                hybrid_frames=0, searches=False, project_hook=None):
    """Ingest -> IndexFlatIP -> REST on the port; returns the launch counts
    of the main path's run, keyed by (wrapper, SP, D). The vision tower's
    counts must be exact: batches x (layers - 1) for the attention block and
    the MLP, batches for the pooled last layer (a MAP-pooled tower: batches
    x layers and no pooled layer); the text tower's must fit the count of
    text batches served (_text_batches, _check_text_launches). Frames are
    ``size`` px, the model's input, so no host resize runs. With
    ``hybrid_frames`` that many frames also go through the path of
    WISE_FUSED_BLOCK=0 (_hybrid_batch). With ``searches`` the served
    queries' searches are counted (_search_batches): one threshold-scan
    launch a search batch at the index's width, no other top-k launch; and
    the batched search (_batched_search) runs once. ``project_hook(extractor,
    project_dir, clips)`` runs on the finished project before it is
    removed."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops.topk import flat_topk

    clip_len = 256
    seeds = range((n_frames + clip_len - 1) // clip_len)
    clips = [_frames(s, min(clip_len, n_frames - s * clip_len), size)
             for s in seeds]
    with tempfile.TemporaryDirectory(prefix="wise_smoke_") as tmp:
        project_dir = Path(tmp) / "proj"
        t0 = time.perf_counter()
        extractor = OpenClipExtractor(model_id)
        build_s = time.perf_counter() - t0
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_image_features(clips[0][:8])
            extractor.extract_text_features(["warm up"])

        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        n, ingest_s = _ingest(project_dir, extractor, model_id, clips)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if n != n_frames:
            raise PhaseError(f"embedded {n} of {n_frames} frames")
        vision, text = _tower_keys(extractor.config)
        whole = extractor.config.vision_layers - int(len(vision) == 3)
        want = dict(zip(vision, [len(clips) * whole] * 2 + [len(clips)]))
        launches = _block_launches()
        got = {key: launches.get(key, 0) for key in vision}
        if got != want:
            raise PhaseError(f"{phase}: ingest launched {got}, expected "
                             f"{want}")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        with _text_batches() as batch_sizes, _search_batches() as searched:
            served, lat = _serve_queries(project_dir, config, QUERIES, k)
        launches = _block_launches()
        fields = {}
        if searches:
            fields.update(_check_searches(phase, extractor, launches,
                                          searched))
        idle = [key for key in vision + text if not launches.get(key)]
        if idle:
            raise PhaseError(f"{phase}: not launched on the path: {idle}")
        text_batches = len(batch_sizes)
        _check_text_launches(phase, extractor.config, text, launches,
                             text_batches)

        # the same frames and queries through the plain PyTorch path in
        # float32 on the same weights: the served scores are held to the
        # function itself, not to a second bf16 path, whose own rounding
        # moves with the weights (ROADMAP C 12). The plain bf16 twin is
        # timed and runs the WISE_FUSED_BLOCK=0 comparison below
        plain = _twin(torch, extractor)
        exact = _twin(torch, extractor, dtype="float32")
        ids = _vector_ids(project_dir)
        vecs = np.concatenate([
            np.concatenate([exact.extract_image_features(c[i:i + 256])
                            for i in range(0, len(c), 256)])
            for c in clips])
        if _block_launches() != launches:
            raise PhaseError(f"{phase}: the plain run launched kernels")
        prefix = config.search.query_prefix
        gap = 0.0
        for q in QUERIES:
            qv = exact.extract_text_features([f"{prefix} {q}".strip()])[0]
            scores = (torch.from_numpy(vecs) @ torch.from_numpy(qv)).numpy()
            gap = max(gap, _check_against_plain(*served[q], scores, ids, k,
                                                1e-3))
        del exact
        torch.cuda.empty_cache()

        extra = []
        if searches:
            fields.update(_batched_search(torch, phase, project_dir,
                                          model_id))
            launches = _block_launches()
        if project_hook:
            fields.update(project_hook(extractor, project_dir, clips))
        if hybrid_frames:
            frames = clips[0][:hybrid_frames]
            counts, cos, ms = _hybrid_batch(torch, extractor, plain, frames)
            launches.update(counts)
            extra.append(dict(
                path="WISE_FUSED_BLOCK=0", batch=len(frames),
                launches=json.dumps({_launch_name(key): v for key, v
                                     in sorted(counts.items())},
                                    separators=(",", ":")),
                min_cos_vs_plain=f"{cos:.6f}",
                device_ms_per_batch=f"{ms:.3f}"))
        if topk_1m:
            # text embed + exact flat top-k p50 on a device-resident 1M x
            # 512 database (flat_topk called directly: no index, HTTP or
            # hydration)
            g = torch.Generator(device=extractor.device).manual_seed(0)
            big = torch.randn(1 << 20, extractor.output_dim, generator=g,
                              device=extractor.device)
            big = big / big.norm(dim=1, keepdim=True)
            lat_1m = []
            for i in range(25):
                t0 = time.perf_counter()
                qv = extractor.extract_text_features([QUERIES[i % 8]])
                _, rows = flat_topk(torch.from_numpy(qv), big,
                                    n_valid=big.shape[0], k=k)
                rows.cpu()
                lat_1m.append(time.perf_counter() - t0)
            del big
            fields["embed_topk_1M_p50_ms"] = (
                f"{1e3 * float(np.median(lat_1m[5:])):.3f}")
        rates = {name: _encode_rates(torch, fe, clips[0])
                 for name, fe in (("kernels", extractor), ("plain", plain))}

    say(phase, card=repr(card), model=model_id.split("/")[2], frames=n,
        extractor_build_s=f"{build_s:.3f}", ingest_s=f"{ingest_s:.3f}",
        frames_per_s=f"{n / ingest_s:.1f}",
        ingest_peak_device_gb=f"{peak_gb:.3f}", requests=len(lat) + 9,
        text_batches=text_batches, text_batch_rows=sum(batch_sizes),
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}", **fields,
        launches=json.dumps({_launch_name(key): c for key, c
                             in sorted(launches.items())},
                            separators=(",", ":")),
        vs_plain="ok", served_gap_max=f"{gap:.6f}")
    for line in extra:
        say(phase, card=repr(card), **line)
    for name, (fps, tower_ms) in rates.items():
        say(phase, card=repr(card), path=name, batch=len(clips[0]),
            extractor_frames_per_s=f"{fps:.1f}",
            device_ms_per_batch=f"{tower_ms:.3f}",
            device_frames_per_s=f"{1e3 * len(clips[0]) / tower_ms:.1f}")
    return launches


#: the doctor's lines that must pass on the card's machine; its native
#: decoder (FFmpeg's libraries) and OpenCV may be missing there and are
#: printed as they come
DOCTOR_REQUIRED = ("cuda devices", "device compute", "nvcc",
                   "kernel library", "sqlite FTS5", "project assets",
                   "project db")


def _doctor_and_trace(extractor, project_dir, clips) -> dict:
    """The doctor CLI (``python -m wise_tpu_torch.cli.doctor``) on the
    phase's project, in a process of its own: every line printed, those of
    DOCTOR_REQUIRED must read PASS, and its exit code is reported (nonzero
    where any line fails, as the reference's). Then one ingest batch inside
    ``utils.profiling.trace`` with WISE_TRACE_DIR in a temporary directory:
    the Chrome trace must be written and hold CUDA kernel events, which are
    counted."""
    from wise_tpu_torch.utils.profiling import trace

    run = subprocess.run(
        [sys.executable, "-m", "wise_tpu_torch.cli.doctor", "--project-dir",
         str(project_dir)], capture_output=True, text=True, cwd=ROOT,
        timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    lines = {}
    for ln in run.stdout.splitlines():
        if ln[:4] in ("PASS", "FAIL"):
            say("doctor", line=repr(ln[:200]))
            lines[ln[6:].split(":")[0]] = ln[:4]
    failed = [n for n in DOCTOR_REQUIRED if lines.get(n) != "PASS"]
    if failed:
        raise PhaseError(f"doctor: {failed} did not pass "
                         f"(rc {run.returncode}): {run.stdout[-2000:]} "
                         f"{run.stderr[-2000:]}")
    with tempfile.TemporaryDirectory(prefix="wise_trace_") as tmp:
        with _env(WISE_TRACE_DIR=tmp), trace("ingest_batch"):
            extractor.extract_image_features(clips[0])
        files = list(Path(tmp, "ingest_batch").glob("trace_*.json"))
        if len(files) != 1:
            raise PhaseError(f"trace: wrote {files}, expected one trace")
        events = json.loads(files[0].read_text()).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        nbytes = files[0].stat().st_size
    if not kernels:
        raise PhaseError(f"trace: no CUDA kernel event in {nbytes} bytes of "
                         f"trace: the profiler saw no device activity")
    return dict(doctor_rc=run.returncode,
                doctor_pass=sum(v == "PASS" for v in lines.values()),
                doctor_lines=len(lines), trace_bytes=nbytes,
                trace_kernel_events=kernels)


def phase_wide(torch, card, model_id, phase):
    """phase_slice for the registry's two largest towers (ViT-g-14 with the
    doctor and the trace hook on its project, ViT-bigG-14): 512 frames in
    2 batches, IndexFlatIP over REST, the served searches and a batched one
    counted at the tower's width, a 64-frame batch through
    WISE_FUSED_BLOCK=0."""
    return phase_slice(
        torch, card, model_id, WIDE_FRAMES, phase, topk_1m=False,
        hybrid_frames=64, searches=True,
        project_hook=_doctor_and_trace if phase == "vit_g" else None)


def phase_families(torch, card, batch: int = 64):
    """One batch of frames through the port's extractor for each further
    tower the attention kernels take (FAMILY_IDS), at full width and depth
    and the model's frame size: embeddings against the plain path, every
    vision kernel launched. Returns the launch counts keyed by (wrapper, SP,
    D)."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    launches = {}
    for model_id in FAMILY_IDS:
        extractor = OpenClipExtractor(model_id)
        frames = _frames(99, batch, extractor.config.image_size)
        _reset_launches()
        got = torch.from_numpy(extractor.extract_image_features(frames))
        counts = _block_launches()
        vision, _ = _tower_keys(extractor.config)
        idle = [key for key in vision if not counts.get(key)]
        if idle:
            raise PhaseError(f"families: not launched: {idle}")
        plain = _twin(torch, extractor)
        want = torch.from_numpy(plain.extract_image_features(frames))
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        hybrid, hybrid_cos, hybrid_ms = _hybrid_batch(torch, extractor, plain,
                                                      frames)
        counts.update(hybrid)
        ms = _encode_rates(torch, extractor, frames)[1]
        plain_ms = _encode_rates(torch, plain, frames)[1]
        say("families", card=repr(card), model=model_id.split("/")[2],
            batch=batch, min_cos_vs_plain=f"{cos.min().item():.6f}",
            device_ms_per_batch=f"{ms:.3f}",
            plain_device_ms_per_batch=f"{plain_ms:.3f}",
            hybrid_device_ms_per_batch=f"{hybrid_ms:.3f}",
            hybrid_min_cos_vs_plain=f"{hybrid_cos:.6f}",
            launches=json.dumps({_launch_name(key): c for key, c
                                 in sorted(counts.items())},
                                separators=(",", ":")))
        if not (got.shape == want.shape and bool(torch.isfinite(got).all())
                and cos.min().item() >= 0.999):
            raise PhaseError(f"families: {model_id} embeddings off the "
                             f"plain path (min cos {cos.min().item():.6f})")
        launches.update(counts)
        del extractor, plain
        torch.cuda.empty_cache()
    return launches


def phase_siglip(torch, card):
    """phase_slice for ViT-L-16-SigLIP-384, upstream WISE's integration-test
    model: 512 frames at 384 px in 2 batches (the MAP-pooled vision tower,
    576 tokens a frame: exactly 24 attention blocks and 24 split MLPs a
    batch and no pooled block), IndexFlatIP, the 8 queries over REST on the
    bidirectional text tower (the pooled block at row 63); one 64-frame
    batch also runs the path of WISE_FUSED_BLOCK=0."""
    return phase_slice(torch, card, SIGLIP_ID, SIGLIP_FRAMES, "siglip",
                       topk_1m=False, size=384, hybrid_frames=64)


def phase_hybrid(torch, card, batch: int = 256):
    """The production configuration with WISE_FUSED_BLOCK=0 for ViT-B/32:
    one 256-frame batch and the 8 queries through an extractor with
    ``fused_block`` off and ``fused_attention`` on, against the fully plain
    twin; fused_short_attention must launch once for every non-pooled layer
    of each tower. Returns the launch counts keyed by (wrapper, SP, D)."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    extractor = OpenClipExtractor(MODEL_ID)
    plain = _twin(torch, extractor)
    frames = _frames(0, batch, 224)
    counts, cos, ms = _hybrid_batch(torch, extractor, plain, frames, QUERIES)
    kernel_ms = _encode_rates(torch, extractor, frames)[1]
    plain_ms = _encode_rates(torch, plain, frames)[1]
    say("hybrid", card=repr(card), model=MODEL_ID.split("/")[2], batch=batch,
        queries=len(QUERIES), min_cos_vs_plain=f"{cos:.6f}",
        device_ms_per_batch=f"{ms:.3f}",
        block_kernels_device_ms_per_batch=f"{kernel_ms:.3f}",
        plain_device_ms_per_batch=f"{plain_ms:.3f}",
        launches=json.dumps({_launch_name(key): v for key, v
                             in sorted(counts.items())},
                            separators=(",", ":")))
    return counts


#: word lists of the train phase's synthetic captions
_CAPTION_WORDS = (
    ["a dog", "two cats", "a child", "an old man", "a red car", "the chef",
     "a cyclist", "three birds", "a fisherman", "the crowd"],
    ["running", "sleeping", "cooking", "waiting", "dancing", "reading",
     "jumping", "standing", "singing", "working"],
    ["on the beach", "in a kitchen", "at night", "in the snow", "by a river",
     "on a city street", "in the rain", "under a bridge", "in a garden",
     "at the market"])


def _captions(seed: int, n: int):
    """n seeded synthetic captions, all different (each ends in its own
    number)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    picks = rng.integers(0, 10, (n, 3))
    return [" ".join(words[j] for words, j in zip(_CAPTION_WORDS, row))
            + f" take {i}" for i, row in enumerate(picks)]


def _train_batch(torch, config, seed: int, n: int):
    """(images (n, S, S, 3) f32 in [0, 1], tokens (n, ctx) int64) on the
    card: what pipeline/train_data.py ``caption_batches`` yields, made from
    seeded synthetic frames and captions instead of decoded video (the
    card's machine has no cv2), tokenised as the train CLI tokenises them
    (the XLM-R tower's captions padded with its pad id, 1)."""
    from wise_tpu_torch.cli.train import training_tokenizer

    tokenizer = training_tokenizer(config)
    frames = _frames(seed, n, config.image_size).astype("float32") / 255.0
    tokens = tokenizer(_captions(seed, n))
    return (torch.from_numpy(frames).cuda(),
            torch.from_numpy(tokens.astype("int64")).cuda())


def _step_ms(torch, trainer, images, tokens, steps: int = 5):
    """Median ms of a train step's forward, backward and optimizer update
    (CUDA events around each, ``steps`` steps after one)."""
    import numpy as np

    rows = []
    for _ in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        trainer.optimizer.zero_grad()
        ev[0].record()
        loss = trainer.loss(images, tokens)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    fwd, bwd, opt = np.median(np.array(rows[1:]), axis=0)
    return dict(forward_ms=f"{fwd:.3f}", backward_ms=f"{bwd:.3f}",
                optimizer_ms=f"{opt:.3f}", step_ms=f"{fwd + bwd + opt:.3f}")


def _launches_by_name():
    """The block, post-LN and attention-middle wrappers' launches since the
    counters were last reset, by wrapper (those that launched)."""
    from wise_tpu_torch.ops import attention as A
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import postln_block as P

    return {k: v for mod in (K, P, A) for k, v in mod.LAUNCHES.items() if v}


def _counted_step(trainer, images, tokens):
    """One train step with every launch counter at 0 before it: (loss,
    launches by wrapper, launches by (wrapper, SP, D))."""
    _reset_launches()
    loss = float(trainer.train_step(images, tokens))
    return (loss, _launches_by_name(),
            {k: v for k, v in _block_launches().items() if v})


def _add_counts(total, counts):
    for key, n in counts.items():
        total[key] = total.get(key, 0) + n


def _step_launches(config, mp: int = 1):
    """What one train step of ``config`` launches, by wrapper. With
    ``fused_block``: every non-pooled layer of a CLIP tower its attention
    block and its MLP (the wrapper ``mlp_choice`` gives the tower's width)
    with their residuals, and the pooled last layer its pooled kernel; every
    layer of an XLM-R tower its post-LN attention block and MLP (the variant
    ``postln_mlp_choice`` gives). With ``fused_attention`` alone: every
    non-pooled layer of a CLIP tower the attention middle; the pooled last
    layer and the XLM-R tower are plain. Split over ``mp`` ranks (a rank's
    launches): a CLIP tower's layers take the head-split entries, the
    attention chain and the fc / proj pair at every width, and the pooled
    layer the head-split pooled chain; the XLM-R tower is whole."""
    from wise_tpu_torch.ops.block import mlp_choice
    from wise_tpu_torch.ops.postln_block import postln_mlp_choice

    c, want = config, {}

    def add(name, n):
        if n:
            want[name] = want.get(name, 0) + n

    towers = [(c.vision_width, c.vision_layers,
               "fused_attn_block_pooled" if c.vision_pool == "cls" else None)]
    if c.text_tower == "hf_xlm_roberta":
        if c.fused_block:
            add("fused_postln_attn_block", c.text_layers)
            for name in (["fused_postln_mlp_block"]
                         if postln_mlp_choice(c.text_width) == "single"
                         else ["fused_postln_fc", "fused_postln_proj"]):
                add(name, c.text_layers)
    else:
        towers.append((c.text_width, c.text_layers,
                       "fused_attn_block_pooled" if c.text_pool == "last"
                       else "fused_attn_block_pooled_dyn"))
    for width, layers, pooled in towers:
        whole = layers - int(bool(c.pool_last_block and pooled))
        if c.fused_block and mp > 1:
            add(pooled and pooled + "_mp", layers - whole)
            for name in ("fused_attn_block_mp", "fused_mlp_fc_mp",
                         "fused_mlp_proj_mp"):
                add(name, whole)
        elif c.fused_block:
            add(pooled, layers - whole)
            for name in ["fused_attn_block_res"] + (
                    ["fused_mlp_block_res"] if mlp_choice(width) == "single"
                    else ["fused_mlp_fc_res", "fused_mlp_proj"]):
                add(name, whole)
        elif c.fused_attention:
            add("fused_short_attention", whole)
    return want


def _check_first_grads(card, model, batch, gk, gp):
    """The first step's gradients of the kernel path (``gk``) against the
    plain twin's (``gp``), by parameter name: cosine >= 0.95 on every
    parameter whose plain gradient is not ~0 (1e-6 of the tree's norm), >=
    0.99 over the whole tree, all finite. Either dict may live on the card
    or on the host; the tree's sums are taken a tensor at a time, in f64."""
    import torch

    def dot(a, b):
        return float(torch.dot(a.flatten().double(), b.flatten().double()))

    norms = {k: dot(g, g) for k, g in gp.items()}
    floor = 1e-6 * math.sqrt(sum(norms.values()))
    cos = {k: _flat_cos(gk[k], g) for k, g in gp.items()
           if math.sqrt(norms[k]) > floor}
    worst = min(cos, key=cos.get)
    whole = sum(dot(gk[k], g) for k, g in gp.items()) / math.sqrt(
        sum(norms.values()) * sum(dot(g, g) for g in gk.values()))
    say("train", card=repr(card), model=model, batch=batch,
        check="first_step_gradients", parameters=len(gp), compared=len(cos),
        min_cos=f"{cos[worst]:.6f}", min_cos_at=worst, per_parameter_bar=0.95,
        whole_tree_cos=f"{whole:.6f}", whole_tree_bar=0.99)
    if not (cos[worst] >= 0.95 and whole >= 0.99
            and all(bool(g.isfinite().all()) for g in gk.values())):
        raise PhaseError(f"train: {model} kernel-path gradients off the "
                         f"plain twin's (min cos {cos[worst]:.4f} at "
                         f"{worst}, whole tree {whole:.4f})")


def _train_against_twin(torch, card, model, cfg, plain_cfg, batch, seed):
    """Three steps of ``cfg`` on its kernels and of ``plain_cfg`` (no
    kernel) from one f32 master tree, at the train CLI's learning rate and
    clip: the first step's gradients within the bars (_check_first_grads),
    the losses within 0.05 step by step, every kernel step's launches
    exactly ``_step_launches(cfg)`` and the twin's none; ms a step (forward,
    backward, optimizer apart), peak device memory and the launches of a
    step by (wrapper, SP, D). One trainer lives at a time: the master tree
    and the kernel path's first gradients wait on the host while the twin
    runs, so the card holds one tree, its gradients, its AdamW moments and
    one step's activations (the default backbone's two trainers would not
    fit side by side; ViT-B/32's comparison in phase_train keeps both to
    time them in turns). Returns the kernel steps' launches by (wrapper,
    SP, D)."""
    import gc

    from wise_tpu_torch.parallel.train import CLIPTrainer

    kw = dict(learning_rate=1e-5, grad_clip=1.0)
    batches = [_train_batch(torch, cfg, seed + i, batch) for i in range(3)]
    want = _step_launches(cfg)
    master, grads, losses, launches = None, {}, {}, {}
    for path, c in (("kernels", cfg), ("plain", plain_cfg)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        trainer = CLIPTrainer(c, **kw)
        trainer.init(seed=0) if master is None else trainer.init(
            params=master)
        if master is None:
            master = {k: v.detach().to("cpu", copy=True)
                      for k, v in trainer.params.items()}
        if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise PhaseError(f"train: a {model} master weight is not f32")
        init_s = time.time() - t0
        expect = want if path == "kernels" else {}
        _reset_launches()
        trainer.optimizer.zero_grad()
        trainer.loss(*batches[0]).backward()
        grads[path] = {k: p.grad.detach().to("cpu", copy=True)
                       for k, p in trainer.model.named_parameters()}
        if _launches_by_name() != expect:
            raise PhaseError(f"train: {model} {path} launched "
                             f"{_launches_by_name()}, expected {expect}")
        losses[path] = []
        for i, b in enumerate(batches):
            loss, by_name, by_shape = _counted_step(trainer, *b)
            if by_name != expect:
                raise PhaseError(f"train: a {model} {path} step launched "
                                 f"{by_name}, expected exactly {expect}")
            if path == "kernels":
                _add_counts(launches, by_shape)
                if i == 0:
                    step_shapes = by_shape
            losses[path].append(loss)
        say("train", card=repr(card), model=model, batch=batch, path=path,
            init_s=f"{init_s:.1f}", **_step_ms(torch, trainer, *batches[1],
                                                steps=3),
            peak_device_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    _check_first_grads(card, model, batch, grads["kernels"], grads["plain"])
    del grads, master
    gap = max(abs(a - b) for a, b in zip(losses["kernels"], losses["plain"]))
    say("train", card=repr(card), model=model, check="losses",
        kernels=",".join(f"{v:.5f}" for v in losses["kernels"]),
        plain=",".join(f"{v:.5f}" for v in losses["plain"]),
        max_gap=f"{gap:.5f}", bar=0.05,
        launches_per_step=json.dumps(want, separators=(",", ":")),
        launches_per_step_by_shape=",".join(
            f"{n}:{sp}x{d}={v}" for (n, sp, d), v in sorted(
                step_shapes.items())))
    if not (gap <= 0.05 and all(math.isfinite(v) for v in
                                losses["kernels"] + losses["plain"])):
        raise PhaseError(f"train: {model} losses differ step by step: "
                         f"{losses}")
    return launches


def _cli_stand_ins(model: str, batch: int):
    """The train CLI's caption segments and a frame a segment: seeded
    stand-ins for the metadata table and the decoder (the card's machine
    has none)."""
    from wise_tpu_torch.cli import train as cli

    captions = _captions(500, 2 * batch)
    frames = _frames(500, len(captions),
                     cli.training_clip_config(model).image_size)
    segments = [(f"clip{i}.mp4", float(i), c) for i, c in enumerate(captions)]
    return segments, frames


@contextlib.contextmanager
def _stand_ins(model: str, batch: int):
    """pipeline/train_data.py reads the stand-ins while the block runs,
    which gets (segments, frames)."""
    from wise_tpu_torch.pipeline import train_data

    segments, frames = _cli_stand_ins(model, batch)
    real = train_data.load_caption_segments, train_data.sample_frame
    train_data.load_caption_segments = lambda *a: segments
    train_data.sample_frame = lambda path, t, size: frames[int(t)]
    try:
        yield segments, frames
    finally:
        train_data.load_caption_segments, train_data.sample_frame = real


def _train_cli(torch, card, model: str = XLMR_MODEL, steps: int = 3,
               batch: int = 32, dp: int = 1, out=None):
    """The train CLI on the card (``python -m wise_tpu_torch.cli.train
    --model <model> --dp <dp>`` through its ``main``): its captions'
    segments and their frames come from seeded stand-ins (_stand_ins),
    everything else is the CLI's own: the training config, the tokenizer,
    CLIPTrainer, the checkpoint; with ``dp`` > 1 the ranks it spawns
    (each installs the stand-ins, _recorded_cli_rank). Every step is
    recorded (_recording), and must launch exactly ``_step_launches`` (in
    every rank); then the port's extractor loads the checkpoint (every
    tensor the checkpoint's f32 master cast to the serving dtype) and
    serves finite unit embeddings, the text embeddings of the queries away
    from the seed-0 weights'. Returns the CLI's launches by (wrapper, SP,
    D) in this process. With ``dp`` > 1 the ranks also take the first step
    with the planted gather, and hold both first steps' gradients to those
    in the file ``out["ref"]``; ``out`` gains the ranks' records
    (``ranks``). One card's run of DP_STEPS steps is kept as [mp]'s
    single-card reference (_REFS)."""
    import gc

    import numpy as np

    from wise_tpu_torch.cli import train as cli
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.parallel.train import STATE_FILE

    cfg = cli.training_clip_config(model)
    want = {k: steps * v for k, v in _step_launches(cfg).items()}
    # the steps' record: a run of one card of DP_STEPS steps is [mp]'s
    # single-card reference (_single_ref), which then need not run again
    rec_dir = tempfile.TemporaryDirectory(prefix="wise_smoke_ref_")
    spec = dict(want=_step_launches(cfg), out=rec_dir.name)
    if dp > 1:
        spec.update(plant="gather", ref=out["ref"])
    elif steps == DP_STEPS:
        spec.update(save=str(Path(rec_dir.name) / "grads.pt"))
    real_rank = cli._rank_main
    cli._rank_main = _recorded_cli_rank
    try:
        with tempfile.TemporaryDirectory(prefix="wise_smoke_cli_") as tmp, \
                _stand_ins(model, batch) as (_, frames), \
                _env(**{RECORD_ENV: json.dumps(spec)}), \
                _recording(torch, spec):
            (Path(tmp) / "proj").mkdir()
            ckpt = Path(tmp) / "ckpt" / model / "finetuned"
            _reset_launches()
            t0 = time.time()
            rc = cli.main(["--project-dir", str(Path(tmp) / "proj"),
                           "--metadata-id", "S/smoke/train",
                           "--caption-column", "caption", "--model", model,
                           "--steps", str(steps), "--batch-size", str(batch),
                           "--learning-rate", str(DP_LR), "--dp", str(dp),
                           "--checkpoint-dir", str(ckpt)])
            cli_s = time.time() - t0
            got, by_shape = _launches_by_name(), dict(_block_launches())
            ranks = [got]
            if dp > 1 and rc == 0:
                out["ranks"] = [json.loads((Path(rec_dir.name) /
                                            f"rank{r}.json").read_text())
                                for r in range(dp)]
                ranks = [r["launches"] for r in out["ranks"]]
            gc.collect()
            torch.cuda.empty_cache()
            steps_ckpt = sorted(p.name for p in ckpt.glob("step_*"))
            if rc != 0 or any(r != want for r in ranks) or steps_ckpt != [
                    f"step_{steps:08d}"]:
                raise PhaseError(f"train: the {model} train CLI at --dp {dp} "
                                 f"returned {rc}, wrote {steps_ckpt} and "
                                 f"launched {ranks}, expected {want} a rank")
            state = ckpt / f"step_{steps:08d}" / STATE_FILE
            ckpt_gb = state.stat().st_size / 1e9
            os.environ["WISE_CHECKPOINT_DIR"] = str(Path(tmp) / "ckpt")
            try:
                served = OpenClipExtractor(
                    f"mlfoundations/open_clip/{model}/finetuned")
            finally:
                del os.environ["WISE_CHECKPOINT_DIR"]
            params = torch.load(state, map_location="cpu", mmap=True,
                                weights_only=True)["params"]
            served_state = served.model.state_dict()
            differ = [k for k, v in params.items()
                      if not torch.equal(served_state[k].cpu(),
                                         v.to(served_state[k].dtype))]
            del params, served_state
            text = served.extract_text_features(QUERIES)
            images = served.extract_image_features(frames[:batch])
            del served
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        cli._rank_main = real_rank
    if spec.get("save"):
        _REFS[(model, batch, False)] = (
            json.loads((Path(rec_dir.name) / "rank0.json").read_text()),
            Path(spec["save"]), rec_dir)
    else:
        rec_dir.cleanup()
    seed0 = OpenClipExtractor(f"mlfoundations/open_clip/{model}/none")
    moved = float(np.abs(text - seed0.extract_text_features(QUERIES)).max())
    del seed0
    gc.collect()
    torch.cuda.empty_cache()
    finite = bool(np.isfinite(text).all() and np.isfinite(images).all())
    norm_err = float(np.abs(np.linalg.norm(
        np.concatenate([text, images]), axis=1) - 1).max())
    say("multi" if dp > 1 else "train", card=repr(card), check="train_cli",
        model=model, dp=dp, steps=steps, batch=batch, rc=rc,
        cli_s=f"{cli_s:.1f}",
        checkpoint_gb=f"{ckpt_gb:.3f}",
        launches=json.dumps(ranks[0], separators=(",", ":")),
        served_tensors_differing=len(differ),
        text_max_abs_diff_vs_seed0=f"{moved:.4f}", moved_bar="> 1e-3",
        max_unit_norm_err=f"{norm_err:.2e}", norm_bar=1e-3)
    if differ or not finite or moved <= 1e-3 or norm_err > 1e-3:
        raise PhaseError(f"train: the extractor's {model} differs from the "
                         f"CLI's checkpoint in {differ[:5]}, or its "
                         f"embeddings (finite {finite}, norm error "
                         f"{norm_err}, moved {moved}) are off")
    return {k: v for k, v in by_shape.items() if v}


def phase_train(torch, card, model: str = "ViT-B-32", batch: int = 256,
                wide: str = "ViT-L-14", wide_batch: int = 32,
                default_batch: int = 32):
    """CLIP fine-tuning on the card through CLIPTrainer (see the module
    docstring, phase 10); returns the launch counts of the kernel path's
    steps, keyed by (wrapper, SP, D)."""
    import dataclasses

    from wise_tpu_torch.cli.train import training_clip_config
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.parallel.train import CLIPTrainer

    launches = {}
    cfg = training_clip_config(model, "bfloat16")
    if not (cfg.fused_block and cfg.pool_last_block):
        raise PhaseError("train: the training config has the kernels off")
    plain_cfg = dataclasses.replace(cfg, fused_block=False,
                                    pool_last_block=False,
                                    fused_attention=False)
    batches = [_train_batch(torch, cfg, 200 + i, batch) for i in range(3)]
    torch.cuda.reset_peak_memory_stats()

    # three steps at the train CLI's learning rate and clip (1e-5, 1.0; no
    # schedule, whose warm-up would make the first step's rate 0) on the
    # kernel path and on the plain twin, from one master tree
    kw = dict(learning_rate=1e-5, grad_clip=1.0)
    kernel = CLIPTrainer(cfg, **kw).init(seed=0)
    plain = CLIPTrainer(plain_cfg, **kw).init(
        params={k: v.clone() for k, v in kernel.params.items()})
    if any(p.dtype != torch.float32 for p in kernel.model.parameters()):
        raise PhaseError("train: a master weight is not f32")

    def grads(trainer):
        trainer.optimizer.zero_grad()
        trainer.loss(*batches[0]).backward()
        return {k: p.grad.clone() for k, p in trainer.model.named_parameters()}

    _reset_launches()
    gk = grads(kernel)
    first_counts = dict(_block_launches())
    gp = grads(plain)
    if _block_launches() != first_counts:
        raise PhaseError("train: the plain twin launched kernels")
    _check_first_grads(card, model, batch, gk, gp)
    del gk, gp

    key = "visual.transformer.resblocks.0.mlp_fc.kernel"
    before = kernel.params[key].clone()
    # ViT-B/32: 22 fused_attn_block_res, 22 fused_mlp_block_res, 1 + 1 pooled
    want = _step_launches(cfg)
    losses = {"kernels": [], "plain": []}
    for i, b in enumerate(batches):
        loss, by_name, by_shape = _counted_step(kernel, *b)
        if by_name != want:
            raise PhaseError(f"train: a {model} step launched {by_name}, "
                             f"expected exactly {want}")
        _add_counts(launches, by_shape)
        losses["kernels"].append(loss)
        loss, by_name, _ = _counted_step(plain, *b)
        if by_name:
            raise PhaseError(f"train: the plain twin launched {by_name}")
        losses["plain"].append(loss)
        if i == 0:
            # the check that would catch bf16-only parameters: one step at
            # lr 1e-5 moves the f32 master by less than a bf16 ulp
            after = kernel.params[key]
            big = before.abs() > 0.01  # bf16 ulp there >= 2^-14 ~ 6.1e-5
            delta = (after - before).abs()[big]
            moved = float((delta > 0).float().mean())
            flipped = float((after.bfloat16() != before.bfloat16())[big]
                            .float().mean())
            say("train", card=repr(card), check="master_weights", key=key,
                weights=int(big.sum()), max_step=f"{float(delta.max()):.3g}",
                bf16_ulp_min=f"{2.0 ** -14:.3g}", share_moved=f"{moved:.4f}",
                share_bf16_cast_changed=f"{flipped:.4f}")
            if not (0 < float(delta.max()) < 2.0 ** -14 and moved > 0.9
                    and flipped < 0.25):
                raise PhaseError("train: the master weights did not take a "
                                 "sub-ulp update")
    gap = max(abs(a - b) for a, b in zip(losses["kernels"], losses["plain"]))
    say("train", card=repr(card), check="losses",
        kernels=",".join(f"{v:.5f}" for v in losses["kernels"]),
        plain=",".join(f"{v:.5f}" for v in losses["plain"]),
        max_gap=f"{gap:.5f}", bar=0.05,
        launches_per_step=json.dumps(want, separators=(",", ":")))
    if not (gap <= 0.05 and all(math.isfinite(v) for v in
                                losses["kernels"] + losses["plain"])):
        raise PhaseError(f"train: losses differ step by step: {losses}")

    for name, trainer in (("kernels", kernel), ("plain", plain), ("plain",
                          plain), ("kernels", kernel)):
        say("train", card=repr(card), model=model, batch=batch,
            path=name, **_step_ms(torch, trainer, *batches[1]))
    say("train", card=repr(card), model=model, batch=batch,
        peak_device_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del plain
    torch.cuda.empty_cache()

    # one batch repeated: the loss must fall, and below ln(batch), where a
    # model that collapsed to uniform logits would stop. From random weights
    # a higher rate does just that (1e-4 and 3e-5 overshoot on the first
    # step and settle at ln 256 within 24 steps on an NVIDIA H100 80GB
    # HBM3; 1e-5 reaches 5.44 there and goes on falling)
    tuned = CLIPTrainer(cfg, **kw).init(seed=0)
    seen = []
    for _ in range(30):
        loss, _, by_shape = _counted_step(tuned, *batches[2])
        _add_counts(launches, by_shape)
        seen.append(loss)
    say("train", card=repr(card), check="loss_falls", lr=kw["learning_rate"],
        steps=len(seen), losses=",".join(f"{v:.4f}" for v in seen),
        ln_batch=f"{math.log(batch):.4f}",
        bar="last < first - 0.05 and last < ln(batch)")
    if not (all(math.isfinite(v) for v in seen) and seen[-1] < seen[0] - 0.05
            and seen[-1] < math.log(batch)):
        raise PhaseError(f"train: the loss did not fall: {seen}")

    # the extractor serves the checkpoint; then restore into a fresh trainer,
    # the next step's loss equal
    frames = _frames(7, 64, cfg.image_size)
    seeded = torch.from_numpy(OpenClipExtractor(
        f"mlfoundations/open_clip/{model}/none").extract_image_features(
            frames))
    with tempfile.TemporaryDirectory(prefix="wise_smoke_train_") as tmp:
        ckpt_dir = Path(tmp) / model / "finetuned"
        tuned.save_checkpoint(ckpt_dir, len(seen))
        os.environ["WISE_CHECKPOINT_DIR"] = tmp
        try:
            served = OpenClipExtractor(
                f"mlfoundations/open_clip/{model}/finetuned")
        finally:
            del os.environ["WISE_CHECKPOINT_DIR"]
        got = torch.from_numpy(served.extract_image_features(frames))
        # the same frames through the trainer's own model: its f32 masters
        # cast at use are the weights the extractor cast at load
        with torch.inference_mode():
            x = served.preprocess_frames(
                torch.from_numpy(frames).cuda(), cfg.image_size)
            want = tuned.model.encode_image(x.float()).cpu()
        fresh = CLIPTrainer(cfg, **kw).init(seed=1)
        step = fresh.restore_checkpoint(ckpt_dir)
        a = float(tuned.train_step(*batches[0]))
        b = float(fresh.train_step(*batches[0]))
    say("train", card=repr(card), check="checkpoint", restored_step=step,
        next_loss=f"{a:.6f}", next_loss_restored=f"{b:.6f}", bar=1e-6)
    if step != len(seen) or not abs(a - b) <= 1e-6:
        raise PhaseError(f"train: restored step {step}, next loss {a} vs {b}")
    moved = float((got - seeded).abs().max())
    off = float((got - want).abs().max())
    say("train", card=repr(card), check="extractor_serves_checkpoint",
        frames=len(frames), max_abs_diff_vs_seed0=f"{moved:.4f}",
        moved_bar="> 1e-3", max_abs_diff_vs_trainer=f"{off:.6f}",
        same_bar="<= 1e-3")
    if not (bool(got.isfinite().all()) and moved > 1e-3 and off <= 1e-3
            and float((got.norm(dim=1) - 1).abs().max()) < 1e-3):
        raise PhaseError(f"train: the served checkpoint's embeddings moved "
                         f"{moved} from the seed-0 weights' and are {off} "
                         f"from the trainer's own")
    del fresh
    del tuned, served, kernel
    torch.cuda.empty_cache()

    # ViT-L/14 at batch 32: the width that takes fused_mlp_split_res
    cfg_l = training_clip_config(wide, "bfloat16")
    big = CLIPTrainer(cfg_l, learning_rate=1e-5, grad_clip=1.0).init(seed=0)
    batch_l = _train_batch(torch, cfg_l, 300, wide_batch)
    # ViT-L/14: 34 fused_attn_block_res (23 vision, 11 text), 23
    # fused_mlp_fc_res and fused_mlp_proj (vision, width 1024), 11
    # fused_mlp_block_res (text, width 768), 1 + 1 pooled
    want = _step_launches(cfg_l)
    seen = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        loss, by_name, by_shape = _counted_step(big, *batch_l)
        if by_name != want:
            raise PhaseError(f"train: a {wide} step launched {by_name}, "
                             f"expected exactly {want}")
        _add_counts(launches, by_shape)
        seen.append(loss)
    if not all(math.isfinite(v) for v in seen):
        raise PhaseError(f"train: {wide} losses {seen}")
    say("train", card=repr(card), model=wide, batch=wide_batch,
        losses=",".join(f"{v:.4f}" for v in seen),
        launches_per_step=json.dumps(want, separators=(",", ":")),
        **_step_ms(torch, big, *batch_l, steps=3),
        peak_device_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    del big
    torch.cuda.empty_cache()

    # the default backbone at full width: ViT-H/14 (257 tokens, head_dim
    # 80) and XLM-R large (post-LN, 64 tokens), at XLMR_TRAIN_DEPTH
    with _default_backbone_cut():
        cfg_h = training_clip_config(XLMR_MODEL, "bfloat16")
        if not (cfg_h.fused_block and cfg_h.text_tower == "hf_xlm_roberta"):
            raise PhaseError("train: the default backbone's config is off "
                             "the kernels")
        _add_counts(launches, _train_against_twin(
            torch, card, XLMR_MODEL, cfg_h, dataclasses.replace(
                cfg_h, fused_block=False, pool_last_block=False,
                fused_attention=False), default_batch, 400))
    # WISE_FUSED_BLOCK=0: the attention middle is the one kernel
    os.environ["WISE_FUSED_BLOCK"] = "0"
    try:
        cfg_a = training_clip_config(model, "bfloat16")
    finally:
        del os.environ["WISE_FUSED_BLOCK"]
    if cfg_a.fused_block or not cfg_a.fused_attention:
        raise PhaseError("train: WISE_FUSED_BLOCK=0 left no attention "
                         "middle on")
    _add_counts(launches, _train_against_twin(
        torch, card, f"{model}[WISE_FUSED_BLOCK=0]", cfg_a,
        dataclasses.replace(cfg_a, fused_attention=False), batch, 500))
    # [mp] holds its default-backbone leg to this run
    with _default_backbone_cut():
        _add_counts(launches, _train_cli(torch, card, batch=default_batch))
    return launches


def _segments(torch, n: int, seed: int, chunk: int = 128):
    """n seeded synthetic 4 s segments at 48 kHz, (n, 192000) float32 on
    the host, made on the card: three tones of log-uniform pitch (80 Hz to
    8 kHz), random level and phase, under a slow amplitude envelope, plus
    noise."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(192_000, device="cuda") / 48_000.0
    out = []
    for i in range(0, n, chunk):
        m = min(chunk, n - i)

        def r(*shape):
            return torch.rand(*shape, 1, generator=g, device="cuda")

        tones = (0.05 + 0.25 * r(m, 3)) * torch.sin(
            2 * math.pi * (80.0 * 100.0 ** r(m, 3) * t + r(m, 3)))
        env = 0.6 + 0.4 * torch.sin(2 * math.pi * (0.25 + 2 * r(m)) * t)
        sig = tones.sum(1) * env + 0.02 * torch.randn(
            m, t.numel(), generator=g, device="cuda")
        out.append(sig.float().cpu().numpy())
    return np.concatenate(out)


def _window_attention_run(torch, extractor, x):
    """One batch through the HTSAT path of WISE_FUSED_SWIN_BLOCK=0 (f32
    stream blocks around the window-attention kernel) on the extractor's
    weights: (launches by (wrapper, L, C), min embedding cosine against the
    extractor's block-kernel path)."""
    from wise_tpu_torch.models.clap.config import production_clap_config
    from wise_tpu_torch.models.clap.model import CLAP
    from wise_tpu_torch.ops import swin_attention as SA

    os.environ["WISE_FUSED_SWIN_BLOCK"] = "0"
    try:
        cfg = production_clap_config(extractor.version)
    finally:
        del os.environ["WISE_FUSED_SWIN_BLOCK"]
    with torch.device(extractor.device):
        model = CLAP(cfg)
    model.load_state_dict(extractor.model.state_dict())
    model.to(extractor.device).eval()
    with torch.inference_mode():
        mel = extractor.log_mel(x)
        want = extractor.model.encode_audio(mel)
        SA.reset_launches()
        got = model.encode_audio(mel)
        torch.cuda.synchronize()
        launches = dict(SA.LAUNCHES_BY_SHAPE)
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    return launches, cos.min().item()


def phase_audio(torch, card, k=10):
    """Audio ingest -> IndexFlatIP -> REST ``search_in=audio`` on the port's
    CLAP; returns the launch counts of the paths' runs, keyed by (wrapper,
    L, C) and (wrapper, SP, D)."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.clap.model import SwinBlock
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import swin_attention as SA
    from wise_tpu_torch.ops import swin_block as SB

    #: the environment of the fully plain path: with WISE_FUSED_BLOCK=0 alone
    #: a CLIP tower's attention middle would still be a kernel
    plain_env = {"WISE_FUSED_BLOCK": "0", "WISE_FUSED_ATTN": "0"}
    segs = _segments(torch, SEGMENTS, seed=7)
    clips = [segs[i:i + 16] for i in range(0, SEGMENTS, 16)]  # 64 s files
    with tempfile.TemporaryDirectory(prefix="wise_smoke_audio_") as tmp:
        project_dir = Path(tmp) / "proj"
        extractor = ClapExtractor(AUDIO_ID)
        c = extractor.config
        # (L, C, masked) of every HTSAT block: each stage, and its shifted
        # blocks apart (stage 3's one window never shifts)
        swin_keys = sorted({(blk.window ** 2, blk.norm1.scale.shape[0],
                             blk.shift > 0)
                            for blk in extractor.model.audio_encoder.modules()
                            if isinstance(blk, SwinBlock)})
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_audio_features(segs[:32])
            extractor.extract_text_features(["warm up"])

        K.reset_launches()
        SB.reset_launches()
        n, ingest_s = _ingest(project_dir, extractor, AUDIO_ID, clips,
                              audio=True)
        if n != SEGMENTS:
            raise PhaseError(f"embedded {n} of {SEGMENTS} segments")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        served, lat = _serve_queries(project_dir, config, AUDIO_QUERIES, k,
                                     media="audio")
        launches = {**K.LAUNCHES_BY_SHAPE, **SB.LAUNCHES_BY_SHAPE}
        # the kernels under the block calls, as the C entry counted them
        # where it launched each: two a block up to C 384, the
        # seven-launch chain wider (stage 3)
        kernels = dict(SA.KERNEL_LAUNCHES_BY_SHAPE)
        off = []
        for key in swin_keys:
            want = SWIN_BLOCK_KERNELS[key[1] <= 384]
            blocks = launches.get(("fused_swin_block", *key), 0)
            got = {k: kernels.get((k, *key), 0) for k in SA.KERNELS}
            if got != {k: want.get(k, 0) * blocks for k in SA.KERNELS}:
                off.append((key, blocks, got))
        if off:
            raise PhaseError(f"Swin kernels off their route's count: {off}")
        launches.update(kernels)
        path = [("fused_swin_block", *key) for key in swin_keys] + [
            (name, c.context_length, c.text_width)
            for name in ("fused_attn_block", "fused_mlp_block",
                         "fused_attn_block_pooled_dyn")]
        idle = [key for key in path if not launches.get(key)]
        if idle:
            raise PhaseError(f"not launched on the audio path: {idle}")

        # the same segments and queries through the plain PyTorch path
        os.environ.update(plain_env)
        try:
            plain = ClapExtractor(AUDIO_ID)
        finally:
            for name in plain_env:
                del os.environ[name]
        ids = _vector_ids(project_dir)
        vecs = np.concatenate([plain.extract_audio_features(segs[i:i + 64])
                               for i in range(0, SEGMENTS, 64)])
        prefix = config.search.audio_query_prefix
        gap = 0.0
        for q in AUDIO_QUERIES:
            qv = plain.extract_text_features([f"{prefix} {q}".strip()])[0]
            gap = max(gap, _check_against_plain(*served[q], vecs @ qv, ids,
                                                k, 1e-3))

        batch = torch.from_numpy(segs[:64]).to(extractor.device)
        window, cos = _window_attention_run(torch, extractor, batch)
        missing = [key for key in swin_keys
                   if not window.get(("fused_window_attention", *key))]
        if missing or cos < 0.999:
            raise PhaseError(
                f"WISE_FUSED_SWIN_BLOCK=0: window attention idle at (L, C, "
                f"masked) {missing}, or embeddings off the block path (min cos "
                f"{cos:.6f} < 0.999)")
        launches.update(window)
        rates = {name: _audio_rates(torch, fe, segs[:64])
                 for name, fe in (("kernels", extractor), ("plain", plain))}

    say("slice", card=repr(card), media="audio", segments=n,
        ingest_s=f"{ingest_s:.3f}", segments_per_s=f"{n / ingest_s:.1f}",
        requests=len(lat) + 1 + len(AUDIO_QUERIES),
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
        launches=json.dumps({_launch_name(key): v for key, v
                             in sorted(launches.items())},
                            separators=(",", ":")),
        vs_plain="ok", served_gap_max=f"{gap:.6f}")
    say("slice", card=repr(card), media="audio",
        path="WISE_FUSED_SWIN_BLOCK=0", batch=len(batch),
        window_attention_launches=json.dumps(
            {_launch_name(key): v for key, v in sorted(window.items())},
            separators=(",", ":")),
        min_cos_vs_block_path=f"{cos:.6f}")
    for name, (sps, ms) in rates.items():
        say("slice", card=repr(card), media="audio", path=name,
            batch=len(batch), extractor_segments_per_s=f"{sps:.1f}",
            device_ms_per_batch=f"{ms:.3f}",
            device_segments_per_s=f"{1e3 * len(batch) / ms:.1f}")
    return launches


@contextlib.contextmanager
def _default_backbone_cut():
    """The registry's default backbone at XLMR_TRAIN_DEPTH while the block
    runs, for every caller that looks it up (the CLI, the trainers, the
    extractor), and in the CLI's ranks (TRAIN_DEPTH_ENV)."""
    import dataclasses

    from wise_tpu_torch.models.clip import config as C

    whole = C.CLIP_CONFIGS[XLMR_MODEL]
    C.CLIP_CONFIGS[XLMR_MODEL] = dataclasses.replace(whole,
                                                     **XLMR_TRAIN_DEPTH)
    try:
        with _env(**{TRAIN_DEPTH_ENV: "1"}):
            yield
    finally:
        C.CLIP_CONFIGS[XLMR_MODEL] = whole


@contextlib.contextmanager
def _env(**values):
    """The environment with ``values`` set while the block runs, restored
    after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _every_launch():
    """Every launch counter of the port's CUDA kernels by (wrapper, shape):
    the block, post-LN, attention, top-k and embed wrappers', and the Swin
    wrappers' and kernels'."""
    from wise_tpu_torch.ops import swin_attention as SA
    from wise_tpu_torch.ops import swin_block as SB

    counts = _block_launches()
    counts.update(SB.LAUNCHES_BY_SHAPE)
    counts.update(SA.LAUNCHES_BY_SHAPE)
    counts.update(SA.KERNEL_LAUNCHES_BY_SHAPE)
    return {k: v for k, v in counts.items() if v}


def _reset_every_launch():
    from wise_tpu_torch.ops import swin_attention as SA
    from wise_tpu_torch.ops import swin_block as SB

    _reset_launches()
    SB.reset_launches()
    SA.reset_launches()


def _split_ms(torch, extractor, x, reps: int = 5):
    """Device ms of a batch's log-mel, audio tower and projection (with the
    normalisation), each alone (CUDA events)."""
    model = extractor.model
    with torch.inference_mode():
        mel = extractor.log_mel(x)
        feats = model.audio_encoder(mel)
        return {
            "log_mel": _cuda_ms(torch, lambda: extractor.log_mel(x), reps),
            "cnn14": _cuda_ms(torch, lambda: model.audio_encoder(mel), reps),
            "projection": _cuda_ms(
                torch, lambda: model.audio_projection(feats), reps)}


def phase_clap2022(torch, card, k=10):
    """msclap 2022 at full width and depth (CNN14 to 2,048 channels,
    BERT-base 12 x 768 over 100 tokens; seeded weights, the hash tokenizer):
    SEGMENTS 4 s segments at 48 kHz through the pipeline's batches of 32,
    IndexFlatIP, REST ``search_in=audio``. Checks: the served top-10 of
    each query against a direct run of the extractor (swaps only within
    1e-3); finite unit embeddings that are not collapsed (the mean
    off-diagonal cosine is printed); a 64-segment batch under
    WISE_CLAP_DTYPE=float32 against the bf16 path (min cosine >= 0.99); a
    caption's embedding unchanged by its padding. Both towers are plain
    PyTorch: the ingest may launch no kernel of csrc/, the served queries
    only the flat index's top-k kernels."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.clap.model import (BertCaptionEncoder,
                                                  Cnn14Encoder)

    segs = _segments(torch, SEGMENTS, seed=8)
    clips = [segs[i:i + 16] for i in range(0, SEGMENTS, 16)]  # 64 s files
    with tempfile.TemporaryDirectory(prefix="wise_smoke_clap2022_") as tmp:
        project_dir = Path(tmp) / "proj"
        extractor = ClapExtractor(CLAP2022_ID)
        c, model = extractor.config, extractor.model
        if not (isinstance(model.audio_encoder, Cnn14Encoder)
                and isinstance(model.caption_encoder, BertCaptionEncoder)
                and c.cnn14_channels[-1] == 2048 and c.text_layers == 12
                and c.text_width == 768 and c.context_length == 100):
            raise PhaseError(f"clap2022: {CLAP2022_ID} is not CNN14 + "
                             f"BERT-base at full width: {c}")
        with torch.inference_mode():  # first use: cuDNN, cuBLAS
            extractor.extract_audio_features(segs[:32])
            extractor.extract_text_features(["warm up"])
        _reset_every_launch()
        torch.cuda.reset_peak_memory_stats()
        n, ingest_s = _ingest(project_dir, extractor, CLAP2022_ID, clips,
                              audio=True)
        ingest_peak = torch.cuda.max_memory_allocated()
        ingest_launches = _every_launch()
        if n != SEGMENTS or ingest_launches:
            raise PhaseError(f"clap2022: embedded {n} of {SEGMENTS} "
                             f"segments, launching {ingest_launches}")
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        config = project.WiseProject(project_dir).load_config()
        served, lat = _serve_queries(project_dir, config, AUDIO_QUERIES, k,
                                     media="audio")
        serve_launches = _every_launch()
        towers = [key for key in serve_launches
                  if not key[0].startswith("fused_topk")]
        if towers:
            raise PhaseError(f"clap2022: the caption tower launched "
                             f"{towers}")

        # the direct run: the same extractor on the same segments, 64 at a
        # time, and on the same queries
        ids = _vector_ids(project_dir)
        vecs = np.concatenate([extractor.extract_audio_features(
            segs[i:i + 64]) for i in range(0, SEGMENTS, 64)])
        prefix = config.search.audio_query_prefix
        texts = [f"{prefix} {q}".strip() for q in AUDIO_QUERIES]
        text = extractor.extract_text_features(texts)
        gap = max(_check_against_plain(*served[q], vecs @ text[i], ids, k,
                                       1e-3)
                  for i, q in enumerate(AUDIO_QUERIES))
        both = np.concatenate([vecs, text])
        norm_err = float(np.abs(np.linalg.norm(both, axis=1) - 1).max())
        gram = vecs @ vecs.T
        off = float((gram.sum() - np.trace(gram)) / (n * (n - 1)))
        tgram = text @ text.T
        text_off = float((tgram.sum() - np.trace(tgram))
                         / (len(text) * (len(text) - 1)))
        if (not np.isfinite(both).all() or norm_err > 1e-3 or off > 0.999
                or text_off > 0.999):
            raise PhaseError(
                f"clap2022: embeddings not finite unit vectors (norm error "
                f"{norm_err}) or collapsed (mean off-diagonal cosine audio "
                f"{off}, text {text_off})")

        # WISE_CLAP_DTYPE=float32: the same seeded weights in f32
        with _env(WISE_CLAP_DTYPE="float32"):
            f32 = ClapExtractor(CLAP2022_ID)
        ref = f32.extract_audio_features(segs[:64])
        cos_f32 = float((ref * vecs[:64]).sum(1).min())
        ref_text = f32.extract_text_features(texts)
        cos_f32_text = float((ref_text * text).sum(1).min())
        batch = torch.from_numpy(segs[:64]).to(extractor.device)
        f32_ms = _split_ms(torch, f32, batch)
        del f32
        torch.cuda.empty_cache()
        if min(cos_f32, cos_f32_text) < 0.99:
            raise PhaseError(f"clap2022: bf16 against float32 min cosine "
                             f"audio {cos_f32}, text {cos_f32_text} < 0.99")

        # padding: the same caption padded to its length + 2 and to 100,
        # and with other ids in its pad rows
        tokens = extractor.tokenizer(texts[:1])
        length = int((tokens != 0).sum())
        t = torch.from_numpy(tokens.astype(np.int64)).to(extractor.device)
        junk = t.clone()
        junk[:, length:] = 4321
        ln = torch.tensor([length], device=extractor.device)
        with torch.inference_mode():
            full = model.encode_text(t, ln)
            short = model.encode_text(t[:, :length + 2], ln)
            other = model.encode_text(junk, ln)
        pad_exact = bool(torch.equal(full, other))
        pad_cos = float(torch.nn.functional.cosine_similarity(
            full, short).min())
        if not pad_exact or pad_cos < 0.9999:
            raise PhaseError(f"clap2022: a caption's embedding moved with "
                             f"its padding (ids in the pad rows: equal "
                             f"{pad_exact}; length {length + 2} against 100: "
                             f"cosine {pad_cos})")

        rates = _audio_rates(torch, extractor, segs[:64])
        split = _split_ms(torch, extractor, batch)
        enc = extractor.tokenizer(texts)
        tt = torch.from_numpy(np.concatenate([enc, enc]).astype(
            np.int64)).to(extractor.device)  # the text bucket of 16
        tl = (tt != 0).sum(1)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            text_ms = _cuda_ms(torch, lambda: model.encode_text(tt, tl), 10)
        text_peak = torch.cuda.max_memory_allocated()
        # where the time goes, by CUDA kernel (torch.profiler)
        audio_kernels = _device_kernels(
            torch, lambda: model.encode_audio(extractor.log_mel(batch)))
        text_kernels = _device_kernels(torch,
                                       lambda: model.encode_text(tt, tl))

    say("clap2022", card=repr(card), model=CLAP2022_ID, segments=n,
        ingest_s=f"{ingest_s:.3f}", segments_per_s=f"{n / ingest_s:.1f}",
        ingest_peak_gb=f"{ingest_peak / 1e9:.3f}",
        requests=len(lat) + 1 + len(AUDIO_QUERIES),
        query_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
        vs_direct="ok", served_gap_max=f"{gap:.6f}",
        ingest_launches=0, serve_launches=json.dumps(
            {_launch_name(key): v for key, v in sorted(
                serve_launches.items())}, separators=(",", ":")))
    say("clap2022", card=repr(card), check="embeddings",
        max_unit_norm_err=f"{norm_err:.2e}",
        audio_mean_offdiag_cos=f"{off:.6f}",
        text_mean_offdiag_cos=f"{text_off:.6f}", collapse_bar="< 0.999",
        f32_vs_bf16_min_cos_audio=f"{cos_f32:.6f}",
        f32_vs_bf16_min_cos_text=f"{cos_f32_text:.6f}", cos_bar=">= 0.99",
        pad_rows_other_ids="equal", pad_len=length + 2,
        pad_len_vs_100_min_cos=f"{pad_cos:.7f}")
    sps, ms = rates
    say("clap2022", card=repr(card), batch=len(batch), dtype="bfloat16",
        extractor_segments_per_s=f"{sps:.1f}",
        device_ms_per_batch=f"{ms:.3f}",
        **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()})
    say("clap2022", card=repr(card), batch=len(batch), dtype="float32",
        **{f"{k}_ms": f"{v:.3f}" for k, v in f32_ms.items()})
    say("clap2022", card=repr(card), text_batch=len(tt), queries=len(enc),
        context=tt.shape[1], text_embed_ms=f"{text_ms:.3f}",
        text_peak_gb=f"{text_peak / 1e9:.3f}")
    _say_kernels(audio_kernels, top=10, path="clap2022_audio_batch")
    _say_kernels(text_kernels, top=10, path="clap2022_text_embed")


def _shot_video(torch, seed: int):
    """SHOT_FRAMES seeded 720 x 1280 frames with SHOT_CUTS cuts: each shot a
    coarse random 9 x 16 colour layout at full size, each frame that layout
    plus per-pixel jitter in [-8, 8] and a drift of the shot's brightness;
    made on the card, returned as (frames uint8 on the host, pts at 2 fps,
    the planted spans)."""
    import numpy as np

    h, w = SHOT_SIZE
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(np.arange(5, SHOT_FRAMES - 4, 5),
                                SHOT_CUTS, replace=False))
    bounds = [0, *starts.tolist(), SHOT_FRAMES]
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = np.empty((SHOT_FRAMES, h, w, 3), np.uint8)
    for a, b in zip(bounds[:-1], bounds[1:]):
        cells = torch.randint(0, 256, (1, 3, 9, 16), generator=g,
                              device="cuda").float()
        base = torch.nn.functional.interpolate(cells, size=(h, w))[0]
        base = base.permute(1, 2, 0)
        for i in range(a, b, 16):
            m = min(16, b - i)
            drift = 6.0 * torch.arange(i - a, i - a + m, device="cuda") / (
                b - a)
            jitter = torch.randint(-8, 9, (m, h, w, 3), generator=g,
                                   device="cuda")
            frames[i:i + m] = torch.clamp(
                base + drift[:, None, None, None] + jitter, 0, 255).to(
                    torch.uint8).cpu().numpy()
    pts = np.arange(SHOT_FRAMES, dtype=np.float64) / 2
    spans = [(float(pts[a]), float(pts[b - 1]))
             for a, b in zip(bounds[:-1], bounds[1:])]
    return frames, pts, spans


def phase_shots(torch, card):
    """Shot detection at a real video's size: SHOT_FRAMES frames of 720 x
    1280 (ten minutes at the reference's 2 fps) with SHOT_CUTS seeded cuts.
    ``detect_shots`` on the card must find exactly the planted spans, its
    scores must equal the CPU run of ``frame_change_scores`` within 1e-3 (a
    bin flip moves a score by 3.3e-4); then the detect-shots CLI's ``main``
    on a project whose decoder is a seeded stand-in (the card's machine has
    none) must write exactly those spans to the shots table."""
    import numpy as np
    from wise_tpu_torch import config as wconfig, data_models as dm, db
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import shots as cli
    from wise_tpu_torch.db import repository
    from wise_tpu_torch.io.dataset import MediaChunk
    from wise_tpu_torch.pipeline import shots

    frames, pts, planted = _shot_video(torch, seed=19)
    shots.detect_shots(frames[:64], pts[:64])  # first use
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spans = shots.detect_shots(frames, pts)
    detect_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if spans != planted:
        raise PhaseError(f"shots: found {len(spans)} spans, planted "
                         f"{len(planted)}: {spans[:5]} vs {planted[:5]}")
    on_card = shots.frame_change_scores(frames)
    with _env(WISE_TORCH_DEVICE="cpu"):
        t0 = time.perf_counter()
        on_cpu = shots.frame_change_scores(frames)
        cpu_s = time.perf_counter() - t0
    err = float(np.abs(on_card - on_cpu).max())
    flips = int((np.abs(on_card - on_cpu) > 1e-5).sum())
    if on_card.shape != (SHOT_FRAMES - 1,) or err > 1e-3:
        raise PhaseError(f"shots: card scores {on_card.shape} off the CPU "
                         f"run by {err}")
    ranked = np.sort(on_card)[::-1]
    min_cut, max_other = float(ranked[SHOT_CUTS - 1]), float(ranked[SHOT_CUTS])

    def stand_in(media_type, files, video=None):
        step = video.frames_per_chunk
        return [(files[0], {"video": MediaChunk(tensor=frames[i:i + step],
                                                 pts=pts[i:i + step])})
                for i in range(0, SHOT_FRAMES, step)]

    real = shots.get_dataset
    shots.get_dataset = stand_in
    try:
        with tempfile.TemporaryDirectory(prefix="wise_smoke_shots_") as tmp:
            project_dir = Path(tmp) / "proj"
            proj = project.WiseProject(project_dir, create_project=True)
            proj.save_config(wconfig.WiseConfig())
            conn = db.init_project(proj.db_path)
            sc = repository.SourceCollectionRepo().create(
                conn, dm.SourceCollection(location=str(Path(tmp) / "media"),
                                          type=dm.SourceCollectionType.DIR))
            media = repository.MediaRepo().create(conn, dm.MediaMetadata(
                source_collection_id=sc.id, path="clip000.mp4",
                media_type=dm.MediaType.VIDEO, format="mp4",
                width=SHOT_SIZE[1], height=SHOT_SIZE[0], num_frames=SHOT_FRAMES,
                duration=SHOT_FRAMES / 2))
            conn.commit()
            conn.close()
            t0 = time.perf_counter()
            rc = cli.main(["--project-dir", str(project_dir)])
            cli_s = time.perf_counter() - t0
            conn = db.connect(proj.db_path, readonly=True)
            rows = [(r[0], r[1], r[2]) for r in conn.execute(
                "SELECT media_id, start_time, end_time FROM shots "
                "ORDER BY start_time")]
            conn.close()
    finally:
        shots.get_dataset = real
    if rc != 0 or rows != [(media.id, a, b) for a, b in planted]:
        raise PhaseError(f"shots: the CLI returned {rc} and wrote "
                         f"{len(rows)} rows, planted {len(planted)}")
    say("shots", card=repr(card), frames=SHOT_FRAMES,
        size="x".join(map(str, SHOT_SIZE)), cuts=SHOT_CUTS,
        spans=len(spans), planted="equal",
        detect_s=f"{detect_s:.3f}",
        frames_per_s=f"{SHOT_FRAMES / detect_s:.1f}",
        peak_gb=f"{peak / 1e9:.3f}", chunk=shots.CHUNK,
        cpu_scores_s=f"{cpu_s:.3f}", max_abs_vs_cpu=f"{err:.2e}",
        bin_flips=flips, min_cut_score=f"{min_cut:.4f}",
        max_other_score=f"{max_other:.4f}")
    say("shots", card=repr(card), check="cli", rc=rc, rows=len(rows),
        planted="equal", cli_s=f"{cli_s:.3f}",
        cli_frames_per_s=f"{SHOT_FRAMES / cli_s:.1f}",
        frames_per_chunk=wconfig.WiseConfig().video.frames_per_chunk)


#: vectors per synthetic clip of the index phase (a 34-minute video at 2 fps)
INDEX_CLIP = 4096
#: frames of the one clip the index phase embeds with the real tower
INDEX_REAL = 256


def _synthetic_clip(torch, seed: int, n: int):
    """n seeded unit vectors of one synthetic clip, made on the card: a
    clip centre (a random unit vector) plus per-frame noise of the same
    norm, normalised; frames of a clip resemble each other (cosine about
    0.5), as a video's do."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    centre = torch.randn(INDEX_D, generator=g, device="cuda")
    centre /= centre.norm()
    v = centre + torch.randn(n, INDEX_D, generator=g,
                             device="cuda") / math.sqrt(INDEX_D)
    return (v / v.norm(dim=1, keepdim=True)).cpu().numpy()


def _write_index_project(torch, project_dir: Path, real):
    """A WiseProject whose feature store and DB hold INDEX_N vectors: the
    ``real`` embeddings as the frames of one clip, then synthetic clips of
    INDEX_CLIP vectors at 2 fps, one media row each, written through the
    store's ``add`` and the repositories' ``create`` / ``insert_rows`` in
    one transaction. Returns ((N, D) float32 vectors in id order, seconds
    in the store's writes, seconds in the DB's)."""
    import numpy as np
    from wise_tpu_torch import config, data_models as dm, db, project, store
    from wise_tpu_torch.db import repository

    cfg = config.WiseConfig()
    # the .npz shard store (store_type "numpy"): the default tar store took
    # 162 s to write and 232 s to read back at this size on the host of an
    # NVIDIA H100 80GB HBM3 (a third of the script's time limit)
    cfg.store.store_type = "numpy"
    proj = project.WiseProject(project_dir, create_project=True)
    proj.save_config(cfg)
    conn = db.init_project(proj.db_path)
    sc = repository.SourceCollectionRepo().create(conn, dm.SourceCollection(
        location=str(project_dir / "media"),
        type=dm.SourceCollectionType.DIR))
    fstore = store.FeatureStoreFactory.create_store(
        cfg.store.store_type, "video", proj.create_features_dir(MODEL_ID))
    fstore.enable_write(cfg.store.shard_maxcount, cfg.store.shard_maxsize)
    media_repo, vector_repo = repository.MediaRepo(), repository.VectorRepo()
    video = dm.ModalityType.VIDEO
    vecs = np.empty((INDEX_N, INDEX_D), np.float32)
    store_s = db_s = 0.0
    row = clip = 0
    while row < INDEX_N:
        if clip == 0:
            feats = np.asarray(real, np.float32)
        else:
            feats = _synthetic_clip(torch, 1000 + clip,
                                    min(INDEX_CLIP, INDEX_N - row))
        n = len(feats)
        t0 = time.perf_counter()
        media = media_repo.create(conn, dm.MediaMetadata(
            source_collection_id=sc.id, path=f"clip{clip:03d}.mp4",
            media_type=dm.MediaType.VIDEO, format="mp4", width=224,
            height=224, num_frames=n, duration=n / 2))
        # create_batch's rows without a pydantic object and a copy of it a
        # row (insert_rows): 24.9 of a 32.0 s write went to those on an
        # NVIDIA H100 80GB HBM3 host
        base = vector_repo.insert_rows(
            conn, [(video, media.id, i / 2, None) for i in range(n)])
        t1 = time.perf_counter()
        for i, feat in enumerate(feats):
            fstore.add(base + i + 1, feat[None, :])
        store_s += time.perf_counter() - t1
        db_s += t1 - t0
        vecs[row:row + n] = feats
        row += n
        clip += 1
    t0 = time.perf_counter()
    fstore.close()
    store_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    conn.commit()
    conn.close()
    db_s += time.perf_counter() - t0
    return vecs, store_s, db_s, clip


@contextlib.contextmanager
def _search_batches():
    """Counts the vector searches made while the block runs, by every
    FeatureSearchIndex of the process (the server builds its own): the list
    gains the batch's rows for each ``search_batch_dispatch`` or
    ``search_batch`` call. It reads no launch counter, so the counters can
    be held to it."""
    from wise_tpu_torch.index.feature_index import FeatureSearchIndex as FSI

    sizes = []
    saved = {name: getattr(FSI, name)
             for name in ("search_batch_dispatch", "search_batch")}

    def counted(fn):
        def call(self, query_vectors, topk):
            sizes.append(len(query_vectors))
            return fn(self, query_vectors, topk)
        return call

    for name, fn in saved.items():
        setattr(FSI, name, counted(fn))
    try:
        yield sizes
    finally:
        for name, fn in saved.items():
            setattr(FSI, name, fn)


def _p50_ms(fn, calls: int = 20, warm: int = 3) -> float:
    """Median host ms of ``fn()`` (which returns host arrays) over ``calls``
    calls after ``warm``."""
    import numpy as np

    lat = []
    for i in range(warm + calls):
        t0 = time.perf_counter()
        fn()
        lat.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(lat[warm:]))


def _recall(got_ids, want_ids) -> float:
    hits = sum(len(set(g) & set(w))
               for g, w in zip(got_ids.tolist(), want_ids.tolist()))
    return hits / want_ids.size


def phase_index(torch, card, k=10, keep=None):
    """The index and query leg at deployment size (see the module
    docstring, phase 10); returns the top-k wrappers' launch counts over the
    phase, keyed by (wrapper, N_pad, D). With ``keep``, a dict, the project
    is built under ``keep["root"]`` and left there, and ``keep`` gains what
    the multi-device phase holds its own results to (phase_multi)."""
    import numpy as np
    from wise_tpu_torch import project
    from wise_tpu_torch.cli import create_index
    from wise_tpu_torch.config import IndexConfig
    from wise_tpu_torch.index.feature_index import FeatureSearchIndex
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.ops import topk as TK

    thr = ("fused_topk_threshold", INDEX_N, INDEX_D)
    grp = ("fused_topk", INDEX_N, INDEX_D)

    def counts():
        return (FT.LAUNCHES_BY_SHAPE.get(thr, 0),
                FT.LAUNCHES_BY_SHAPE.get(grp, 0))

    frames = _frames(123, INDEX_REAL, 224)
    with (contextlib.nullcontext(keep["root"]) if keep else
          tempfile.TemporaryDirectory(prefix="wise_smoke_index_")) as tmp:
        project_dir = Path(tmp) / "proj"
        extractor = OpenClipExtractor(MODEL_ID)
        with torch.inference_mode():  # first use: cuBLAS, kernel library
            extractor.extract_image_features(frames[:8])
            extractor.extract_text_features(["warm up"])
        real = extractor.extract_image_features(frames)
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()

        t0 = time.perf_counter()
        vecs, store_s, db_s, clips = _write_index_project(
            torch, project_dir, real)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if create_index.main(["--project-dir", str(project_dir)]) != 0:
            raise PhaseError("create-index failed")
        build_s = time.perf_counter() - t0
        say("index", card=repr(card), vectors=INDEX_N, dim=INDEX_D,
            media_rows=clips, write_s=f"{write_s:.1f}",
            store_write_s=f"{store_s:.1f}", db_write_s=f"{db_s:.1f}",
            flat_build_s=f"{build_s:.1f}")

        # REST: the 8 queries x 3 and the burst, k = 10
        config = project.WiseProject(project_dir).load_config()
        with _search_batches() as batches:
            served, lat = _serve_queries(project_dir, config, QUERIES, k)
        launched = counts()
        if not batches or launched != (len(batches), 0):
            raise PhaseError(
                f"index: fused_topk_threshold / fused_topk launched "
                f"{launched} over {len(batches)} served search batches "
                f"(rows {batches}); expected one threshold launch a batch")

        # the same query vectors (the text tower's, on the kernel path as
        # the server's) against the stored vectors in plain PyTorch: the
        # towers are held against their plain twins in the slice phase
        ids = _vector_ids(project_dir)
        if len(ids) != INDEX_N:
            raise PhaseError(f"index: {len(ids)} vector rows in the DB")
        prefix = config.search.query_prefix
        qv = np.concatenate([extractor.extract_text_features(
            [f"{prefix} {q}".strip()]) for q in QUERIES])
        db_plain = torch.from_numpy(vecs).cuda()
        scores = (torch.from_numpy(qv).cuda() @ db_plain.T).cpu().numpy()
        for q, row in zip(QUERIES, scores):
            _check_against_plain(*served[q], row, ids, k, 1e-3)
        # 64 query vectors: the 8 text embeddings, 56 stored frames perturbed
        rng = np.random.default_rng(5)
        near = vecs[rng.integers(0, INDEX_N, 56)] + 0.02 * rng.standard_normal(
            (56, INDEX_D)).astype(np.float32)
        q64 = np.concatenate([qv, near / np.linalg.norm(near, axis=1,
                                                        keepdims=True)])
        q64 = np.ascontiguousarray(q64, np.float32)
        with torch.inference_mode():
            plain64 = TK._stable_topk(torch.from_numpy(q64).cuda()
                                      @ db_plain.T, 100)
            plain64 = (plain64[0].cpu(), plain64[1].cpu())
        del db_plain
        torch.cuda.empty_cache()
        say("index", card=repr(card), path="rest", requests=len(lat) + 9,
            search_batches=len(batches), search_batch_rows=sum(batches),
            threshold_launches=launched[0],
            http_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
            text_embed_p50_ms=f"{_p50_ms(lambda: extractor.extract_text_features(QUERIES[:1])):.3f}",
            vs_plain="ok")

        assets = project.WiseProject(project_dir).discover_assets()
        asset = assets["video"][MODEL_ID]

        def load(index_type="IndexFlatIP", device="cuda:0", **cfg):
            """A loaded index whose device copy is built: (index, seconds).
            On the card, or with ``device=None`` on the devices that
            ``WISE_TORCH_DEVICE`` names (phase_multi's mesh)."""
            t0 = time.perf_counter()
            idx = FeatureSearchIndex("video", MODEL_ID, asset,
                                     config=IndexConfig(**cfg), device=device)
            if not idx.load_index(index_type):
                raise PhaseError(f"index: no {index_type} file")
            idx.search_batch(q64[:1], k)
            return idx, time.perf_counter() - t0

        def timed(idx, tag, load_s, **more):
            say("index", card=repr(card), path=tag, load_s=f"{load_s:.1f}",
                q1_k10_p50_ms=f"{_p50_ms(lambda: idx.search_batch(q64[:1], k)):.3f}",
                q64_k100_p50_ms=f"{_p50_ms(lambda: idx.search_batch(q64, 100)):.3f}",
                **more)

        def scan_alone(idx):
            """The served query's kernel on the index's own rows, without
            search_batch's host side: CUDA-event ms of wt_topk_threshold at
            Q = 1, k = 10 with the merge (the first text query), and the
            query lists one call flushed. Through the uncounted launcher,
            so that the path's launch counts stay its own."""
            db = idx._ensure_device_db()
            n_valid = int(idx._metadata["count"])
            q = torch.from_numpy(q64[:1]).cuda()
            parts = _threshold_parts(torch, FT, q, db, n_valid, k)
            return {"q1_k10_kernel_ms": f"{parts['kernel_ms']:.4f}",
                    "q1_k10_flushes": parts["flushes"]}

        # f32: the batched search launches fused_topk and agrees with plain
        idx, load_s = load()
        before = counts()
        got = idx.search_batch(q64, 100)
        if counts() != (before[0], before[1] + 1):
            raise PhaseError(f"index: search_batch(64, k=100) launched "
                             f"{counts()} after {before}")
        rows64 = np.searchsorted(ids, got[1])
        check = FT.topk_agreement(
            (torch.from_numpy(got[0]), torch.from_numpy(rows64)), plain64,
            tol=2e-6)
        if not check["ok"]:
            raise PhaseError(f"index: search_batch(64, k=100) off the plain "
                             f"run: {check}")
        f32_10, f32_100 = idx.search_batch(q64, k), got
        f32_ids10, f32_ids100 = f32_10[1], f32_100[1]
        n_valid = int(idx._metadata["count"])
        timed(idx, "float32", load_s, q64_max_abs_err=check["max_abs_err"],
              q64_near_tie_swaps=check["mismatched"], **scan_alone(idx))
        del idx
        torch.cuda.empty_cache()

        # bf16: the kernel path on half the bytes; 64 queries at k = 10
        # go where the router sends them
        idx, load_s = load(storage_dtype="bfloat16")
        before = counts()
        bf_ids100 = idx.search_batch(q64, 100)[1]
        bf_ids10 = idx.search_batch(q64, k)[1]
        to_thr = int(TK.routes_to_threshold(len(q64), k))
        if counts() != (before[0] + to_thr, before[1] + 2 - to_thr):
            raise PhaseError(f"index: bf16 searches launched {counts()} "
                             f"after {before}")
        bf_recall = _recall(bf_ids100, f32_ids100)
        top1 = float((bf_ids10[:, 0] == f32_ids10[:, 0]).mean())
        if bf_recall < 0.95 or top1 < 0.95:
            raise PhaseError(f"index: bf16 storage recall@100 {bf_recall} "
                             f"top-1 {top1} against f32")
        timed(idx, "bfloat16", load_s, recall100_vs_f32=f"{bf_recall:.4f}",
              top1_vs_f32=f"{top1:.4f}", **scan_alone(idx))
        del idx
        torch.cuda.empty_cache()

        # int8: plain torch candidates + exact host rerank, no kernel
        idx, load_s = load(storage_dtype="int8")
        before = counts()
        i8 = [idx.search_batch(q64, kk) for kk in (k, 100)]
        if counts() != before:
            raise PhaseError("index: int8 storage launched a top-k kernel")
        # the rerank's scores are numpy's f32 sums: the f32 kernel's ids,
        # up to swaps between scores within 2e-6
        checks = [FT.topk_agreement(tuple(map(torch.from_numpy, a)),
                                    tuple(map(torch.from_numpy, b)), tol=2e-6)
                  for a, b in zip(i8, (f32_10, f32_100))]
        if not all(c["ok"] for c in checks):
            raise PhaseError(f"index: int8 ids differ from f32's: {checks}")
        timed(idx, "int8", load_s, ids_vs_f32="equal",
              near_tie_swaps=sum(c["mismatched"] for c in checks))
        del idx
        torch.cuda.empty_cache()

        # the approximate scan at recall target 0.95
        idx, load_s = load(flat_approx_recall=0.95)
        approx_recall = _recall(idx.search_batch(q64, 100)[1], f32_ids100)
        if approx_recall < 0.95:
            raise PhaseError(f"index: flat_approx_recall=0.95 gave recall "
                             f"{approx_recall} at 64 x k=100")
        timed(idx, "approx0.95", load_s,
              recall100_vs_exact=f"{approx_recall:.4f}",
              buckets=TK.approx_buckets(INDEX_N, 100, 0.95))
        del idx
        torch.cuda.empty_cache()

        # IVF-Flat from the same store, nprobe 1024
        t0 = time.perf_counter()
        if create_index.main(["--project-dir", str(project_dir),
                              "--index-type", "IndexIVFFlat"]) != 0:
            raise PhaseError("create-index IndexIVFFlat failed")
        ivf_build_s = time.perf_counter() - t0
        idx, load_s = load("IndexIVFFlat", nprobe=1024)
        ivf10 = idx.search_batch(q64, k)
        ivf_recall = _recall(ivf10[1], f32_ids10)
        say("index", card=repr(card), path="IndexIVFFlat",
            build_s=f"{ivf_build_s:.1f}", load_s=f"{load_s:.1f}",
            nlist=idx._metadata["nlist"], nprobe=1024,
            recall10_vs_flat=f"{ivf_recall:.4f}",
            q1_k10_p50_ms=f"{_p50_ms(lambda: idx.search_batch(q64[:1], k), 10):.3f}",
            q64_k10_p50_ms=f"{_p50_ms(lambda: idx.search_batch(q64, k), 5, 1):.3f}")
        if ivf_recall < 0.9:
            raise PhaseError(f"index: IVF-Flat recall@10 {ivf_recall} < 0.9 "
                             f"at nprobe 1024")
        del idx
        torch.cuda.empty_cache()

        pq10 = _ivfpq_leg(torch, card, project_dir, load, create_index, q64,
                          f32_ids10, k)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if keep is not None:
            keep.update(project_dir=project_dir, config=config, load=load,
                        q64=q64, n_valid=n_valid, served=served,
                        http_p50_ms=1e3 * float(np.median(lat)),
                        f32_ids10=f32_ids10, int8=i8[0], ivf=ivf10,
                        ivfpq=pq10)

    launches = {key: n for key, n in FT.LAUNCHES_BY_SHAPE.items() if n}
    say("index", card=repr(card), peak_device_gb=f"{peak_gb:.3f}",
        launches=json.dumps({_launch_name(key): n for key, n
                             in sorted(launches.items())},
                            separators=(",", ":")))
    return launches


def _ivfpq_leg(torch, card, project_dir, load, create_index, q64, flat_ids,
               k, nprobe=1024):
    """IndexIVFPQ built by the create-index CLI from the index phase's
    store, at the reference's defaults. The paged ADC is plain torch and no
    top-k kernel may launch. Held: 8 queries' ADC candidates (no rerank)
    against the numpy host ADC on the same file; recall@10 against the
    flat ids ``flat_ids`` of ``q64`` with each rerank and none; R1@10 over
    the perturbed stored frames (``q64[8:]``). Returns the default search's
    (scores, ids) of ``q64`` at ``k``."""
    import numpy as np
    from wise_tpu_torch.eval.index_recall import recall_at_k, top1_recall_at_n
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.ops.ivf_paged import ivfpq_search_paged

    launched = dict(FT.LAUNCHES_BY_SHAPE)
    t0 = time.perf_counter()
    if create_index.main(["--project-dir", str(project_dir),
                          "--index-type", "IndexIVFPQ"]) != 0:
        raise PhaseError("create-index IndexIVFPQ failed")
    build_s = time.perf_counter() - t0

    def recalls(ids):
        return (recall_at_k(flat_ids, ids, k),
                top1_recall_at_n(flat_ids[8:], ids[8:], k))

    # the default search: ADC candidates, reranked from the IndexFlatIP file
    idx, load_s = load("IndexIVFPQ", nprobe=nprobe)
    if idx._ensure_flat_sibling() is None:
        raise PhaseError("index: IVF-PQ found no IndexFlatIP sibling")
    default10 = idx.search_batch(q64, k)
    # the one card's paged shard (a mesh of one; parallel/sharded_search.py)
    pg = {name: part[0] for name, part in idx._ensure_pq_paged().items()
          if isinstance(part, list)}
    if pg["paged"].dtype != torch.uint8 or not pg["paged"].is_cuda:
        raise PhaseError(f"index: IVF-PQ codes {pg['paged'].dtype} on "
                         f"{pg['paged'].device}")
    resident = sum(t.numel() * t.element_size() for t in pg.values())
    flat_r10, flat_r1 = recalls(default10[1])
    q1_ms = _p50_ms(lambda: idx.search_batch(q64[:1], k), 10)
    q64_ms = _p50_ms(lambda: idx.search_batch(q64, k), 5, 1)
    meta = dict(idx._metadata)
    opq = "opq_rotation" in idx._arrays
    flat_file = idx.index_path("IndexFlatIP")
    del idx

    # the ADC alone, against the numpy host ADC on the same file
    idx, _ = load("IndexIVFPQ", nprobe=nprobe, pq_exact_rerank=False)
    q8 = q64[:8]
    got = idx.search_batch(q8, k)
    hv, hr = idx._search_ivfpq_host(q8, k, nprobe)
    check = FT.topk_agreement(
        tuple(map(torch.from_numpy, got)),
        (torch.from_numpy(hv), torch.from_numpy(idx._rows_to_ids(hv, hr))),
        tol=1e-5)
    if not check["ok"]:
        raise PhaseError(f"index: IVF-PQ ADC off the host ADC: {check}")
    adc_r10, adc_r1 = recalls(idx.search_batch(q64, k)[1])

    # ivfpq_search_paged alone at the rerank's 4 x k candidates: CUDA-event
    # ms a call (mean), its kernels' device ms and launches a call
    # (torch.profiler), the pages a query may probe and the chunk
    centroids = idx._ensure_ivf_coarse()[0]
    kc = idx.config.pq_rerank_mult * k
    paged = {}
    for qn in (1, 64):
        q = torch.from_numpy(idx._rotate_q_pq(q64[:qn])).cuda()
        budget, chunk = idx._paged_plan(idx._pq_paged, nprobe, nq=qn,
                                        pq=True)

        def adc(q=q, budget=budget, chunk=chunk):
            return ivfpq_search_paged(
                q, centroids, pg["page_first"], pg["page_count"],
                pg["paged"], pg["page_rows"], pg["codebooks"], nprobe=nprobe,
                budget=budget, chunk=chunk, k=kc)

        kernels = _device_kernels(torch, adc, reps=3 if qn == 1 else 1)
        paged[qn] = {
            "ms": f"{_cuda_ms(torch, adc, 20 if qn == 1 else 3):.3f}",
            "kernel_ms": f"{sum(e[0] for e in kernels):.3f}",
            "launches": f"{sum(e[1] for e in kernels):g}", "chunk": chunk,
            "budget_pages": budget}
    del idx

    # the int8 refine rerank: the flat file out of sight for this load
    hidden = flat_file.with_suffix(".hidden")
    flat_file.rename(hidden)
    try:
        idx, _ = load("IndexIVFPQ", nprobe=nprobe)
        if idx._ensure_flat_sibling() is not None:
            raise PhaseError("index: the IndexFlatIP file was not hidden")
        refine_r10, refine_r1 = recalls(idx.search_batch(q64, k)[1])
        refine_q1_ms = _p50_ms(lambda: idx.search_batch(q64[:1], k), 10)
        del idx
    finally:
        hidden.rename(flat_file)
    torch.cuda.empty_cache()

    say("index", card=repr(card), path="IndexIVFPQ",
        build_s=f"{build_s:.1f}", load_s=f"{load_s:.1f}",
        nlist=meta["nlist"], pq_m=meta["pq_m"], opq=opq, nprobe=nprobe,
        codes_device_bytes=pg["paged"].numel(),
        resident_device_bytes=resident,
        recall10_vs_flat=f"{flat_r10:.4f}",
        recall10_vs_flat_refine=f"{refine_r10:.4f}",
        recall10_vs_flat_adc=f"{adc_r10:.4f}",
        r1_at10_near=f"{flat_r1:.4f}", r1_at10_near_refine=f"{refine_r1:.4f}",
        r1_at10_near_adc=f"{adc_r1:.4f}",
        adc_vs_host_max_abs_err=check["max_abs_err"],
        adc_vs_host_swaps=check["mismatched"],
        q1_k10_p50_ms=f"{q1_ms:.3f}", q64_k10_p50_ms=f"{q64_ms:.3f}",
        q1_k10_refine_p50_ms=f"{refine_q1_ms:.3f}",
        **{f"paged_adc_q{qn}_{key}": val for qn, row in paged.items()
           for key, val in row.items()})
    if dict(FT.LAUNCHES_BY_SHAPE) != launched:
        raise PhaseError("index: a top-k kernel launched in the IVF-PQ leg")
    if flat_r10 < adc_r10:
        raise PhaseError(f"index: IVF-PQ recall@10 with the flat rerank "
                         f"{flat_r10} under the ADC's alone {adc_r10}")
    if min(flat_r1, refine_r1) < 0.9:
        raise PhaseError(f"index: IVF-PQ R1@10 on perturbed frames {flat_r1} "
                         f"(flat rerank), {refine_r1} (refine) < 0.9")
    return default10


#: the [multi] phase: the sharded scans' (Q, k), the data-parallel leg's
#: ranks, global batch, steps and seed, and the train CLI's batch at --dp
MULTI_SCANS = [(1, 10), (16, 10), (64, 100)]
DP_RANKS, DP_BATCH, DP_STEPS, DP_LR = 2, 256, 3, 1e-4
#: how far from 1 the data-parallel gradients' scale (_grad_check) may
#: be: the planted gather moves a tower's or logit_scale's by a factor of
#: DP_RANKS (before the clip, the towers'; after it, logit_scale's), and
#: the reduction order moved them by <= 2.3e-4 on the card
DP_SCALE_BAR = 1e-3


def _mesh_names(torch) -> list:
    """The multi-device phase's mesh: every visible card when there are two
    or more, else the one card twice (two shards, two ranks on it)."""
    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0"] * 2


def phase_multi(torch, card, keep, k=10):
    """The multi-device leg on the index phase's project (``keep``, from
    phase_index): the sharded flat, int8, IVF-Flat and IVF-PQ searches and
    the REST server on the mesh against their single-card counterparts,
    then data-parallel training through the train CLI at --dp 2. Returns the
    top-k wrappers' launches of its searches, at the shards' shapes and the
    single card's, counted as (wrapper, INDEX_N, INDEX_D): the shards hold
    the same rows."""
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.parallel.distributed import choose_backend
    from wise_tpu_torch.parallel.mesh import get_mesh

    names = _mesh_names(torch)
    mesh = get_mesh(devices=names)
    say("multi", card=repr(card), mesh=",".join(names),
        cards=torch.cuda.device_count(),
        layout=("one card twice" if len(set(names)) == 1
                else "a card a shard"),
        dp_ranks=DP_RANKS, dp_backend=choose_backend(DP_RANKS, names))
    _reset_launches()
    with _env(WISE_TORCH_DEVICE=",".join(names)):
        _multi_scans(torch, card, mesh, keep)
        _multi_indexes(torch, card, keep, k)
        _multi_serve(torch, card, mesh, keep, k)
    launches = {}
    for (name, rows, d), n in FT.LAUNCHES_BY_SHAPE.items():
        if n and d == INDEX_D:
            key = (name, INDEX_N, INDEX_D)
            launches[key] = launches.get(key, 0) + n
    say("multi", card=repr(card), topk_launches=json.dumps(
        {f"{name}@{rows}x{d}": n for (name, rows, d), n
         in sorted(FT.LAUNCHES_BY_SHAPE.items()) if n},
        separators=(",", ":")), counted_as=f"{INDEX_N}x{INDEX_D}")
    _multi_train(torch, card)
    return launches


def _multi_scans(torch, card, mesh, keep):
    """``sharded_scan_topk`` on shards of the index phase's f32 and bf16
    rows (on one card twice, views of the single card's copy) against the
    single card's ``flat_topk`` on the same rows: ids identical up to ties
    within 2e-6 and scores within 2e-6 (``topk_agreement``); each search
    launches the routed wrapper once a shard. Both times by CUDA events,
    each returning host arrays."""
    from wise_tpu_torch.ops import fused_topk as FT
    from wise_tpu_torch.ops.topk import flat_topk, routes_to_threshold
    from wise_tpu_torch.parallel.sharded_search import (pad_and_shard_db,
                                                        sharded_scan_topk)

    idx, _ = keep["load"]()
    db32, n, q64 = idx._ensure_device_db(), keep["n_valid"], keep["q64"]
    for storage in ("float32", "bfloat16"):
        db = db32 if storage == "float32" else db32.to(torch.bfloat16)
        shards, _ = pad_and_shard_db(mesh, db)
        rows = shards[0].shape[0]
        filled = sum(1 for i in range(len(shards)) if i * rows < n)
        shared = all(s.untyped_storage().data_ptr()
                     == db.untyped_storage().data_ptr() for s in shards)
        for qn, kk in MULTI_SCANS:
            q = q64[:qn]
            qt = torch.from_numpy(q).cuda()
            name = ("fused_topk_threshold" if routes_to_threshold(qn, kk)
                    else "fused_topk")
            before = FT.LAUNCHES_BY_SHAPE.get((name, rows, INDEX_D), 0)
            got = sharded_scan_topk(mesh, q, shards, n, kk)
            launched = FT.LAUNCHES_BY_SHAPE.get((name, rows, INDEX_D),
                                                0) - before
            want = flat_topk(qt, db, n, kk)
            check = FT.topk_agreement(tuple(map(torch.from_numpy, got)),
                                      (want[0].cpu(), want[1].cpu()),
                                      tol=2e-6)

            def single(qt=qt, db=db, kk=kk):
                return [t.cpu() for t in flat_topk(qt, db, n, kk)]

            def sharded(q=q, shards=shards, kk=kk):
                return sharded_scan_topk(mesh, q, shards, n, kk)

            say("multi", card=repr(card), leg="scan", storage=storage,
                q=qn, k=kk, wrapper=name, shards=len(shards),
                shard_rows=rows, filled_shards=filled,
                views_of_single=shared, launches_per_search=launched,
                max_abs_err=check["max_abs_err"],
                near_tie_swaps=check["mismatched"],
                single_ms=f"{_cuda_ms(torch, single, 10):.4f}",
                sharded_ms=f"{_cuda_ms(torch, sharded, 10):.4f}")
            if not check["ok"] or launched != filled:
                raise PhaseError(
                    f"multi: the sharded {storage} scan at Q {qn} k {kk} "
                    f"launched {name} {launched} times on {filled} filled "
                    f"shards, against the single card: {check}")
        del shards, db
    del idx, db32
    torch.cuda.empty_cache()


def _multi_indexes(torch, card, keep, k):
    """FeatureSearchIndex on the mesh (``WISE_TORCH_DEVICE`` names it) for
    int8 storage, IVF-Flat and IVF-PQ at nprobe 1024 (the flat-sibling
    rerank), against the index phase's single-card results of the same 64
    queries: ids identical up to swaps between scores within 2e-6 (int8's
    rerank and IVF-Flat's f32 scores) or 1e-5 (IVF-PQ's rerank is exact
    f32 too; its ADC candidates are the same set), and recall@10 against
    the flat ids beside the single card's."""
    from wise_tpu_torch.ops import fused_topk as FT

    q64 = keep["q64"]
    for label, kind, cfg in (("int8", "IndexFlatIP",
                              {"storage_dtype": "int8"}),
                             ("ivf", "IndexIVFFlat", {"nprobe": 1024}),
                             ("ivfpq", "IndexIVFPQ", {"nprobe": 1024})):
        idx, load_s = keep["load"](kind, device=None, **cfg)
        if not idx._sharded:
            raise PhaseError(f"multi: the {kind} index is not on the mesh")
        got, want = idx.search_batch(q64, k), keep[label]
        check = FT.topk_agreement(tuple(map(torch.from_numpy, got)),
                                  tuple(map(torch.from_numpy, want)),
                                  tol=2e-6 if label != "ivfpq" else 1e-5)
        recall, single = (_recall(r[1], keep["f32_ids10"])
                          for r in (got, want))
        say("multi", card=repr(card), leg=kind, storage=cfg.get(
            "storage_dtype", "float32"), nprobe=cfg.get("nprobe"),
            shards=idx._mesh.shape["dp"], load_s=f"{load_s:.1f}",
            ids_vs_single="ok" if check["ok"] else "differ",
            max_abs_err=check["max_abs_err"],
            near_tie_swaps=check["mismatched"],
            recall10_vs_flat=f"{recall:.4f}",
            single_recall10_vs_flat=f"{single:.4f}",
            q1_k10_p50_ms=f"{_p50_ms(lambda: idx.search_batch(q64[:1], k), 10):.3f}")
        if not check["ok"]:
            raise PhaseError(f"multi: the sharded {kind} ({label}) search "
                             f"differs from the single card's: {check}")
        del idx
        torch.cuda.empty_cache()


def _multi_serve(torch, card, mesh, keep, k):
    """The REST server on the project with ``WISE_TORCH_DEVICE`` naming the
    mesh: the 8 queries' served top-10 must be the single-card server's
    (the index phase's), and every served search batch launches the
    threshold scan once a filled shard."""
    import numpy as np
    from wise_tpu_torch.ops import fused_topk as FT

    ndev = mesh.shape["dp"]
    rows = -(-keep["n_valid"] // (ndev * 4096)) * 4096
    filled = sum(1 for i in range(ndev) if i * rows < keep["n_valid"])
    key = ("fused_topk_threshold", rows, INDEX_D)
    before = FT.LAUNCHES_BY_SHAPE.get(key, 0)
    with _search_batches() as batches:
        served, lat = _serve_queries(keep["project_dir"], keep["config"],
                                     QUERIES, k)
    launched = FT.LAUNCHES_BY_SHAPE.get(key, 0) - before
    differ = [q for q in QUERIES if served[q][0] != keep["served"][q][0]]
    gap = max(float(np.abs(np.subtract(served[q][1],
                                       keep["served"][q][1])).max())
              for q in QUERIES)
    say("multi", card=repr(card), leg="rest", shards=ndev,
        requests=len(lat) + 9, search_batches=len(batches),
        threshold_launches=launched, top10_vs_single=(
            "equal" if not differ else f"differ:{len(differ)}"),
        max_distance_gap=f"{gap:.4f}",
        http_p50_ms=f"{1e3 * float(np.median(lat)):.3f}",
        single_http_p50_ms=f"{keep['http_p50_ms']:.3f}")
    if differ or gap > 1e-3 or launched != filled * len(batches):
        raise PhaseError(
            f"multi: the mesh server's top-{k} differs from the single "
            f"card's for {differ} (distance gap {gap}), or it launched the "
            f"scan {launched} times for {len(batches)} batches on {filled} "
            f"filled shards")


def _multi_train(torch, card):
    """Data parallelism through the train CLI: ``--dp`` DP_RANKS at global
    batch DP_BATCH for DP_STEPS steps (_train_cli, whose ranks record their
    steps, _recording), against the single-card trainer from the same
    seed-0 f32 masters, optimizer settings and batches (the CLI's own
    ``caption_batches`` over the same stand-ins): the first step's
    whole-tree gradient cosine >= 0.999, the losses within 1e-3, and the
    scale of the gradients (_grad_check: the norm of each tower's gradient
    and of ``logit_scale``'s over the single card's, each within
    DP_SCALE_BAR of 1), which the planted gather (_planted) must fail;
    step ms (CUDA events) and peak memory a rank beside the single
    card's."""
    import gc

    from wise_tpu_torch.cli.train import (training_clip_config,
                                          training_tokenizer)
    from wise_tpu_torch.parallel.train import CLIPTrainer
    from wise_tpu_torch.pipeline.train_data import caption_batches

    model = "ViT-B-32"
    cfg = training_clip_config(model)
    with _stand_ins(model, DP_BATCH) as (segments, _):
        batches = caption_batches(segments, training_tokenizer(cfg), DP_BATCH,
                                  cfg.image_size, epochs=10_000)
        batches = [next(batches) for _ in range(DP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    trainer = CLIPTrainer(cfg, learning_rate=DP_LR, total_steps=DP_STEPS,
                          grad_clip=1.0).init(seed=0)
    single = {"losses": [], "step_ms": []}
    ref = tempfile.TemporaryDirectory(prefix="wise_smoke_ref_")
    for images, tokens in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        single["losses"].append(float(trainer.train_step(images, tokens)))
        ev[1].record()
        torch.cuda.synchronize()
        single["step_ms"].append(ev[0].elapsed_time(ev[1]))
        if len(single["losses"]) == 1:
            torch.save(trainer.whole(trainer.grads()),
                       Path(ref.name) / "grads.pt")
    single_gb = torch.cuda.max_memory_allocated() / 1e9
    del trainer, batches
    gc.collect()
    torch.cuda.empty_cache()
    out = {"ref": str(Path(ref.name) / "grads.pt")}
    try:
        _train_cli(torch, card, model, steps=DP_STEPS, batch=DP_BATCH,
                   dp=DP_RANKS, out=out)
    finally:
        ref.cleanup()
    ranks = out["ranks"]
    got, fault = ranks[0]["grads"], ranks[0]["fault"]
    scale_off = max(abs(v - 1) for v in got["scales"].values())
    caught = max(abs(v - 1) for v in fault["scales"].values()) > DP_SCALE_BAR
    gap = max(abs(a - b) for r in ranks for a, b in zip(r["losses"],
                                                       single["losses"]))
    for r, rec in enumerate(ranks):
        say("multi", card=repr(card), leg="dp_train", model=model, rank=r,
            device=rec["device"], rows=DP_BATCH // DP_RANKS,
            global_batch=DP_BATCH, step_ms=",".join(
                f"{v:.3f}" for v in rec["step_ms"]),
            peak_device_gb=f"{rec['peak_device_gb']:.3f}",
            launches_per_step_exact=rec["launches_exact"])
    say("multi", card=repr(card), leg="dp_train", check="vs_single_card",
        ranks=DP_RANKS, whole_tree_grad_cos=f"{got['cos']:.6f}",
        cos_bar=0.999,
        losses=",".join(f"{v:.5f}" for v in ranks[0]["losses"]),
        single_losses=",".join(f"{v:.5f}" for v in single["losses"]),
        max_loss_gap=f"{gap:.6f}", loss_bar=1e-3,
        grad_scale=",".join(f"{k}:{v:.6f}"
                            for k, v in got["scales"].items()),
        scale_bar=DP_SCALE_BAR,
        worst_leaf_scale_off=f"{got['worst_leaf']:.2e}",
        planted_grad_scale=",".join(f"{k}:{v:.6f}"
                                    for k, v in fault["scales"].items()),
        planted="FAIL(expected)" if caught else "PASSED(wrong)",
        single_step_ms=",".join(f"{v:.3f}" for v in single["step_ms"]),
        single_peak_device_gb=f"{single_gb:.3f}")
    if not (got["cos"] >= 0.999 and gap <= 1e-3 and scale_off <= DP_SCALE_BAR
            and caught and all(r["launches_exact"] for r in ranks)):
        raise PhaseError(f"multi: {DP_RANKS} data-parallel ranks off the "
                         f"single card (grads {got}, loss gap {gap}), the "
                         f"planted gather not caught ({fault}), or off the "
                         f"kernel path's launches")


#: the padded-head phase (ViT-H/14's vision tower with the padded-head block
#: opened): the batch of the tower run and the per-layer timing, and the
#: training rule's batch
PADDED_BATCH, PADDED_TRAIN_BATCH = 64, 32
#: the embed fold's phase at ViT-B/32's geometry: batch, tokens (49 patches
#: and the cls row; the port does not pad to 56), patch, width, heads
EMBED_B, EMBED_SP, EMBED_PATCH, EMBED_D, EMBED_HEADS = 512, 50, 32, 768, 12


@contextlib.contextmanager
def _padded_gate(seq: int, width: int):
    """Open the padded-head block for one tower shape while the block runs,
    as the reference's tests open it (tests/test_fused_block_model.py
    ``force_fused_block_padded``): (seq, width) enters ops.block's padded
    table and leaves the monolithic block's gate. Both close again after,
    so every other phase runs with the tables as they ship (empty)."""
    from wise_tpu_torch.ops import block as K

    real = K.supports_fused_block
    K._CALIBRATED_PAD.add((seq, width))
    K.supports_fused_block = lambda s, w, h: ((s, w) != (seq, width)
                                              and real(s, w, h))
    try:
        yield
    finally:
        K.supports_fused_block = real
        K._CALIBRATED_PAD.discard((seq, width))


def _addmm(torch, a, w, b=None):
    """The library yardstick of a GEMM row: one torch.addmm on the same
    product (bf16 operands, the bias where the row has one), the product
    alone: no LayerNorm, activation, residual or attention around it."""
    a2 = a.reshape(-1, a.shape[-1])
    bias = b if b is not None else torch.zeros(
        w.shape[1], dtype=w.dtype, device=w.device)
    return lambda: torch.addmm(bias, a2, w)


#: The GEMM at the main paths' shapes, through the two entries that are one
#: GEMM each: tag -> (entry, B, SP, K, N, f32 stream, act or None for
#: fused_residual_matmul). ViT-H/14's qkv, fc and out/fc2 products (the f32
#: stream; the block kernels run the same products inside their chains),
#: the XLM-R text embed's M = 512 (8 x 64: 128 x 128 tiles for qkv, 64 x 64
#: for the out-projection, whose 128 x 128 grid would leave over half the
#: SMs idle), and HTSAT stage 0 at batch 64 (K = 96: a last K step of 32, N
#: = 288 and 96 ragged against 128-wide tiles).
GEMM_SHAPES = {
    "vit_h-qkv": ("fused_ln_matmul", 256, 257, 1280, 3840, True, "none"),
    "vit_h-fc": ("fused_ln_matmul", 256, 257, 1280, 5120, True, "gelu"),
    "vit_h-proj": ("fused_residual_matmul", 256, 257, 5120, 1280, True, None),
    "xlmr-qkv": ("fused_ln_matmul", 8, 64, 1024, 3072, False, "none"),
    "xlmr-proj": ("fused_residual_matmul", 8, 64, 4096, 1024, False, None),
    "swin0-qkv": ("fused_ln_matmul", 4096, 64, 96, 288, False, "none"),
    "swin0-proj": ("fused_residual_matmul", 4096, 64, 96, 96, False, None),
}


def _gemm_rows(torch, results):
    """The GEMM rows (GEMM_SHAPES): fused_ln_matmul held whole
    (output_agreement), fused_residual_matmul on its increment over x, with
    torch.addmm on the same product as ``library_ms``. Planted: the last K
    step's rows of W zeroed (a mainloop that stopped a stage early), the
    last N tile's columns left unwritten (an epilogue that dropped the
    ragged edge). A row whose (entry, SP, D) no path launches stands in
    ``off_path`` with the block entry that runs its product."""
    from wise_tpu_torch.ops import block as K

    bf = torch.bfloat16
    for i, (tag, (entry, b, sp, k, n, f32, act)) in enumerate(
            GEMM_SHAPES.items()):
        m, xb = b * sp, 4 if f32 else 2
        g = torch.Generator(device="cuda").manual_seed(150 + i)
        dtype = torch.float32 if f32 else bf
        w = (torch.randn(k, n, generator=g, device="cuda")
             * k ** -0.5).to(bf)
        bias = (0.02 * torch.randn(n, generator=g, device="cuda")).to(bf)
        k_cut = (k - 1) // 64 * 64
        w_cut = w.clone()
        w_cut[k_cut:] = 0
        n_cut = (n - 1) // 128 * 128
        if act is not None:
            x = torch.randn(b, sp, k, generator=g, device="cuda").to(dtype)
            ln = (1.0 + 0.25 * torch.randn(k, generator=g, device="cuda"),
                  0.25 * torch.randn(k, generator=g, device="cuda"))
            y = K.layer_norm_f32(x, *ln).to(bf)

            def run(w=w, x=x, ln=ln, bias=bias, act=act):
                return K.fused_ln_matmul(x, *ln, w, bias, act)

            def edge_dropped(run=run, n_cut=n_cut):
                out = run().clone()
                out[..., n_cut:] = 0
                return out

            _check_row(torch, results, entry, tag, (entry, sp, k), x, run,
                       lambda x=x, ln=ln, w=w, bias=bias, act=act:
                       K.plain_ln_matmul(x, *ln, w, bias, act), None,
                       {"last_k_step_zeroed": lambda run=run, w_cut=w_cut:
                        run(w_cut),
                        "last_n_tile_dropped": edge_dropped},
                       (2 * m * k * n, m * k * xb + 2 * (k * n + n)
                        + _LN_BYTES * k + m * n * xb),
                       library=_addmm(torch, y, w, bias))
            del y
        else:
            x = torch.randn(b, sp, n, generator=g, device="cuda").to(dtype)
            h = torch.randn(b, sp, k, generator=g, device="cuda").to(bf)

            def run(w=w, x=x, h=h, bias=bias):
                return K.fused_residual_matmul(x, h, w, bias)

            def edge_dropped(run=run, x=x, n_cut=n_cut):
                out = run().clone()
                out[..., n_cut:] = x[..., n_cut:]
                return out

            _check_row(torch, results, entry, tag, (entry, sp, n), x, run,
                       lambda x=x, h=h, w=w, bias=bias:
                       K.plain_residual_matmul(x, h, w, bias), x,
                       {"last_k_step_zeroed": lambda run=run, w_cut=w_cut:
                        run(w_cut),
                        "last_n_tile_dropped": edge_dropped},
                       (2 * m * k * n, 2 * m * k + 2 * (k * n + n)
                        + 2 * m * n * xb),
                       library=_addmm(torch, h, w, bias))
            del h
        del x, w, w_cut
        torch.cuda.empty_cache()


def _gemm_refuses_misaligned(torch):
    """A W view 2 bytes off a 16-byte boundary (contiguous, so only the
    alignment is wrong) must raise in the wrapper, and the C entry must
    return an error without a launch."""
    import ctypes

    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops.build import load_library

    bf = torch.bfloat16
    k, n, m = 256, 256, 128
    x = torch.randn(1, m, n, device="cuda")
    h = torch.randn(1, m, k, device="cuda").to(bf)
    bias = torch.zeros(n, dtype=bf, device="cuda")
    flat = torch.randn(k * n + 8, device="cuda").to(bf)
    w_off = flat[1:1 + k * n].view(k, n)
    try:
        K.fused_residual_matmul(x, h, w_off, bias)
        wrapper = "returned"
    except ValueError:
        wrapper = "raised"
    out = torch.empty_like(x)
    lib = load_library()
    err = lib.wt_residual_matmul(
        h.data_ptr(), w_off.data_ptr(), bias.data_ptr(), x.data_ptr(), 1,
        out.data_ptr(), m, n, k,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    ok = wrapper == "raised" and err != 0
    say("kernels", name="gemm[misaligned-w]", wrapper=wrapper,
        entry=f"cudaError_t {err}", status="ok" if ok else "FAIL")
    if not ok:
        raise PhaseError("a W operand off a 16-byte boundary was not refused")


#: (entry, SP, D) keys of GEMM rows no path launches, and the block entry
#: whose chain runs that product there
GEMM_OFF_PATH = {
    ("fused_ln_matmul", 64, 1024): "fused_postln_attn_block (qkv, M = 512)",
    ("fused_residual_matmul", 64, 1024): "fused_postln_proj (M = 512)",
    ("fused_ln_matmul", 64, 96): "fused_swin_block (qkv, stage 0)",
    ("fused_residual_matmul", 64, 96): "fused_swin_block (out-proj, stage 0)",
}


def _padded_rows(torch, results, b, sp, d, heads):
    """The padded block's three kernels at ViT-H/14's vision shape (f32
    stream): fused_ln_matmul (act none, as the block calls it, and gelu) and
    the attention middle at head_dim 128 held whole (output_agreement),
    fused_residual_matmul on its increment over x. The LayerNorm parameters
    at 1 + N(0, 0.25) / N(0, 0.25), so that a kernel that left them out
    would show. Planted: the LayerNorm's scale and bias as ones and zeros,
    h not activated; the attention at head_dim 128's own scale (the true
    head_dim's is passed), the key mask dropped, the last key tile
    unscanned; the residual GEMM with
    half its heads dropped, the block skipped."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from wise_tpu_torch.ops import attention as A
    from wise_tpu_torch.ops import block as K

    hd, hp = d // heads, K.HEAD_PAD
    dp, m = heads * hp, b * sp
    x, _, w = _block_inputs(torch, b, sp, d, torch.float32, 140)
    g = torch.Generator(device="cuda").manual_seed(141)
    ln = (1.0 + 0.25 * torch.randn(d, generator=g, device="cuda"),
          0.25 * torch.randn(d, generator=g, device="cuda"))
    ident = (torch.ones(d, device="cuda"), torch.zeros(d, device="cuda"))
    (wq, bq), _, _, wo_pad = K._pad_head_weights(*w[:3], heads, hd, hp)
    y = K.layer_norm_f32(x, *ln).to(torch.bfloat16)
    for act in ("none", "gelu"):
        faults = {"ln_identity": lambda a=act: K.fused_ln_matmul(
            x, *ident, wq, bq, a)}
        if act == "gelu":
            faults["h_not_activated"] = lambda: K.fused_ln_matmul(
                x, *ln, wq, bq, "none")
        _check_row(torch, results, "fused_ln_matmul", f"vit_h-padded-{act}",
                   ("fused_ln_matmul", sp, d), x,
                   lambda a=act: K.fused_ln_matmul(x, *ln, wq, bq, a),
                   lambda a=act: K.plain_ln_matmul(x, *ln, wq, bq, a), None,
                   faults,
                   (2 * m * d * dp, m * d * 4 + (d * dp + dp) * 2
                    + _LN_BYTES * d + m * dp * 4),
                   library=_addmm(torch, y, wq, bq))

    # q, k and v as the padded GEMMs hand them over: zero past each head's
    # true head_dim
    qkv = torch.randn(b, sp, 3, heads, hp, generator=g, device="cuda")
    qkv[..., hd:] = 0
    q, k, v = (t.reshape(b, sp, dp).to(torch.bfloat16)
               for t in qkv.unbind(2))
    del qkv
    scale = hd ** -0.5
    q4, k4, v4 = (t.reshape(b, sp, heads, hp).transpose(1, 2)
                  for t in (q, k, v))

    def attn(fn=A.fused_short_attention, n_valid=sp, scale=scale):
        return fn(q, k, v, heads, n_valid, False, scale)

    _check_row(torch, results, "fused_short_attention", "vit_h-padded",
               ("fused_short_attention", sp, dp), q, attn,
               lambda: attn(A.plain_short_attention), None,
               {"scale_of_hd128": lambda: attn(scale=None),
                "mask_dropped": lambda: (
                    attn(), attn(A.plain_short_attention, n_valid=sp - 7),
                    attn(n_valid=sp - 7)),
                "last_tile_unscanned": lambda: attn(
                    n_valid=_last_whole_tile(sp))},
               (4 * b * sp * sp * dp, 4 * m * dp * 2),
               library=lambda: sdpa(q4, k4, v4, scale=scale))

    h = attn()
    half = h.clone()
    half[..., dp // 2:] = 0
    _check_row(torch, results, "fused_residual_matmul", "vit_h-padded",
               ("fused_residual_matmul", sp, d), x,
               lambda: K.fused_residual_matmul(x, h, wo_pad, w[3]),
               lambda: K.plain_residual_matmul(x, h, wo_pad, w[3]), x,
               {"heads_dropped": lambda: K.fused_residual_matmul(
                   x, half, wo_pad, w[3]),
                "block_skipped": lambda: x},
               (2 * m * dp * d, m * dp * 2 + (dp * d + d) * 2 + 2 * m * d * 4),
               library=_addmm(torch, h, wo_pad, w[3]))
    del x, y, q, k, v, q4, k4, v4, h, half
    torch.cuda.empty_cache()


def _padded_layer(torch, card, batch, sp, d, heads, model, seed):
    """One attention layer at batch x sp x d (f32 stream): the padded chain
    (fused_attn_block_padded, each head zero-padded to HEAD_PAD) against
    fused_attn_block, both on their increment against plain_attn_block,
    and their CUDA-event ms in turns (padded, monolithic, monolithic,
    padded). The shape's entry in ops.block._CALIBRATED_PAD rests on this
    line: the table stays empty unless the padded block wins."""
    from wise_tpu_torch.ops import block as K

    x, ln, w = _block_inputs(torch, batch, sp, d, torch.float32, seed)
    kw = dict(heads=heads, n_valid=sp)
    fns = {"padded": K.fused_attn_block_padded,
           "monolithic": K.fused_attn_block}
    with torch.inference_mode():
        ref = K.plain_attn_block(x, *ln, *w, **kw)
        chk = {name: K.increment_agreement(fn(x, *ln, *w, **kw), ref, x)
               for name, fn in fns.items()}
        del ref
        layer_ms = {name: [] for name in fns}
        for name in ("padded", "monolithic", "monolithic", "padded"):
            layer_ms[name].append(_cuda_ms(
                torch, lambda f=fns[name]: f(x, *ln, *w, **kw), 20))
    say("padded", card=repr(card), check="layer", model=model,
        shape=f"{batch}x{sp}x{d}", head_dim=d // heads, dtype="float32",
        padded_ms=",".join(f"{v:.4f}" for v in layer_ms["padded"]),
        monolithic_ms=",".join(f"{v:.4f}" for v in layer_ms["monolithic"]),
        padded_min_cos=f"{chk['padded']['min_cos']:.6f}",
        monolithic_min_cos=f"{chk['monolithic']['min_cos']:.6f}",
        padded_wins=min(layer_ms["padded"]) < min(layer_ms["monolithic"]),
        status="ok" if all(c["ok"] for c in chk.values()) else "FAIL")
    if not all(c["ok"] for c in chk.values()):
        raise PhaseError(f"padded: a {model} layer off plain_attn_block "
                         f"{chk}")
    del x
    torch.cuda.empty_cache()


def phase_padded(torch, card, batch: int = PADDED_BATCH,
                 train_batch: int = PADDED_TRAIN_BATCH):
    """The padded-head block (ops/block.py fused_attn_block_padded) on
    ViT-H/14's vision tower, the path of a head_dim that is not a multiple
    of 64, as the reference's tests and its probe
    (scripts/bench_block_kernels.py --padded) drive it. Returns (launch
    counts of the tower run keyed by (wrapper, SP, D), kernel rows).

    1. The port's extractor (OpenCLIP ViT-H/14, production config, random
       weights from seed 0: 32 layers, 1280 wide, 16 heads of 80, 257
       tokens) embeds one 64-frame batch with the gate opened for its
       vision shape (_padded_gate): the run must launch exactly 93
       fused_ln_matmul, 31 fused_short_attention at width 16 x 128, 31
       fused_residual_matmul, 31 split MLP pairs and one pooled block, and no
       monolithic block. Its embeddings against the monolithic block path
       and the plain path on the same weights and frames: per-frame cosine
       >= 0.999 each, and the three paths' device ms a batch.
    2. One layer at 64 x 257 x 1280 (f32 stream): the padded chain against
       fused_attn_block (CUDA events, 20 calls after 3), both on their
       increment against plain_attn_block; the same at ViT-g-14's 64 x 257
       x 1408 and ViT-bigG-14's 64 x 257 x 1664 (_padded_layer).
    3. fused_attn_block_padded_train, forward + backward at 32 x 257 x 1280,
       against autograd through plain_attn_block: per-tensor gradient
       cosine >= 0.999.
    4. The kernel rows (_padded_rows) at the batch of 1 and 2."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor
    from wise_tpu_torch.ops import block as K

    fe = OpenClipExtractor(VIT_H_ID)
    c = fe.config
    sp = (c.image_size // c.patch_size) ** 2 + 1
    d, heads, layers = c.vision_width, c.vision_heads, c.vision_layers
    dp = heads * K.HEAD_PAD
    frames = _frames(77, batch, 224)
    with torch.inference_mode(), _padded_gate(sp, d):
        fe.extract_image_features(frames[:8])  # first use of the path
        _reset_launches()
        got = torch.from_numpy(fe.extract_image_features(frames))
        launches = _block_launches()
        padded_ms = _encode_rates(torch, fe, frames)[1]
    full = layers - 1
    mlp = (("fused_mlp_fc", "fused_mlp_proj", "fused_mlp_split")
           if K.mlp_choice(d) == "split" else ("fused_mlp_block",))
    want = {("fused_ln_matmul", sp, d): 3 * full,
            ("fused_short_attention", sp, dp): full,
            ("fused_residual_matmul", sp, d): full,
            **{(name, sp, d): full for name in mlp},
            ("fused_attn_block_pooled", sp, d): 1}
    if launches != want:
        raise PhaseError(f"padded: the tower launched {launches}, expected "
                         f"{want}")
    mono = torch.from_numpy(fe.extract_image_features(frames))
    mono_ms = _encode_rates(torch, fe, frames)[1]
    plain = _twin(torch, fe)
    flat = torch.from_numpy(plain.extract_image_features(frames))
    plain_ms = _encode_rates(torch, plain, frames)[1]
    del plain
    cos = {name: torch.nn.functional.cosine_similarity(got, ref, dim=-1)
           .min().item() for name, ref in (("monolithic", mono),
                                           ("plain", flat))}
    say("padded", card=repr(card), model="ViT-H-14", batch=batch,
        min_cos_vs_monolithic=f"{cos['monolithic']:.6f}",
        min_cos_vs_plain=f"{cos['plain']:.6f}", cos_bar=0.999,
        padded_device_ms_per_batch=f"{padded_ms:.3f}",
        monolithic_device_ms_per_batch=f"{mono_ms:.3f}",
        plain_device_ms_per_batch=f"{plain_ms:.3f}",
        launches=json.dumps({_launch_name(key): n for key, n
                             in sorted(launches.items())},
                            separators=(",", ":")))
    if not (got.shape == mono.shape and bool(torch.isfinite(got).all())
            and min(cos.values()) >= 0.999):
        raise PhaseError(f"padded: embeddings off the other paths {cos}")
    del fe, got, mono, flat
    torch.cuda.empty_cache()

    # one layer: the padded chain against the monolithic block, at
    # ViT-H/14's shape and at ViT-g-14's and ViT-bigG-14's (head dims 88
    # and 104), where the monolithic block runs on the new instantiations
    _padded_layer(torch, card, batch, sp, d, heads, "ViT-H-14", 142)
    for tag, model in (("vit_g", "ViT-g-14"), ("vit_bigg", "ViT-bigG-14")):
        s = BLOCK_SHAPES[tag]
        _padded_layer(torch, card, batch, s["sp"], s["d"], s["heads"], model,
                      s["seeds"][0])

    # the training rule
    x, ln, w = _block_inputs(torch, train_batch, sp, d, torch.float32, 143)
    args = [t.requires_grad_() for t in (x, *ln, *w)]
    weight = torch.randn(x.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(144))

    def grads(fn):
        out = fn(*args, heads, sp)
        return torch.autograd.grad((out.float() * weight).sum(), args)

    got, ref = grads(K.fused_attn_block_padded_train), grads(
        K.plain_attn_block)
    check = _grad_agreement(got, ref)
    per = {n: _flat_cos(a, b) for n, a, b in zip(
        ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo"), got, ref)}
    del got, ref
    ms = _cuda_ms(torch, lambda: grads(K.fused_attn_block_padded_train), 10)
    plain_ms = _cuda_ms(torch, lambda: grads(K.plain_attn_block), 10)
    say("backward", name="fused_attn_block_padded_train[vit_h-padded]",
        shape=f"{train_batch}x{sp}x{d}", dtype="float32",
        min_cos=f"{check['min_cos']:.6f}", cos_bar=GRAD_COS_MIN,
        max_rel_err=f"{check['max_rel_err']:.6g}", err_bar=GRAD_ERR_SHARE,
        cos=",".join(f"{n}:{c:.6f}" for n, c in per.items()),
        fwd_bwd_ms=f"{ms:.4f}", plain_fwd_bwd_ms=f"{plain_ms:.4f}",
        status="ok" if check["ok"] else "FAIL")
    if not check["ok"]:
        raise PhaseError("padded: the training rule's gradients are off "
                         "plain_attn_block's")
    del args, weight
    torch.cuda.empty_cache()

    results = []
    _padded_rows(torch, results, batch, sp, d, heads)
    _require_rows(results)
    return launches, results


def _embed_inputs(torch, seed):
    """The fold's inputs at ViT-B/32's geometry: frames ~ U[-2, 2]
    patchified (row 0 of each example zero), the patch kernel at
    1/sqrt(fan_in), positions and the class embedding N(0, 0.02) and their
    combined table, ln_pre and LN1 at 1 + N(0, 0.25) / N(0, 0.25), the
    attention weights as _block_inputs draws them. Returns (fold arguments,
    cls, pos)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, sp, d = EMBED_B, EMBED_SP, EMBED_D
    pd = EMBED_PATCH ** 2 * 3

    def r(*shape, scale=0.02):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    xp = (4 * torch.rand(b, sp, pd, generator=g, device="cuda") - 2).to(
        torch.bfloat16)
    xp[:, 0] = 0
    kern = r(pd, d, scale=pd ** -0.5).to(torch.bfloat16)
    cls, pos = r(d), r(sp, d)
    posc = pos.clone()
    posc[0] += cls
    lns = [t for _ in range(2) for t in (1.0 + r(d, scale=0.25),
                                         r(d, scale=0.25))]
    _, _, w = _block_inputs(torch, 1, sp, d, torch.float32, seed + 1)
    return [xp, kern, posc, *lns, *w], cls, pos


def phase_embed_fold(torch, card):
    """The embed fold (ops/embed_block.py fused_embed_attn_block: patch
    GEMM, positional + cls table, ln_pre and the first attention block in
    one entry) at ViT-B/32's geometry, B = 512, SP = 50, PD = 3072, D = 768,
    12 heads, seeded weights; the model does not call it, as the
    reference's does not, so its path is the wrapper. Returns (launch counts
    of the path's one call keyed by (wrapper, SP, D), kernel rows).

    The path: one call with the stream in f32, counted (exactly one launch,
    nothing else). Then the kernel rows, f32 and bf16 stream (``bf16_out``),
    against plain_embed_attn on the first block's increment over the ln_pre
    stream (every row is valid at SP = 50); planted: the positional table
    dropped, the block skipped. Then the fold against the split entry (the
    model's patch GEMM in bf16, cls and positions added in bf16, ln_pre,
    fused_attn_block), as scripts/probe_embed_fold.py times it: ms of both
    (CUDA events, 20 calls after 3) and their per-token cosine."""
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.ops import embed_block as E

    b, sp, d, heads = EMBED_B, EMBED_SP, EMBED_D, EMBED_HEADS
    pd, m = EMBED_PATCH ** 2 * 3, EMBED_B * EMBED_SP
    args, cls, pos = _embed_inputs(torch, 150)
    xp, kern, posc, lnp_s, lnp_b, ln_s, ln_b, *w = args
    with torch.inference_mode():
        E.fused_embed_attn_block(*args, heads, sp)  # first use
        torch.cuda.synchronize()
        _reset_launches()
        E.fused_embed_attn_block(*args, heads, sp)
        torch.cuda.synchronize()
        launches = _block_launches()
    if launches != {("fused_embed_attn_block", sp, d): 1}:
        raise PhaseError(f"embed_fold: the path launched {launches}")

    results = []
    for tag, bf16_out in (("vit_b32-f32", False), ("vit_b32-bf16", True)):
        ob = 2 if bf16_out else 4
        with torch.inference_mode():
            stream = K.layer_norm_f32(xp.float() @ kern.float() + posc,
                                      lnp_s, lnp_b).to(
                torch.bfloat16 if bf16_out else torch.float32)

        def fold(posc=posc, bf16_out=bf16_out):
            return E.fused_embed_attn_block(xp, kern, posc, *args[3:], heads,
                                            sp, bf16_out)

        _check_row(torch, results, "fused_embed_attn_block", tag,
                   ("fused_embed_attn_block", sp, d), xp, fold,
                   lambda bf16_out=bf16_out: E.plain_embed_attn(
                       *args, heads, sp, bf16_out), stream,
                   {"positions_dropped": lambda: fold(torch.zeros_like(posc)),
                    "block_skipped": lambda s=stream: s},
                   (2 * m * pd * d + 8 * m * d * d + 4 * m * sp * d,
                    m * pd * 2 + pd * d * 2 + sp * d * 4 + 2 * _LN_BYTES * d
                    + (4 * d * d + 4 * d) * 2 + m * d * ob),
                   library=_addmm(torch, xp, kern))
        del stream

    def split():
        """The model's entry (VisionTransformer.forward up to the first
        block) on the same pixels, then fused_attn_block."""
        x = xp[:, 1:] @ kern
        x = torch.cat([cls.to(x.dtype).expand(b, 1, -1), x], dim=1)
        x = K.layer_norm_f32(x + pos.to(x.dtype), lnp_s, lnp_b)
        return K.fused_attn_block(x, ln_s, ln_b, *w, heads, sp)

    with torch.inference_mode():
        cos = torch.nn.functional.cosine_similarity(
            E.fused_embed_attn_block(*args, heads, sp).reshape(-1, d),
            split().reshape(-1, d), dim=-1).min().item()
        fold_ms = _cuda_ms(torch, lambda: E.fused_embed_attn_block(
            *args, heads, sp), 20)
        split_ms = _cuda_ms(torch, split, 20)
    say("embed_fold", card=repr(card), shape=f"{b}x{sp}x{pd}->{d}",
        heads=heads, fold_ms=f"{fold_ms:.4f}", split_entry_ms=f"{split_ms:.4f}",
        min_cos_fold_vs_split=f"{cos:.6f}", cos_bar=0.999,
        launches=json.dumps({_launch_name(key): n for key, n
                             in sorted(launches.items())},
                            separators=(",", ":")))
    if not cos >= 0.999:
        raise PhaseError(f"embed_fold: the fold is off the split entry (min "
                         f"cos {cos:.6f})")
    del args, xp, kern
    torch.cuda.empty_cache()
    _require_rows(results)
    return launches, results


def _off_path(key):
    """Why a kernel row's wrapper is one that no path may launch at the
    row's shape, or None: the post-LN MLP as "single" where
    ``postln_mlp_choice`` picks the split pair (the XLM-R width, as in the
    reference's table), and the GEMM rows whose product a block entry runs
    on the path (GEMM_OFF_PATH). Such a row is held against its plain
    version in the kernels phase alone, and its count over the paths must
    be 0."""
    from wise_tpu_torch.ops.postln_block import postln_mlp_choice

    if key in GEMM_OFF_PATH:
        return f"a GEMM row; on the path {GEMM_OFF_PATH[key]} runs it"
    name, _, width = key[:3]
    if (name == "fused_postln_mlp_block"
            and postln_mlp_choice(width) != "single"):
        return "the width's table picks the split pair, as the reference's"
    return None


def _launch_name(key) -> str:
    """A launch counter's key as text: (wrapper, SP, D) of the block
    kernels, (wrapper, L, C, masked) of the Swin kernels, (wrapper, N_pad,
    D) of the top-k kernels."""
    name, a, b, *masked = key
    if name.startswith("fused_topk"):
        return f"{name}[N={'any' if a is None else a},D={b}]"
    if masked:
        return f"{name}[L={a},C={b}{',masked' if masked[0] else ''}]"
    return f"{name}[SP={a},D={b}]"


def _device_kernels(torch, fn, reps: int = 3, grad: bool = False):
    """Device ms per CUDA kernel over ``reps`` calls of ``fn``
    (torch.profiler, kernels only: each kernel's self device time), as
    [(ms a call, launches a call, kernel name)], largest first. ``grad``
    leaves autograd on, for a function that trains."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(not grad):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return sorted(
        ((e.self_device_time_total / (1e3 * reps), e.count / reps, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)


def _say_kernels(kernels, top: int = 16, **tag):
    say("profile", **tag,
        kernel_ms_per_batch=(f"{sum(k[0] for k in kernels):.4f}"
                             if kernels else "not measured"),
        kernels=len(kernels))
    for k_ms, n, key in kernels[:top]:
        say("profile", **tag, ms=f"{k_ms:.4f}", launches=f"{n:g}",
            kernel=key[:100])


def profile_image_batch(torch, card, model_id: str = VIT_H_ID,
                        batch: int = 256):
    """Where one image batch's time goes on the kernel path (ViT-H/14 unless
    ``model_id`` says otherwise): device ms (CUDA events, mean of 3 calls)
    of preprocess + image tower on 256 frames at the model's size, of one
    text embed, and the device ms per CUDA kernel of the image batch
    (torch.profiler, mean of 2 batches)."""
    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    fe = OpenClipExtractor(model_id)
    size = fe.config.image_size
    frames = _frames(0, batch, size)
    x = torch.from_numpy(frames).to(fe.device)
    model = model_id.split("/")[2]

    def tower():
        fe.model.encode_image(fe.preprocess_frames(x, size))

    with torch.inference_mode():
        fe.extract_image_features(frames[:8])  # first use
        fe.extract_text_features(["warm up"])
        ms = dict(
            batch=_cuda_ms(torch, tower, 3),
            preprocess=_cuda_ms(torch, lambda: fe.preprocess_frames(x, size),
                                3),
            text_embed_1=_cuda_ms(
                torch, lambda: fe.extract_text_features_dispatch(
                    ["a dog barking"]), 3))
    say("profile", card=repr(card), model=model, batch=batch,
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()})
    _say_kernels(_device_kernels(torch, tower, 2), model=model)


def profile_xlmr_text(torch, card, reps: int = 5):
    """Where a text query's time goes for the default backbone on the
    kernel path: device ms (CUDA events, mean of ``reps`` calls) of one text
    embed at 8 queries and at 1, on the kernel path and on the plain twin;
    the extractor's host-to-host ms for one query (median); and the device
    ms per CUDA kernel of the 8-query embed (torch.profiler)."""
    import numpy as np

    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    fe = OpenClipExtractor(XLMR_ID)
    plain = _twin(torch, fe)

    def embed(extractor, n):
        return lambda: extractor.extract_text_features_dispatch(QUERIES[:n])

    with torch.inference_mode():
        for extractor in (fe, plain):  # first use
            extractor.extract_text_features(QUERIES)
            extractor.extract_text_features(QUERIES[:1])
        ms = {f"{name}_text_embed_{n}": _cuda_ms(torch, embed(extractor, n),
                                                 reps)
              for name, extractor in (("kernels", fe), ("plain", plain))
              for n in (8, 1)}
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fe.extract_text_features(QUERIES[:1])
        host.append(time.perf_counter() - t0)
    say("profile", card=repr(card), model=XLMR_ID.split("/")[2],
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
        extract_text_1_host_ms=f"{1e3 * float(np.median(host)):.4f}")
    _say_kernels(_device_kernels(torch, embed(fe, 8)),
                 model=XLMR_ID.split("/")[2], path="text_embed_8")


def profile_train_step(torch, card, model: str = "ViT-B-32",
                       batch: int = 256):
    """Where one train step's time goes on the kernel path: ms of its
    forward, backward and optimizer update (CUDA events, median of 5) and
    the device ms per CUDA kernel of a whole step (torch.profiler, mean of 2
    steps)."""
    import gc

    from wise_tpu_torch.cli.train import training_clip_config
    from wise_tpu_torch.parallel.train import CLIPTrainer

    cfg = training_clip_config(model, "bfloat16")
    trainer = CLIPTrainer(cfg, learning_rate=1e-5, grad_clip=1.0).init(seed=0)
    images, tokens = _train_batch(torch, cfg, 200, batch)
    say("profile", card=repr(card), model=model, batch=batch,
        path="train_step", **_step_ms(torch, trainer, images, tokens))
    _say_kernels(_device_kernels(
        torch, lambda: trainer.train_step(images, tokens), 2, grad=True),
        top=20, model=model, path="train_step")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def phase_profile(torch, card, batch: int = 64, reps: int = 5):
    """Where one audio batch's time goes on the kernel path, one run: device
    ms (CUDA events, mean of ``reps`` calls) of the whole batch at 64 and at
    32 segments, of the log-mel, the HTSAT tower, each of its modules (on
    the input the tower gives it) and the projection; one caption's text
    embed; the extractor's host-to-host ms on a 32-segment ingest batch
    (median); and the device ms per CUDA kernel over three batches
    (torch.profiler, kernels only: each kernel's self device time). Fails
    if a roll, permute or copy kernel runs inside a Swin block on the block
    path (each block profiled on its input in the tower): the shift's roll
    and the window partition are read through the block's token map."""
    import numpy as np

    from wise_tpu_torch.models.clap.extractor import ClapExtractor
    from wise_tpu_torch.models.clap.model import SwinBlock

    segs = _segments(torch, batch, seed=7)
    fe = ClapExtractor(AUDIO_ID)
    enc = fe.model.audio_encoder
    x = torch.from_numpy(segs).to(fe.device)

    def cuda_ms(fn):
        return _cuda_ms(torch, fn, reps)

    with torch.inference_mode():
        fe.extract_audio_features(segs[:32])  # first use
        fe.extract_text_features(["warm up"])
        mel = fe.log_mel(x)
        feats = enc(mel)
        ms = dict(
            batch=cuda_ms(lambda: fe.encode_waveforms(x)),
            half_batch=cuda_ms(lambda: fe.encode_waveforms(x[:batch // 2])),
            log_mel=cuda_ms(lambda: fe.log_mel(x)),
            htsat=cuda_ms(lambda: enc(mel)),
            projection=cuda_ms(lambda: fe.model.audio_projection(feats)),
            text_embed_1=cuda_ms(
                lambda: fe.extract_text_features_dispatch(["a dog barking"])))
        modules = {"embed": cuda_ms(lambda: enc.embed(mel))}
        h = enc.embed(mel)
        for names in enc.stages:
            for name in names:
                mod = getattr(enc, name)
                modules[name] = cuda_ms(lambda m=mod, h=h: m(h))
                h = mod(h)
        modules["norm_pool"] = cuda_ms(lambda: enc.norm(h).mean(dim=1))
        layout, h = {}, enc.embed(mel)
        for names in enc.stages:
            for name in names:
                mod = getattr(enc, name)
                if isinstance(mod, SwinBlock) and mod.block_path:
                    for _ in range(3):  # a profile may record no kernel
                        seen = [k[2] for k in _device_kernels(
                            torch, lambda m=mod, h=h: m(h), 1)]
                        if any("attn" in k or "attention" in k
                               for k in seen):
                            break
                    else:
                        raise PhaseError(f"{name}: no attention kernel in "
                                         f"its profile: {seen}")
                    layout[name] = [k[:80] for k in seen if any(
                        w in k.lower() for w in ("roll", "copy", "permute"))]
                h = mod(h)
    copies = {k: v for k, v in layout.items() if v}
    say("profile", swin_blocks_profiled=len(layout),
        swin_layout_copies=json.dumps(copies) if copies else "none")
    if copies:
        raise PhaseError(f"layout copies inside Swin blocks on the block "
                         f"path: {copies}")
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fe.extract_audio_features(segs[:32])
        host.append(time.perf_counter() - t0)

    kernels = _device_kernels(torch, lambda: fe.encode_waveforms(x))

    say("profile", card=repr(card), batch=batch,
        **{f"{k}_ms": f"{v:.4f}" for k, v in ms.items()},
        extract_32_host_ms=f"{1e3 * float(np.median(host)):.4f}")
    say("profile", htsat_module_ms=json.dumps(
        {k: round(v, 4) for k, v in modules.items()}, separators=(",", ":")))
    _say_kernels(kernels)


def _audio_rates(torch, extractor, segs, reps: int = 5):
    """(segments/s of extract_audio_features on one batch, host to host;
    device ms of resample + log-mel + audio tower + projection on that
    batch, CUDA events)."""
    extractor.extract_audio_features(segs)
    t0 = time.perf_counter()
    for _ in range(reps):
        extractor.extract_audio_features(segs)
    sps = reps * len(segs) / (time.perf_counter() - t0)
    x = torch.from_numpy(segs).to(extractor.device)
    with torch.inference_mode():
        ms = _cuda_ms(torch, lambda: extractor.encode_waveforms(x), reps)
    return sps, ms


def _encode_rates(torch, extractor, frames, reps: int = 5):
    """(frames/s of extract_image_features on one batch, host to host;
    device ms of preprocess + image tower on that batch, CUDA events)."""
    extractor.extract_image_features(frames)
    t0 = time.perf_counter()
    for _ in range(reps):
        extractor.extract_image_features(frames)
    fps = reps * len(frames) / (time.perf_counter() - t0)
    x = torch.from_numpy(frames).to(extractor.device)
    size = extractor.config.image_size

    def tower():
        extractor.model.encode_image(extractor.preprocess_frames(x, size))

    with torch.inference_mode():
        ms = _cuda_ms(torch, tower, reps)
    return fps, ms


# ---------------------------------------------------------------------------
# tensor and pipeline parallelism: [mp] and [pp]
# ---------------------------------------------------------------------------

#: [mp]: the train CLI at --mp MP_RANKS, DP_STEPS steps at DP_LR, on each
#: (model, global batch); on one card the ranks share it (gloo)
MP_RANKS = 2
MP_LEGS = ((XLMR_MODEL, 32), ("ViT-B-32", 256))
#: [pp]: the train CLI at --pp PP_STAGES --microbatches PP_MICRO
PP_STAGES, PP_MICRO, PP_MODEL, PP_BATCH = 2, 4, "ViT-B-32", 256
#: both held to the single card's run from the same masters and batches:
#: the whole tree's first-step gradient cosine, the losses step by step,
#: each tower's gradient norm and logit_scale's (PAR_SCALE_BAR). The single
#: card parts from itself by this much when nothing but the order of its
#: f32 sums changes (--phase mp_witness: its blocks' out-projection and fc2
#: summed as two halves, LN(x)'s cotangent formed in f32): on the default
#: backbone at batch 32 cosine 0.999404 and logit_scale's norm 1.007021; on
#: ViT-B/32 at 256 cosine 0.999946, logit_scale 1.003300 and the third loss
#: 2.316e-3 apart (NVIDIA H100 80GB HBM3, 700 W). The scale and loss bars sit
#: at about twice those; the planted missing all_reduce moves the cosine to
#: 0.977 (default backbone) or 0.700 (ViT-B/32)
PAR_COS_BAR, PAR_SCALE_BAR, PAR_LOSS_BAR = 0.999, 1.5e-2, 5e-3
#: what a recorded CLI run reads (_recording): JSON, set by its caller
RECORD_ENV = "WISE_SMOKE_RECORD"
#: the head-split kernel rows: rank 0's slices at the shapes [mp] launches
#: (ViT-H/14's vision tower at the default backbone's batch 32, ViT-B/32's
#: two towers at 256; the XLM-R tower is not split)
MP_SHAPES = {
    "vit_h": dict(b=32, sp=257, d=1280, heads=16, f32=True, causal=False,
                  act="gelu", seeds=(81, 82, 83)),
    "vit_b32": dict(b=256, sp=50, d=768, heads=12, f32=True, causal=False,
                    act="gelu", seeds=(84, 85, 86)),
    "vit_b32_text": dict(b=256, sp=77, d=512, heads=8, f32=False,
                         causal=True, act="gelu", seeds=(87, 88, 89)),
}


def _mp_rows(torch, results, tag, s):
    """The head-split entries at one shape on rank 0's slices of whole
    weights (parallel/train.py ``_shard_leaf``), each held to its plain form
    on the same slices, both closed over one rank (``mp_close`` with no
    group: the rank's partial plus the bias on x): the attention chain, the
    MLP's fc half and its proj half, the pooled chain (the static row 0, or
    seeded per-example rows on the causal tower). The bound is the whole
    block's over MP_RANKS; the library SDPA on the rank's heads and
    torch.addmm on each product slice. Planted: q zeroed, the block
    skipped, h not activated, the keys past each row kept."""
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.parallel import distributed as TD
    from wise_tpu_torch.parallel import train as TT

    tp, one = TD.TensorParallel(MP_RANKS, 0), TD.NO_SPLIT
    b, sp, d, h, causal = s["b"], s["sp"], s["d"], s["heads"], s["causal"]
    hl, e, f = h // MP_RANKS, d // MP_RANKS, 4 * d
    dtype = torch.float32 if s["f32"] else torch.bfloat16
    xb = 4 if s["f32"] else 2

    def per_rank(work):
        return work[0] / MP_RANKS, work[1] / MP_RANKS

    def split_attn(w):
        return (TT._shard_leaf("attn.in_proj.kernel", w[0], tp),
                w[1][tp.qkv_columns(d, w[1].device)].contiguous(),
                TT._shard_leaf("attn.out_proj.kernel", w[2], tp))

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][0])
    wm, bo = split_attn(w), w[3]
    keys = (sp + 1) / 2 if causal else sp

    def attn(wm=wm, partial=K.fused_attn_partial):
        return K.mp_close(x, partial(x, *ln, *wm, hl, sp, causal)[0], bo, one)

    _check_row(torch, results, "fused_attn_block_mp", tag,
               ("fused_attn_block_mp", sp, d), x, attn,
               lambda: attn(partial=K.plain_attn_partial), x,
               {"faulted_kernel": lambda: attn(_zero_q(wm, e)),
                "block_skipped": lambda: x},
               per_rank(_attn_work(b, sp, d, xb, keys)),
               library=_sdpa_of_block(torch, x, ln, wm, hl, causal))

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][1], mlp=True)
    act = s["act"]
    wfc = TT._shard_leaf("mlp_fc.kernel", w[0], tp)
    bfc = w[1][tp.columns(f)].contiguous()
    wproj, bproj = TT._shard_leaf("mlp_proj.kernel", w[2], tp), w[3]
    with torch.inference_mode():
        y = K.layer_norm_f32(x, *ln).to(torch.bfloat16)
        hid = K.plain_mlp_fc(x, *ln, wfc, bfc, act=act)
        raw = K.plain_mlp_fc(x, *ln, wfc, bfc, act="none")
    _check_row(torch, results, "fused_mlp_fc_mp", tag,
               ("fused_mlp_fc_mp", sp, d), x,
               lambda: K.fused_mlp_fc_mp(x, *ln, wfc, bfc, act, False)[0],
               lambda: K.plain_mlp_fc(x, *ln, wfc, bfc, act=act),
               torch.zeros((), device="cuda"),
               {"h_not_activated": lambda: K.fused_mlp_fc_mp(
                   x, *ln, wfc, bfc, "none", False)[0]},
               per_rank(_mlp_work(b * sp, d, f, xb, "fc")),
               library=_addmm(torch, y, wfc, bfc))

    def proj(hh=hid, kernel=True):
        part = (K.fused_mlp_proj_partial(hh, wproj, x) if kernel
                else (hh @ wproj).float())
        return K.mp_close(x, part, bproj, one)

    _check_row(torch, results, "fused_mlp_proj_mp", tag,
               ("fused_mlp_proj_mp", sp, d), x, proj,
               lambda: proj(kernel=False), x,
               {"h_not_activated": lambda: proj(raw),
                "block_skipped": lambda: x},
               per_rank(_mlp_work(b * sp, d, f, xb, "proj")),
               library=_addmm(torch, hid, wproj))
    del y, hid, raw

    x, ln, w = _block_inputs(torch, b, sp, d, dtype, s["seeds"][2])
    wm, bo = split_attn(w), w[3]
    if causal:
        g = torch.Generator(device="cuda").manual_seed(s["seeds"][2])
        rows = torch.randint(0, sp, (b,), generator=g, device="cuda",
                             dtype=torch.int32)
        name, keys = ("fused_attn_block_pooled_dyn_mp",
                      float(rows.float().mean()) + 1)
        library = _sdpa_of_block(torch, x, ln, wm, hl, causal, rows=rows)
    else:
        rows, name, keys = None, "fused_attn_block_pooled_mp", sp
        library = _sdpa_of_block(torch, x, ln, wm, hl, causal, 0)
    base = K.pooled_rows(x, rows, 0)

    def pooled(wm=wm, causal=causal, partial=K.fused_attn_pooled_partial):
        return K.mp_close(base, partial(x, rows, *ln, *wm, hl, sp, 0,
                                        causal), bo, one)

    faults = {"faulted_kernel": lambda: pooled(_zero_q(wm, e)),
              "block_skipped": lambda: base}
    if causal:
        faults["causal_keys_past_row_kept"] = lambda: pooled(causal=False)
    _check_row(torch, results, name, tag, (name, sp, d), x, pooled,
               lambda: pooled(partial=K.plain_attn_pooled_partial), base,
               faults, per_rank(_attn_work(b, sp, d, xb, keys, pooled=True)),
               library=library)


def _gather_without_reduce():
    """``gather_rows`` whose backward takes the rank's rows of the gradient
    without summing it over the ranks first (DDP's average then leaves the
    towers 1/W of their gradient and ``logit_scale`` all of it)."""
    import torch

    from wise_tpu_torch.parallel import train as TT

    class GatherWithoutReduce(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return TT._GatherRows.forward(ctx, x)

        @staticmethod
        def backward(ctx, grad):
            lo, hi = ctx.rows
            return grad[lo:hi].to(ctx.dtype)

    return GatherWithoutReduce.apply


def _planted(name: str):
    """A planted fault, in place until the returned function undoes it:
    "gather", the data-parallel loss's gather without the sum over the
    ranks in its backward (_gather_without_reduce); "ln_cotangent", the
    head-split blocks without the all_reduce of LN(x)'s cotangent over the
    'mp' ranks (``TensorParallel.reduce_cotangent`` the identity);
    "stage_hop", the pipeline's activations detached as they cross to the
    next stage (``PipelinedStack._hop``), so that no gradient reaches the
    stages before the last."""
    from wise_tpu_torch.parallel import distributed as TD
    from wise_tpu_torch.parallel import pipeline as PL
    from wise_tpu_torch.parallel import train as TT

    cls, attr, fake = {
        "ln_cotangent": (TD.TensorParallel, "reduce_cotangent",
                         lambda self, g: g),
        "stage_hop": (PL.PipelinedStack, "_hop",
                      lambda self, y, device: y.detach().to(device)),
        "gather": (TT, "gather_rows", _gather_without_reduce()),
    }[name]
    real = getattr(cls, attr)
    setattr(cls, attr, fake)
    return lambda: setattr(cls, attr, real)


def _whole_grads(trainer):
    """The first step's gradients by CLIP state_dict key, whole, on the
    host (a collective of the 'mp' ranks; None on the others)."""
    if hasattr(trainer, "pp_tree"):
        from wise_tpu_torch.parallel.pp_train import restore_clip_params

        return restore_clip_params(trainer.pp_tree(grads=True))
    return trainer.whole(trainer.grads())


def _grad_check(got: dict, want: dict) -> dict:
    """A leg's first-step gradients (``got``) against the single card's:
    the whole tree's cosine, the norm over the single card's of each tower's
    (``visual.*``, the rest is "text") and of ``logit_scale``'s (a check
    that the cosine cannot make, since it ignores scale), the worst single
    leaf's; in f64 on the card a leaf at a time (the host's passes over a
    1.2 B tree take ~20 s)."""
    import torch

    sums, worst = {}, 0.0   # group -> [got.want, got.got, want.want]
    for name, w in want.items():
        group = (name if name == "logit_scale"
                 else "visual" if name.startswith("visual.") else "text")
        a = got[name].flatten().cuda().double()
        w = w.flatten().cuda().double()
        dots = [float(torch.dot(a, w)), float(torch.dot(a, a)),
                float(torch.dot(w, w))]
        acc = sums.setdefault(group, [0.0, 0.0, 0.0])
        for i, v in enumerate(dots):
            acc[i] += v
        if dots[2] > 0:
            worst = max(worst, abs(math.sqrt(dots[1] / dots[2]) - 1))
    num, gg, ww = (sum(v[i] for v in sums.values()) for i in range(3))
    return {"cos": num / math.sqrt(gg * ww),
            "cos_by": {k: v[0] / math.sqrt(v[1] * v[2]) if v[1] * v[2] > 0
                       else 1.0 for k, v in sums.items()},
            "scales": {k: math.sqrt(v[1] / v[2]) for k, v in sums.items()},
            "worst_leaf": worst,
            "logit_scale": [float(got["logit_scale"]),
                            float(want["logit_scale"])],
            "tree_norm": math.sqrt(ww)}


def _grad_ok(check: dict) -> bool:
    """The cosine and the scales (the towers' and logit_scale's) within
    their bars."""
    return check["cos"] >= PAR_COS_BAR and all(
        abs(v - 1) <= PAR_SCALE_BAR for v in check["scales"].values())


@contextlib.contextmanager
def _recording(torch, spec: dict):
    """Every CLIPTrainer and PipelinedCLIPTrainer ``train_step`` in this
    process recorded while the block runs: its loss, CUDA-event ms and
    launches (by wrapper, exact against ``spec["want"]``, and by (wrapper,
    SP, D)). At the first step: with ``spec["plant"]`` ("ln_cotangent"),
    the first gradients with the planted fault before it (clipped as the
    optimizer clips them, then cleared), and after it the real ones, each
    whole; rank 0 saves them to ``spec["save"]`` or holds them to
    ``spec["ref"]`` (_grad_check). The record goes to ``spec["out"]`` as
    ``rank<r>.json`` when the block ends (where a step ran)."""
    from wise_tpu_torch.parallel.pp_train import PipelinedCLIPTrainer
    from wise_tpu_torch.parallel.train import CLIPTrainer

    rec = {"losses": [], "step_ms": [], "launches": {}, "by_shape": {},
           "launches_exact": True}
    ref = []

    def want_ref():
        if not ref:
            ref.append(torch.load(spec["ref"], map_location="cpu",
                                  mmap=True, weights_only=True))
        return ref[0]

    def held(grads, key):
        if grads is None:
            return
        if spec.get("save"):
            torch.save(grads, spec["save"])
        if spec.get("ref"):
            rec[key] = _grad_check(grads, want_ref())

    def wrap(step):
        def recorded(trainer, images, tokens):
            first = not rec["losses"]
            if first and spec.get("plant"):
                undo = _planted(spec["plant"])
                try:
                    trainer.optimizer.zero_grad()
                    trainer.loss(
                        torch.as_tensor(images).to(trainer.device,
                                                   torch.float32),
                        torch.as_tensor(tokens).to(trainer.device,
                                                   torch.int64)).backward()
                finally:
                    undo()
                with torch.no_grad():
                    if trainer.optimizer.grad_clip > 0:
                        trainer.optimizer._clip()
                held(_whole_grads(trainer), "fault")
                trainer.optimizer.zero_grad()
            names, shapes = _launches_by_name(), dict(_block_launches())
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss = step(trainer, images, tokens)
            ev[1].record()
            torch.cuda.synchronize()
            rec["losses"].append(float(loss))
            rec["step_ms"].append(ev[0].elapsed_time(ev[1]))
            # the step's launches: the counters' growth, which leaves them
            # running for the caller
            launched = {k: n - names.get(k, 0)
                        for k, n in _launches_by_name().items()
                        if n > names.get(k, 0)}
            rec["launches_exact"] &= launched == spec["want"]
            _add_counts(rec["launches"], launched)
            for key, n in _block_launches().items():
                if n > shapes.get(key, 0):
                    flat = "|".join(map(str, key))
                    rec["by_shape"][flat] = (rec["by_shape"].get(flat, 0)
                                             + n - shapes.get(key, 0))
            if first:
                held(_whole_grads(trainer), "grads")
            return loss
        return recorded

    saved = [(cls, cls.train_step) for cls in (CLIPTrainer,
                                                PipelinedCLIPTrainer)]
    for cls, step in saved:
        cls.train_step = wrap(step)
    torch.cuda.reset_peak_memory_stats()
    try:
        yield rec
    finally:
        for cls, step in saved:
            cls.train_step = step
    if not rec["losses"]:
        return   # the steps ran in ranks of their own, which record them
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    rec.update(device=f"cuda:{torch.cuda.current_device()}",
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               backend=dist.get_backend() if dist.is_initialized()
               else "none")
    (Path(spec["out"]) / f"rank{rank}.json").write_text(json.dumps(rec))


def _recorded_cli_rank(argv) -> None:
    """A rank the train CLI spawned (--mp, or --pp over several cards) in a
    process of its own: the stand-ins installed, the CLI's own rank entry
    under ``_recording`` with $WISE_SMOKE_RECORD's spec."""
    import torch

    from wise_tpu_torch.cli import train as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = argv[argv.index("--model") + 1]
    batch = int(argv[argv.index("--batch-size") + 1])
    cut = (_default_backbone_cut() if os.environ.get(TRAIN_DEPTH_ENV)
           else contextlib.nullcontext())
    with cut, _stand_ins(model, batch), _recording(
            torch, json.loads(os.environ[RECORD_ENV])):
        cli._rank_main(argv)


def _recorded_cli(torch, model: str, batch: int, more=(), spec=None,
                  env=None):
    """The train CLI (``main``) on ``model`` at global ``batch`` for
    DP_STEPS steps at DP_LR with ``more`` arguments, the stand-ins for its
    captions and frames, and every step recorded (_recording with
    ``spec``; in its ranks when it spawns them): (its return code, the
    records by rank, the checkpoint directory, seconds, the temporary
    directory to clean up)."""
    from wise_tpu_torch.cli import train as cli

    tmp = tempfile.TemporaryDirectory(prefix="wise_smoke_par_")
    root = Path(tmp.name)
    (root / "proj").mkdir()
    ckpt = root / "ckpt" / model / "finetuned"
    spec = dict(spec or {}, out=str(root))
    argv = ["--project-dir", str(root / "proj"), "--metadata-id",
            "S/smoke/train", "--caption-column", "caption", "--model", model,
            "--steps", str(DP_STEPS), "--batch-size", str(batch),
            "--learning-rate", str(DP_LR), "--checkpoint-dir", str(ckpt),
            *more]
    real = cli._rank_main
    cli._rank_main = _recorded_cli_rank
    t0 = time.time()
    try:
        # in this process, or in the ranks the CLI spawns (each records
        # itself, _recorded_cli_rank)
        with _env(**{RECORD_ENV: json.dumps(spec)}, **(env or {})), \
                _stand_ins(model, batch), _recording(torch, spec):
            rc = cli.main(argv)
    finally:
        cli._rank_main = real
    took = time.time() - t0
    recs = [json.loads(p.read_text()) for p in sorted(root.glob("rank*"))]
    return rc, recs, ckpt, took, tmp


_REFS: dict = {}


def _single_ref(torch, card, model: str, batch: int, plain: bool = False):
    """The single card's run that a leg is held to: the train CLI at --dp 1
    on ``model`` (its kernel path, or with ``plain`` the pp config's plain
    path: WISE_FUSED_BLOCK / _ATTN / WISE_POOL_LAST 0), recorded, its
    first-step gradients saved; cached for the run. Returns (record, path
    of the gradients)."""
    from wise_tpu_torch.cli.train import training_clip_config

    key = (model, batch, plain)
    if key not in _REFS:
        off = (dict(WISE_FUSED_BLOCK="0", WISE_FUSED_ATTN="0",
                    WISE_POOL_LAST="0") if plain else {})
        with _env(**off):
            want = _step_launches(training_clip_config(model))
        tmp = tempfile.TemporaryDirectory(prefix="wise_smoke_ref_")
        grads = Path(tmp.name) / "grads.pt"
        rc, recs, _, took, run = _recorded_cli(
            torch, model, batch, ["--dp", "1"], dict(want=want, save=str(
                grads)), env=off)
        run.cleanup()
        if rc != 0 or len(recs) != 1 or not recs[0]["launches_exact"]:
            raise PhaseError(f"the single card's {model} CLI run returned "
                             f"{rc}, launches {recs and recs[0]['launches']}"
                             f", expected {want} a step")
        say("par", card=repr(card), leg="single_card", model=model,
            batch=batch, plain=plain, cli_s=f"{took:.1f}",
            losses=",".join(f"{v:.5f}" for v in recs[0]["losses"]),
            step_ms=",".join(f"{v:.3f}" for v in recs[0]["step_ms"]),
            peak_device_gb=f"{recs[0]['peak_device_gb']:.3f}")
        _REFS[key] = (recs[0], grads, tmp)
    return _REFS[key][:2]


def _serves(torch, card, phase, ckpt: Path, model: str, params: dict):
    """The port's extractor on ``ckpt`` (a ``<model>/finetuned`` directory):
    every tensor the checkpoint's ``params`` cast to the serving dtype,
    finite unit embeddings of QUERIES and of 8 frames."""
    import gc

    import numpy as np

    from wise_tpu_torch.models.clip.extractor import OpenClipExtractor

    with _env(WISE_CHECKPOINT_DIR=str(ckpt.parents[1])):
        served = OpenClipExtractor(f"mlfoundations/open_clip/{model}/"
                                   f"{ckpt.name}")
    state = served.model.state_dict()
    differ = [k for k, v in params.items()
              if not torch.equal(state[k].cpu(), v.to(state[k].dtype))]
    text = served.extract_text_features(QUERIES)
    images = served.extract_image_features(
        _frames(9, 8, served.model.config.image_size))
    del served, state
    gc.collect()
    torch.cuda.empty_cache()
    emb = np.concatenate([text, images])
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1).max())
    say(phase, card=repr(card), check="extractor_serves_checkpoint",
        model=model, tensors=len(params), tensors_differing=len(differ),
        max_unit_norm_err=f"{norm_err:.2e}", norm_bar=1e-3)
    if differ or not np.isfinite(emb).all() or norm_err > 1e-3:
        raise PhaseError(f"{phase}: the extractor's {model} differs from "
                         f"the checkpoint in {differ[:5]} or its embeddings "
                         f"are off (norm error {norm_err})")


def _check_leg(card, phase, leg, model, batch, recs, ref, planted=True):
    """A parallel leg's records against the single card's ``ref``: every
    rank's launches exact and its losses the same; rank 0's first-step
    gradients within the bars (_grad_ok) and, where a fault was planted,
    its gradients outside them; the losses within PAR_LOSS_BAR step by
    step. Prints a line a rank and the check's."""
    for r, rec in enumerate(recs):
        say(phase, card=repr(card), leg=leg, model=model, rank=r,
            device=rec["device"], backend=rec["backend"],
            global_batch=batch,
            step_ms=",".join(f"{v:.3f}" for v in rec["step_ms"]),
            single_step_ms=",".join(f"{v:.3f}" for v in ref["step_ms"]),
            peak_device_gb=f"{rec['peak_device_gb']:.3f}",
            single_peak_device_gb=f"{ref['peak_device_gb']:.3f}",
            launches_per_step_exact=rec["launches_exact"])
    got, fault = recs[0].get("grads"), recs[0].get("fault")
    gap = max(abs(a - b) for rec in recs
              for a, b in zip(rec["losses"], ref["losses"]))
    caught = not planted or (fault is not None and not _grad_ok(fault))
    say(phase, card=repr(card), leg=leg, check="vs_single_card",
        model=model, ranks=len(recs),
        whole_tree_grad_cos=f"{got['cos']:.6f}", cos_bar=PAR_COS_BAR,
        grad_cos=",".join(f"{k}:{v:.6f}" for k, v in got["cos_by"].items()),
        grad_scale=",".join(f"{k}:{v:.6f}"
                            for k, v in got["scales"].items()),
        scale_bar=PAR_SCALE_BAR,
        logit_scale_grad=",".join(f"{v:.6g}" for v in got["logit_scale"]),
        tree_grad_norm=f"{got['tree_norm']:.6g}",
        losses=",".join(f"{v:.5f}" for v in recs[0]["losses"]),
        single_losses=",".join(f"{v:.5f}" for v in ref["losses"]),
        max_loss_gap=f"{gap:.6f}", loss_bar=PAR_LOSS_BAR,
        planted_grad_cos=("none" if fault is None
                          else f"{fault['cos']:.6f}"),
        planted_grad_scale=("none" if fault is None else ",".join(
            f"{k}:{v:.6f}" for k, v in fault["scales"].items())),
        planted="none" if not planted else
        "FAIL(expected)" if caught else "PASSED(wrong)")
    same = all(rec["losses"] == recs[0]["losses"] for rec in recs)
    if not (_grad_ok(got) and gap <= PAR_LOSS_BAR and caught and same
            and all(rec["launches_exact"] for rec in recs)):
        raise PhaseError(f"{phase}: the {model} {leg} leg is off the single "
                         f"card (grads {got}, loss gap {gap}, ranks' losses "
                         f"the same {same}), the planted fault not caught "
                         f"({fault}), or off its launches")


def _halves_in_one_process(torch):
    """The single card's vision and text blocks with only their two row
    split sums reordered as --mp 2 orders them: the out-projection and fc2
    run as the head-split kernels' two f32 partials (ranks 0 and 1 of
    ``TensorParallel(2, m)``, in this process) added in f32, then the bias
    and the residual as ``mp_close`` adds them; the backward is the whole
    block's own rule on the whole weights, LN(x)'s cotangent formed in f32
    and rounded once as the head-split rule forms it (``tp`` NO_SPLIT).
    Patches ``fused_attn_block_train``
    and ``fused_mlp_split_train`` / ``fused_mlp_block_train`` of
    ops/block.py until the returned function undoes them."""
    from wise_tpu_torch.ops import block as K
    from wise_tpu_torch.parallel import distributed as TD

    halves = [TD.TensorParallel(2, m) for m in range(2)]

    class Attn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid,
                    causal):
            d, parts, qkvs = x.shape[-1], [], []
            for tp in halves:
                cols = tp.qkv_columns(d, x.device)
                part, qkv = K.fused_attn_partial(
                    x, ln_s, ln_b, wqkv[:, cols].contiguous(),
                    bqkv[cols].contiguous(),
                    wo[tp.columns(d)].contiguous(), heads // 2, n_valid,
                    causal)
                parts.append(part)
                qkvs.append(qkv.chunk(3, -1))
            qkv = torch.cat([torch.cat([q[i] for q in qkvs], -1)
                             for i in range(3)], -1)
            ctx.save_for_backward(x, qkv, ln_s, ln_b, wqkv, wo)
            ctx.static, ctx.tp = (heads, n_valid, causal), TD.NO_SPLIT
            return x + ((parts[0] + parts[1]) + bo.float()).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            return K._AttnBlockTrain.backward(ctx, g)[:10]

    class Mlp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, ln_s, ln_b, wfc, bfc, wproj, bproj, act):
            f, parts, pres = wfc.shape[1], [], []
            for tp in halves:
                c = tp.columns(f)
                part, pre = K.fused_mlp_partial(
                    x, ln_s, ln_b, wfc[:, c].contiguous(),
                    bfc[c].contiguous(), wproj[c].contiguous(), act)
                parts.append(part)
                pres.append(pre)
            ctx.save_for_backward(x, torch.cat(pres, -1), ln_s, ln_b, wfc,
                                  wproj)
            ctx.act, ctx.tp = act, TD.NO_SPLIT
            return x + ((parts[0] + parts[1]) + bproj.float()).to(x.dtype)

        @staticmethod
        def backward(ctx, g):
            return K._MlpBlockTrain.backward(ctx, g)[:8]

    def attn(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid, causal=False):
        return Attn.apply(x, ln_s, ln_b, wqkv, bqkv, wo, bo, heads, n_valid,
                          causal)

    def mlp(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act="gelu"):
        return Mlp.apply(x, ln_s, ln_b, wfc, bfc, wproj, bproj, act)

    saved = {name: getattr(K, name) for name in (
        "fused_attn_block_train", "fused_mlp_split_train",
        "fused_mlp_block_train")}
    K.fused_attn_block_train = attn
    K.fused_mlp_split_train = K.fused_mlp_block_train = mlp
    return lambda: [setattr(K, k, v) for k, v in saved.items()]


def phase_mp_witness(torch, card):
    """How far a reorder of f32 sums alone moves the single card's first
    gradients, for each MP_LEGS leg: the single card's CLI run against the
    same run with its blocks' out-projection and fc2 summed as two f32
    halves (_halves_in_one_process), nothing else changed; printed with the
    bars [mp] holds --mp 2 to, and checked against nothing. The default
    backbone at its whole depth: the floor is widest there."""
    for model, batch in MP_LEGS:
        ref, ref_grads = _single_ref(torch, card, model, batch)
        undo = _halves_in_one_process(torch)
        try:
            rc, recs, _, took, tmp = _recorded_cli(
                torch, model, batch, ["--dp", "1"],
                dict(want={}, ref=str(ref_grads)))
        finally:
            undo()
        tmp.cleanup()
        if rc != 0 or len(recs) != 1:
            raise PhaseError(f"mp_witness: the {model} CLI returned {rc}")
        got = recs[0]["grads"]
        gap = max(abs(a - b) for a, b in zip(recs[0]["losses"],
                                              ref["losses"]))
        say("mp_witness", card=repr(card), model=model, batch=batch,
            cli_s=f"{took:.1f}", whole_tree_grad_cos=f"{got['cos']:.6f}",
            grad_cos=",".join(f"{k}:{v:.6f}"
                              for k, v in got["cos_by"].items()),
            grad_scale=",".join(f"{k}:{v:.6f}"
                                for k, v in got["scales"].items()),
            worst_leaf=f"{got['worst_leaf']:.6f}",
            losses=",".join(f"{v:.5f}" for v in recs[0]["losses"]),
            single_losses=",".join(f"{v:.5f}" for v in ref["losses"]),
            max_loss_gap=f"{gap:.6f}", cos_bar=PAR_COS_BAR,
            scale_bar=PAR_SCALE_BAR, loss_bar=PAR_LOSS_BAR)


def phase_mp(torch, card):
    """Tensor parallelism (see the module docstring): the head-split kernel
    rows, then each MP_LEGS leg through the train CLI at --mp MP_RANKS
    against the single card's run of the same CLI from the same masters and
    batches (_single_ref; [train]'s default-backbone CLI run where it ran);
    ViT-B/32's checkpoint served. Returns (the legs' launches by (wrapper,
    SP, D), summed over the ranks; the rows). The default backbone runs at
    XLMR_TRAIN_DEPTH, as [train]'s run it is held to."""
    rows = []
    for tag, s in MP_SHAPES.items():
        _mp_rows(torch, rows, tag, s)
    _require_rows(rows)
    with _default_backbone_cut():
        return _mp_legs(torch, card), rows


def _mp_legs(torch, card):
    """phase_mp's MP_LEGS legs; their launches by (wrapper, SP, D)."""
    from wise_tpu_torch.cli.train import training_clip_config
    from wise_tpu_torch.models.clip.config import get_clip_config
    from wise_tpu_torch.models.clip.model import CLIP
    from wise_tpu_torch.parallel.train import STATE_FILE

    launches = {}
    for model, batch in MP_LEGS:
        ref, ref_grads = _single_ref(torch, card, model, batch)
        want = _step_launches(training_clip_config(model), MP_RANKS)
        rc, recs, ckpt, took, tmp = _recorded_cli(
            torch, model, batch, ["--mp", str(MP_RANKS)],
            dict(want=want, plant="ln_cotangent", ref=str(ref_grads)))
        # --dp -1: a 'dp' rank for every MP_RANKS cards, at least one
        ranks = max(1, torch.cuda.device_count() // MP_RANKS) * MP_RANKS
        try:
            if rc != 0 or len(recs) != ranks:
                raise PhaseError(f"mp: the {model} CLI at --mp {MP_RANKS} "
                                 f"returned {rc} with {len(recs)} records, "
                                 f"{ranks} expected")
            say("mp", card=repr(card), leg="train_cli", model=model,
                mp=MP_RANKS, batch=batch, cli_s=f"{took:.1f}",
                launches_per_step=json.dumps(want, separators=(",", ":")))
            _check_leg(card, "mp", "mp_train", model, batch, recs, ref)
            for rec in recs:
                for flat, n in rec["by_shape"].items():
                    name, sp, d = flat.split("|")
                    key = (name, int(sp), int(d))
                    launches[key] = launches.get(key, 0) + n
            # the checkpoint: the whole tree in the one-process format
            state = ckpt / f"step_{DP_STEPS:08d}" / STATE_FILE
            params = torch.load(state, map_location="cpu", mmap=True,
                                weights_only=True)["params"]
            with torch.device("meta"):
                whole = CLIP(get_clip_config(model),
                             param_dtype=torch.float32).state_dict()
            off = [k for k, v in whole.items()
                   if k not in params or params[k].shape != v.shape]
            say("mp", card=repr(card), check="checkpoint", model=model,
                tensors=len(params), shapes_off_the_whole_tree=len(off),
                checkpoint_gb=f"{state.stat().st_size / 1e9:.3f}")
            if off or len(params) != len(whole):
                raise PhaseError(f"mp: the --mp checkpoint is not the whole "
                                 f"tree: {off[:5]}")
            if model == "ViT-B-32":
                _serves(torch, card, "mp", ckpt, model, params)
            del params
        finally:
            tmp.cleanup()
    return launches


def phase_pp(torch, card):
    """Pipeline parallelism (see the module docstring): the train CLI at
    --pp PP_STAGES --microbatches PP_MICRO on PP_MODEL (its kernels off, as
    the reference keeps them) against the single card's plain run of the
    CLI from the same masters and batches; the pipeline checkpoint, through
    restore_clip_params, served."""
    from wise_tpu_torch.parallel.pp_train import restore_clip_params
    from wise_tpu_torch.parallel.train import (STATE_FILE,
                                               save_train_checkpoint)

    ref, ref_grads = _single_ref(torch, card, PP_MODEL, PP_BATCH, plain=True)
    rc, recs, ckpt, took, tmp = _recorded_cli(
        torch, PP_MODEL, PP_BATCH,
        ["--pp", str(PP_STAGES), "--microbatches", str(PP_MICRO)],
        dict(want={}, plant="stage_hop", ref=str(ref_grads)))
    # --dp -1: a 'dp' rank (a process) for every PP_STAGES cards
    ranks = max(1, torch.cuda.device_count() // PP_STAGES)
    try:
        if rc != 0 or len(recs) != ranks:
            raise PhaseError(f"pp: the {PP_MODEL} CLI at --pp {PP_STAGES} "
                             f"returned {rc} with {len(recs)} records, "
                             f"{ranks} expected")
        say("pp", card=repr(card), leg="train_cli", model=PP_MODEL,
            pp=PP_STAGES, microbatches=PP_MICRO, batch=PP_BATCH,
            cli_s=f"{took:.1f}")
        _check_leg(card, "pp", "pp_train", PP_MODEL, PP_BATCH, recs, ref)
        pp_tree = torch.load(ckpt / f"step_{DP_STEPS:08d}" / STATE_FILE,
                             map_location="cpu", weights_only=True)["params"]
        params = restore_clip_params(pp_tree)
        served = Path(tmp.name) / "served" / PP_MODEL / "finetuned"
        save_train_checkpoint(served, DP_STEPS, params, {})
        _serves(torch, card, "pp", served, PP_MODEL, params)
    finally:
        tmp.cleanup()


def _index_then_multi(torch, card) -> dict:
    """The index phase on the first card (its server too, on a machine of
    several), then the multi-device phase on its project; the top-k
    wrappers' launches of both (the multi phase's searches counted at the
    index's shape)."""
    with tempfile.TemporaryDirectory(prefix="wise_smoke_index_") as tmp:
        keep = {"root": tmp}
        launches = _timed("index", phase_index, torch, card, keep=keep)
        for key, n in _timed("multi", phase_multi, torch, card,
                             keep).items():
            launches[key] = launches.get(key, 0) + n
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=["all", "kernels", "gemm", "topk",
                                        "swin", "vit_h", "vit_g", "vit_bigg",
                                        "siglip",
                                        "xlmr", "hybrid", "index", "train",
                                        "padded", "embed_fold", "clap2022",
                                        "shots", "profile", "pooled",
                                        "multi", "mp", "pp",
                                        "mp_witness"],
                    default="all")
    ap.add_argument("--parent", action="store_true",
                    help="this script run from the parent commit's "
                         "checkout, to time its pooled kernels (--phase "
                         "pooled): skip what the parent predates")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc -Xptxas -v (registers, shared memory)")
    args = ap.parse_args(argv)

    if not (ROOT / "wise_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: wise_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        card = phase_env(torch, args.verbose_build)
        if args.phase == "profile":
            phase_profile(torch, card)
            profile_image_batch(torch, card)
            profile_xlmr_text(torch, card)
            profile_train_step(torch, card)
            profile_train_step(torch, card, XLMR_MODEL, batch=32)
            return 0
        if args.phase == "gemm":
            rows = []
            _timed("gemm", _gemm_rows, torch, rows)
            _require_rows(rows)
            return 0
        if args.phase == "topk":
            rows = []
            _timed("topk", _topk_rows, torch, rows)
            _require_rows(rows)
            return 0
        if args.phase == "pooled":
            rows = []
            _timed("pooled", _pooled_phase, torch, rows, args.parent)
            _require_rows(rows)
            return 0
        if args.phase == "swin":
            rows = []
            _timed("swin", _swin_rows, torch, rows)
            _require_rows(rows)
            phase_profile(torch, card)
            return 0
        if args.phase == "vit_h":
            phase_slice(torch, card, VIT_H_ID, VIT_H_FRAMES, "vit_h",
                        topk_1m=False, hybrid_frames=64)
            return 0
        if args.phase in ("vit_g", "vit_bigg"):
            model_id = VIT_G_ID if args.phase == "vit_g" else VIT_BIGG_ID
            _timed(args.phase, phase_wide, torch, card, model_id, args.phase)
            profile_image_batch(torch, card, model_id=model_id)
            return 0
        if args.phase == "siglip":
            _timed("siglip", phase_siglip, torch, card)
            profile_image_batch(torch, card, model_id=SIGLIP_ID)
            return 0
        if args.phase == "xlmr":
            phase_slice(torch, card, XLMR_ID, XLMR_FRAMES, "xlmr",
                        topk_1m=False)
            return 0
        if args.phase == "hybrid":
            phase_hybrid(torch, card)
            return 0
        if args.phase == "index":
            _timed("index", phase_index, torch, card)
            return 0
        if args.phase == "multi":
            _index_then_multi(torch, card)
            return 0
        if args.phase == "train":
            _timed("train", phase_train, torch, card)
            return 0
        if args.phase == "mp":
            _timed("mp", phase_mp, torch, card)
            return 0
        if args.phase == "pp":
            _timed("pp", phase_pp, torch, card)
            return 0
        if args.phase == "mp_witness":
            _timed("mp_witness", phase_mp_witness, torch, card)
            return 0
        if args.phase == "padded":
            _timed("padded", phase_padded, torch, card)
            return 0
        if args.phase == "embed_fold":
            _timed("embed_fold", phase_embed_fold, torch, card)
            return 0
        if args.phase == "clap2022":
            _timed("clap2022", phase_clap2022, torch, card)
            return 0
        if args.phase == "shots":
            _timed("shots", phase_shots, torch, card)
            return 0
        kernels, alone = _timed("kernels", phase_kernels, torch)
        if args.phase == "kernels":
            return 0
        launches = _timed("slice", phase_slice, torch, card)
        launches.update(_timed("audio", phase_audio, torch, card))
        launches.update(_timed("families", phase_families, torch, card))
        launches.update(_timed("siglip", phase_siglip, torch, card))
        launches.update(_timed(
            "vit_h", phase_slice, torch, card, VIT_H_ID, VIT_H_FRAMES,
            "vit_h", topk_1m=False, hybrid_frames=64))
        for phase, model_id in (("vit_g", VIT_G_ID),
                                ("vit_bigg", VIT_BIGG_ID)):
            launches.update(_timed(phase, phase_wide, torch, card, model_id,
                                   phase))
            torch.cuda.empty_cache()
        launches.update(_timed(
            "xlmr", phase_slice, torch, card, XLMR_ID, XLMR_FRAMES, "xlmr",
            topk_1m=False))
        launches.update(_timed("hybrid", phase_hybrid, torch, card))
        for key, n in _index_then_multi(torch, card).items():
            launches[key] = launches.get(key, 0) + n
        # the training steps' counts stand beside the serve paths': a key
        # both reach (the pooled kernels at ViT-B/32) keeps its serve count
        for key, n in _timed("train", phase_train, torch, card).items():
            launches.setdefault(key, n)
        # tensor and pipeline parallelism: the head-split rows join the
        # kernels phase's, counted on the [mp] path
        counts, rows = _timed("mp", phase_mp, torch, card)
        for key, n in counts.items():
            launches.setdefault(key, n)
        kernels += rows
        _timed("pp", phase_pp, torch, card)
        # the padded-head block and the embed fold, each on its own path;
        # their rows join the kernels phase's
        for phase, fn in (("padded", phase_padded),
                          ("embed_fold", phase_embed_fold)):
            counts, rows = _timed(phase, fn, torch, card)
            for key, n in counts.items():
                launches.setdefault(key, n)
            kernels += rows
        # msclap 2022 and shot detection: plain PyTorch paths, no kernel of
        # the rows above
        _timed("clap2022", phase_clap2022, torch, card)
        _timed("shots", phase_shots, torch, card)
        # a top-k row at WIDE_D (key N_pad None) counts its wrapper's
        # launches at that width on the paths, whatever their rows
        for r in kernels:
            name, n_pad, d = r["key"][:3]
            if name.startswith("fused_topk") and n_pad is None:
                launches[r["key"]] = sum(
                    c for key, c in list(launches.items())
                    if key[0] == name and key[1] is not None
                    and key[2] == d)
        for r in alone:
            n = sum(launches.get((name, r["sp"], r["d"]), 0)
                    for name in r["via"])
            say("kernels", alone=f"{r['name']}[{r['tag']}]",
                launches_on_path=f"{n * r['per_call']:g}",
                counted_from=",".join(r["via"]))
        off = {r["key"]: _off_path(r["key"]) for r in kernels
               if _off_path(r["key"])}
        stray = [_launch_name(key) for key in off if launches.get(key)]
        if stray:
            raise PhaseError(f"launched against the port's own choice of "
                             f"variant: {stray}")
        idle = [f"{r['name']}[{r['tag']}]" for r in kernels
                if r["key"] not in off and not launches.get(r["key"])]
        if idle:
            raise PhaseError(f"not launched on the path at the shape "
                             f"checked: {idle}")
        for key in sorted(off):
            say("kernels", off_path=_launch_name(key), launches=0,
                reason=repr(off[key]))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    def row(r):
        return {"name": f"{r['name']}[{r['tag']}]", "route": "cuda",
                "source": r.get("source", KERNELS[r["name"]][0]),
                "replaces": KERNELS[r["name"]][1],
                "launches": launches.get(r["key"], 0),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    # "kernels": the kernels of the paths, each launched there; "off_path":
    # the rows no path launches at their shape (_off_path), held in the
    # kernels phase
    print(card)
    print(json.dumps({
        "kernels": [row(r) for r in kernels if r["key"] not in off],
        "off_path": [row(r) for r in kernels if r["key"] in off]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training on the card (wise_tpu/parallel/): the single-device CLIP
trainer. The mesh, the sharded search and the pipeline-parallel trainer are
multi-device and wait for ROADMAP Queue A item 12."""

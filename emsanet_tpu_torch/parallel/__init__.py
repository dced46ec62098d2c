"""Data parallelism over a `torch.distributed` process group
(counterpart: `emsanet_tpu/parallel/`)."""

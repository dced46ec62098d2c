"""Training of the port: losses per task, the train step, optimizers and
the learning-rate schedule (counterpart: `emsanet_tpu/training/`)."""

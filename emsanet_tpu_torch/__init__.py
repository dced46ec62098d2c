"""EMSANet in PyTorch for one NVIDIA H100: the port of `emsanet_tpu`.

The inference frame (device prep -> dual R34-NBt1D encoder -> PPM ->
semantic/instance decoders + scene head -> postprocessing), the trainer
with validation and checkpoints (`train.py`), and the hand-written CUDA
kernels of every Pallas kernel of the JAX package (`csrc/`). The JAX
package stays the reference; this package imports nothing of it.
"""

from emsanet_tpu_torch.config import ModelConfig, flagship_config

__all__ = ["ModelConfig", "flagship_config"]

"""Plain PyTorch references of the benchmark's configurations.

Nothing here imports the program under test (`emsanet_tpu_torch`), JAX
or the JAX package: the reference reads only the weights and inputs that
the benchmark makes, and works out again whatever the program derives
from them.
"""

"""Upstream PyTorch EMSANet checkpoints: the key map onto the port's
`state_dict` (`name_map.py`); the import tool is
`emsanet_tpu_torch/import_torch_checkpoint.py`."""

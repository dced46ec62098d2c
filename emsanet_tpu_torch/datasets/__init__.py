"""Datasets of the port: metadata, the synthetic dataset, prepared
datasets on disk, their PNG reader and packer, and the registry."""

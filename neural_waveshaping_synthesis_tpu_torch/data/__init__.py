"""Datasets of the port: the reference's ``.npy`` shard layout."""
from .general import GeneralDataModule, GeneralDataset

__all__ = ["GeneralDataModule", "GeneralDataset"]

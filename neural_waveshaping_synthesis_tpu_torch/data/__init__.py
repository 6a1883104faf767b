"""Datasets of the port: the reference's ``.npy`` shard layout, and one
URMP instrument's shards."""
from .general import GeneralDataModule, GeneralDataset
from .urmp import URMP_INSTRUMENTS, URMPDataModule

__all__ = ["GeneralDataModule", "GeneralDataset", "URMP_INSTRUMENTS", "URMPDataModule"]

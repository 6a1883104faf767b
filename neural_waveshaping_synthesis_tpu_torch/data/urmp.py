"""URMP dataset wiring (counterpart of the JAX ``data/urmp.py``): one
instrument's shards under ``<urmp_root>/<instrument>``."""
import os

from .. import minigin as gin
from .general import GeneralDataModule

# The 12 URMP instrument codes the reference preprocesses
# (scripts/create_urmp_dataset.py:10-23).
URMP_INSTRUMENTS = (
    "vn", "va", "vc", "db", "fl", "ob", "cl", "sax", "bn", "tpt", "hn", "tbn",
)


@gin.configurable
class URMPDataModule(GeneralDataModule):
    """Per-instrument datamodule: ``root/<instrument>/{train,val,test}``."""

    def __init__(self, urmp_root: str, instrument: str, batch_size: int = 16,
                 load_to_memory: bool = True):
        # by keyword: GeneralDataModule is configurable too, so a
        # ``GeneralDataModule.batch_size`` binding arrives as a keyword and
        # would collide with a positional batch_size; the explicit value
        # (this module's, bound or default) wins over that binding
        super().__init__(os.path.join(urmp_root, instrument), batch_size=batch_size,
                         load_to_memory=load_to_memory)
        self.instrument = instrument

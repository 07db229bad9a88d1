"""Port of ``src/repro/compression/``: the codec stages of the wire stack
(the qsgd payload codec and the lossless byte-domain codecs; top-k comes
with its kernel in a later slice)."""
from repro_torch.compression.qsgd import (QuantState, qsgd_compress,
                                          qsgd_decompress, qsgd_init)

__all__ = ["qsgd_init", "qsgd_compress", "qsgd_decompress", "QuantState"]

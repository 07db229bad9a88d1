"""Port of ``src/repro/compression/``: the codec stages of the wire stack
(the qsgd and top-k payload codecs and the lossless byte-domain
codecs)."""
from repro_torch.compression.qsgd import (QuantState, qsgd_compress,
                                          qsgd_decompress, qsgd_init)
from repro_torch.compression.topk import topk_compress, topk_decompress

__all__ = ["qsgd_init", "qsgd_compress", "qsgd_decompress", "QuantState",
           "topk_compress", "topk_decompress"]

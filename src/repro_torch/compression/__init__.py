"""Port of ``src/repro/compression/``: the codec stages of the wire stack
(this slice carries the lossless byte-domain codecs)."""

"""Synchronised host ms per client update in the payload codec, compress
plus decompress (``compression/stages.py``: top-k or qsgd), over the
updates compressed."""


def read(run):
    n = run.counts.get("codec_updates", 0)
    return run.spans.get("codec", 0.0) / n * 1e3 if n else None

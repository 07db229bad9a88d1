"""Synchronised host ms per message received in the wire's serialize and
byte-codec stages, encode plus decode (``BaseSerializer.serialize``,
``decode_wire``, ``WireCompressStage.compress``,
``ZlibCodec.decompress_wire``), over the messages decoded."""


def read(run):
    n = run.counts.get("wire_messages", 0)
    return run.spans.get("wire", 0.0) / n * 1e3 if n else None

"""Port of ``src/repro/launch/``: the FL training driver."""

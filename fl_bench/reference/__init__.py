"""The plain reference the benchmark holds the port against: the vision
models, local SGD, the two payload codecs, FedAvg and the server merge,
in plain PyTorch. It imports nothing of the port and takes nothing the
port made: the benchmark hands both sides the same seeded data and
initial weights, and the reference reads the port's outputs only to
judge them."""

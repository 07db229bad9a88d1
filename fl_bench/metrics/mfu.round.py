"""The round's share of the card's dense bf16 peak: model FLOPs of every
local step completed (counted once at set-up from shapes by
``FlopCounterMode``) over the seconds, against 989 TFLOP/s. The bf16
peak bounds the share whatever precision the steps run in."""
from fl_bench import counts


def read(run):
    n = run.counts.get("train_steps", 0)
    if run.card is None or not n or run.window_s <= 0:
        return None
    return (n * run.flops_per_step / run.window_s
            / counts.PEAK_BF16_FLOPS * 100.0)

"""The whole step's share of the card's peak: model operations of the
prompt and decode tokens done in the window (from shapes, the cell's
family's ``span_flops``) over the window's seconds times the dense bf16
peak."""
from perfbench import roofline


def read(run):
    w = run["window"]
    if w["seconds"] <= 0 or w["flops"] <= 0:
        return None
    return 100.0 * w["flops"] / (w["seconds"] * roofline.PEAK_BF16_FLOPS)

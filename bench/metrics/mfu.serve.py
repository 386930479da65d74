"""Model operations of the window's served work (the configuration's own
count of each prompt whose first token came in the window and of each
other token decoded in it) over the window's seconds at the card's dense
TF32 peak."""
from harness.peaks import TF32_FLOPS


def read(run):
    if run.get("kind") != "serve" or not run.get("window_flops"):
        return None
    return 100.0 * run["window_flops"] / (run["seconds"] * TF32_FLOPS)

"""Model operations of the window's committed training steps (the
configuration's own count: six times the active parameters a token,
causal attention three times its forward, nothing recomputed) over the
window's seconds at the card's dense TF32 peak."""
from harness.peaks import TF32_FLOPS


def read(run):
    if run.get("kind") != "train" or not run.get("ok_steps"):
        return None
    flops = run["flops_per_step"] * run["ok_steps"]
    return 100.0 * flops / (run["seconds"] * TF32_FLOPS)

"""95th percentile of the host's clock around each ``ServeEngine.step()``
of the window: admission and prefill when a request arrives, then one
decode step of the model over every slot."""
from harness.core import percentile


def read(run):
    if run.get("kind") != "serve" or not run.get("step_ms"):
        return None
    return percentile(run["step_ms"], 95)

"""Share of the window's training steps whose outcome is not ``OK``
(``SKIPPED``, ``ROLLED_BACK``, ``HALTED``), from the supervisor's step
records: steps the trainer paid for and did not commit."""


def read(run):
    if run.get("kind") != "train" or not run.get("outcomes"):
        return None
    bad = sum(o != "ok" for o in run["outcomes"])
    return 100.0 * bad / len(run["outcomes"])

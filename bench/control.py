"""The readings that a cell's limits are set from, apart from the sound
runs of the program (which every run of ``run.py`` prints): the control,
the plain reference computed in the next precision below the one the
configuration states, and the planted faults of a training cell, each
read against the reference at the cell's own size.

    python3 bench/control.py --workload granite_train_dfxp --seeds 1,2,3

The benchmark's own runs never run this.  ``bench/tests`` runs the same
functions at smoke size on the CPU.

* training: the reference with its products at DFXP 8 in place of 10,
  and the reference fed half of each followed step's rows, each compared
  with the sound reference by the cell's own comparison;
* serving: the reference's own greedy tokens on a sample of the mix's
  requests; at each of their positions, the token that the reference at
  DFXP 8 puts first, that the reference whose decode step keeps the
  state it was given (conv window and SSM state) puts first, and the served token plus one, each
  read as how far its logit lies below the DFXP 10 reference's best.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
LOWER_WIDTH = 8          # the step below DFXP 10 that would tempt: int8


def train_readings(cell, seed: int, device: str, smoke: bool = False):
    import torch
    from harness import core, traffic as tr
    t = core.mix_params(cell, smoke)
    model = cell.model()
    S = model.sizes(cell.config, smoke)
    B = int(t["batch"])
    n_cal, n = int(t["calibrate_steps"]), int(t["followed_steps"])

    def rows(stream, i):
        return tr.lm_batch(torch, t, S["published_vocab_size"], seed,
                           stream, i, device)

    batches = {"calibrate": [rows("calibrate", i) for i in range(n_cal)],
               "train": [rows("train", i) for i in range(n)]}
    compare = cell.driver().compare

    def ref(b, width=None):
        return model.train_reference(S, seed, b, t["optimizer"], t["policy"],
                                     n, device, comp_width=width)

    sound = ref(batches)
    half = {"calibrate": batches["calibrate"],
            "train": [{k: v[:B // 2] for k, v in b.items()}
                      for b in batches["train"]]}
    out = {}
    for name, run in (("control_dfxp8", ref(batches, LOWER_WIDTH)),
                      ("fault_half_batch", ref(half))):
        checks, info = compare(run, sound, cell.limits)
        out[name] = {k: c["value"] for k, c in checks.items()}
        out[name]["worst_leaves"] = [info["grad_worst_leaf"],
                                     info["update_worst_leaf"]]
    return out


def serve_readings(cell, seed: int, device: str, smoke: bool = False):
    import torch
    from harness import core, traffic as tr
    t = core.mix_params(cell, smoke)
    model = cell.model()
    S = model.sizes(cell.config, smoke)
    plan = tr.chat_plan(t, S["published_vocab_size"], seed)
    w = model.make_weights(S, seed, device)
    ref = model.Reference(w, S, t["policy"])
    low = model.Reference(w, S, t["policy"], comp_width=LOWER_WIDTH)
    frozen = model.Reference(w, S, t["policy"], carry_state=False)
    widest, tokens = {"control_dfxp8": 0.0, "fault_frozen_state": 0.0,
                      "fault_token": 0.0}, 0
    for c in range(len(plan)):
        if tokens >= int(t["check_tokens"]):
            break
        r = plan[c][1]
        lg, carry = ref.prompt(torch.as_tensor(r["prompt"], device=device))
        served = [int(lg.argmax())]
        while len(served) < r["max_new"]:
            lg, carry = ref.step(served[-1], carry)
            served.append(int(lg.argmax()))
        full = ref.logits(r["prompt"], served)
        V = full.shape[-1]
        for name, toks in (
                ("control_dfxp8", low.logits(r["prompt"], served).argmax(-1)),
                ("fault_frozen_state",
                 frozen.logits(r["prompt"], served).argmax(-1)),
                ("fault_token", (torch.as_tensor(served) + 1) % V)):
            g = float(model.gaps(full, toks).max())
            widest[name] = max(widest[name], g)
        tokens += len(served)
    return {name: {"logit_gap": g, "tokens": tokens}
            for name, g in widest.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from harness import core
    import torch
    cell = core.Cell(core.load_spec(ROOT), args.workload, ROOT)
    kind = cell.traffic["driver"]
    read = train_readings if kind == "train" else serve_readings
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        res = read(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "card": torch.cuda.get_device_name(0), **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

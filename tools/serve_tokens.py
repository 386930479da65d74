"""The tokens the port's server generates on one NVIDIA card, as digests,
so that two trees of the port can be compared token for token.

    PYTHONPATH=src python tools/serve_tokens.py

Two runs of ``repro_torch.launch.serve`` at llama3-8B's full width on
random weights from seed 0 (``chip_smoke.py``'s serving arguments: 6
requests of 96/200/384 tokens, 4 slots, 16 new tokens each, DFXP-10,
int8 KV, fused decode): chunked prefill over the slot-major pool (K3, K4)
and over the paged pool with 64-row pages (K5, K6).  For each run it
prints the requests' statuses, the SHA-1 of their greedy tokens in
request order and the tokens, and, for every call of the engine's
sampler in order, each row's argmax and the gap between its two largest
logits: where two trees' tokens part, the first call whose argmaxes
differ shows how near that choice was to a tie.  Through the entry point
(and the engine's sampler, watched) only, so it also runs on an older
tree of the port.  The card's name and power limit come first.  Imports
no JAX.
"""
import hashlib
import json
import subprocess

import numpy as np
import torch

from repro_torch.launch import serve
from repro_torch.serve import ServeEngine

ARGS = ["--arch", "llama3_8b", "--num-requests", "6", "--slots", "4",
        "--prompt-len", "96,200,384", "--max-new", "16", "--cache-bits",
        "8", "--fused-decode"]


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    calls = []
    sample = ServeEngine._sample

    def watched(self, logits):
        top = torch.topk(logits.reshape(-1, logits.shape[-1]).float(), 2)
        calls.append([top.indices[:, 0].tolist(),
                      (top.values[:, 0] - top.values[:, 1]).tolist()])
        return sample(self, logits)
    ServeEngine._sample = watched
    for tag, extra in (("slot-major", ["--prefill-chunk", "128"]),
                       ("paged", ["--page-size", "64"])):
        calls.clear()
        eng = serve.main(ARGS + extra)
        ids = sorted(eng.results)
        toks = [np.asarray(eng.results[i], np.int64) for i in ids]
        digest = hashlib.sha1(b"".join(t.tobytes() for t in toks))
        print(f"tokens {tag}: " + json.dumps({
            "statuses": [eng.statuses[i].value for i in ids],
            "sha1": digest.hexdigest(), "tokens": [t.tolist() for t in toks]}),
            flush=True)
        print(f"sampler calls {tag}: " + json.dumps(calls), flush=True)
        del eng
    ServeEngine._sample = sample


if __name__ == "__main__":
    main()

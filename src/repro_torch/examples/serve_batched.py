"""Continuous-batching serving with mixed-length prompts + int8 KV cache —
the reference's example (``examples/serve_batched.py``) on the card:

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --device cpu

Six requests with three different prompt lengths share four slots of
llama3-smoke under DFXP.  The first run prefills whole prompts (equal
lengths grouped, the rest queue until a decoding slot frees); the second
prefills in 8-token chunks through the flash kernels
(``--prefill-chunk 8 --fused-decode``): every request admits at once and
one chunk runs per engine step interleaved with decode, its K/V
quantized straight into the int8 pool.  Under DFXP the two paths are
numerics-equivalent, not token-identical (the activation quantizer
re-rounds reordered float ops); under ``--arithmetic float32`` their
greedy streams are identical.  The argv is the reference's, through
:func:`repro_torch.launch.serve.main`.
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)
    serve_args = ["--arch", "llama3_8b", "--smoke", "--arithmetic", "dfxp",
                  "--num-requests", "6", "--slots", "4",
                  "--prompt-len", "8,16,32", "--max-new", "16",
                  "--cache-bits", "8", "--device", args.device]
    whole = serve_main(serve_args)
    chunked = serve_main(serve_args + ["--prefill-chunk", "8",
                                       "--fused-decode"])
    return whole, chunked


if __name__ == "__main__":
    main()

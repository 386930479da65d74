"""The port's trainer CLI (``repro_torch.launch.train``) on the CPU.

Subprocesses at the llama3 smoke config (the CLI installs signal
handlers, which work in a main thread only):

  * the train-resume check of the reference's CI on the port: a run
    killed by ``--kill-at 5`` exits 137, and the rerun without the kill
    resumes and ends with the solo run's ``final_loss``, bit for bit,
    and its checkpoint's leaves;
  * SIGTERM mid-run: exit 143 after a synchronous final checkpoint;
  * ``--resume must`` on an empty directory exits 2;
  * the reference's launcher and the port's at one argv print the same
    group count and step-1 and step-2 losses (4 decimals, 1e-4: from
    the first flipped rounding tie on, the two free-running DFXP runs
    part, as any two implementations do);
  * the unported options raise, naming their ROADMAP items.

As a script, the reference's launcher on the CPU at the example's
LM_100M recipe (``examples/train_lm.py``: adamw lr 3e-3, batch 16, seq
128, 20 steps, losses at every step), float32 and DFXP 10/12 with two
calibration steps — the numbers ``chip_smoke.py`` holds the card to
(``REF_LM``) — and with ``--port`` the port's launcher on the CPU at the
same argv plus ``--fused-matmul`` (K2's plain version), as the card runs
it::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_launch_train.py
    PYTHONPATH=src python tests/test_torch_launch_train.py --port

It prints each row's group count and losses, and last a JSON line of
them.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "llama3_8b", "--smoke", "--global-batch", "4",
         "--seq-len", "32", "--arithmetic", "dfxp", "--calibrate-steps", "2",
         "--log-every", "1", "--device", "cpu"]

LM_ARGV = ["--arch", "lm_100m", "--global-batch", "16", "--seq-len", "128",
           "--comp-width", "10", "--update-width", "12",
           "--update-interval", "20", "--optimizer", "adamw", "--lr", "3e-3",
           "--log-every", "1"]
LM_ROWS = {"float32": ["--arithmetic", "float32", "--calibrate-steps", "0"],
           "dfxp": ["--arithmetic", "dfxp", "--calibrate-steps", "2"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small tensors: the suite runs
    several test processes at once, and torch's thread pools in each of
    them would otherwise wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def parse_run(text: str) -> dict:
    """Group count and per-step losses from a launcher's output."""
    m = re.search(r"calibrated (\d+) scale groups", text)
    losses = {int(s): float(v) for s, v in
              re.findall(r"^step (\d+): loss=([-\d.naninf]+)$", text, re.M)}
    return {"groups": int(m.group(1)) if m else None, "losses": losses}


def lm_rows(port: bool, steps: int = 20) -> dict:
    if port:
        from repro_torch.examples import train_lm
        from repro_torch.launch import train
        train_lm.register()
        extra_argv = ["--fused-matmul", "--device", "cpu"]
    else:
        from repro.launch import train
        from repro.models.transformer import ModelConfig
        cfg = ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=512,
            num_heads=8, num_kv_heads=4, head_dim=64, d_ff=2048,
            vocab_size=32768, tie_embeddings=True)
        sys.modules["repro.configs.lm_100m"] = types.SimpleNamespace(
            CONFIG=cfg, SMOKE=cfg, CELLS=("train_4k",))
        extra_argv = []
    out = {}
    for row, extra in LM_ROWS.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(LM_ARGV + ["--steps", str(steps)] + extra
                       + extra_argv)
        out[row] = parse_run(buf.getvalue())
        print(row, out[row]["groups"], out[row]["losses"], flush=True)
    return out


def _env():
    # one thread a process: the smoke model is tiny, and the test
    # processes share the machine with the rest of the suite
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _cli(args, **kw):
    env = _env()
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def _summary(text: str) -> dict:
    line = [ln for ln in text.splitlines() if ln.startswith("summary: ")][-1]
    return json.loads(line[len("summary: "):])


def _ckpt_leaves(d):
    step = max(int(n.split("_")[1]) for n in os.listdir(d)
               if n.startswith("step_") and os.path.exists(
                   os.path.join(d, n, "_COMMITTED")))
    path = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    return step, {m["name"]: np.load(os.path.join(path, m["file"]))
                  for m in leaves}


def test_kill_and_resume_match_the_solo_run(tmp_path):
    """The reference CI's argv (no calibration, controller interval 4)."""
    argv = SMOKE + ["--steps", "8", "--ckpt-every", "2", "--calibrate-steps",
                    "0", "--update-interval", "4"]
    solo = _cli(argv + ["--ckpt-dir", str(tmp_path / "solo")])
    assert solo.returncode == 0, solo.stderr
    killed = _cli(argv + ["--ckpt-dir", str(tmp_path / "ck"),
                          "--kill-at", "5"])
    assert killed.returncode == -signal.SIGKILL, killed.stderr
    resumed = _cli(argv + ["--ckpt-dir", str(tmp_path / "ck")])
    assert resumed.returncode == 0, resumed.stderr
    # the kill may land while the cursor-4 save is still in flight: the
    # resume is from 4 or from 2 (waited for when 4's save began)
    assert re.search(r"^resumed from cursor [24]$", resumed.stdout, re.M)
    want, got = _summary(solo.stdout), _summary(resumed.stdout)
    assert got["final_loss"] == want["final_loss"]
    assert got["steps_committed"] == want["steps_committed"] == 8
    (s1, a), (s2, b) = (_ckpt_leaves(str(tmp_path / "solo")),
                        _ckpt_leaves(str(tmp_path / "ck")))
    assert s1 == s2 == 8 and a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_sigterm_writes_a_final_checkpoint_and_exits_143(tmp_path):
    env = _env()
    ck = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *SMOKE,
         "--calibrate-steps", "0", "--steps", "1000", "--ckpt-every",
         "1000", "--ckpt-dir", str(ck)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for line in proc.stdout:
            if line.startswith("step 2:"):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 143, err
    assert "preempted at cursor" in out
    step, _ = _ckpt_leaves(str(ck))
    assert 2 <= step < 1000


def test_resume_must_without_a_checkpoint_exits_2(tmp_path):
    r = _cli(SMOKE + ["--steps", "2", "--calibrate-steps", "0",
                      "--ckpt-dir", str(tmp_path / "empty"),
                      "--resume", "must"])
    assert r.returncode == 2, r.stderr
    assert "nothing restorable" in r.stderr


def test_launchers_agree_at_one_argv():
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    argv = SMOKE[:-2] + ["--steps", "2"]
    runs = []
    for main, extra in ((jtrain.main, []), (ttrain.main, SMOKE[-2:])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + extra)
        runs.append(parse_run(buf.getvalue()))
    ref, port = runs
    assert port["groups"] == ref["groups"] == 65
    assert sorted(port["losses"]) == sorted(ref["losses"]) == [1, 2]
    for s in (1, 2):
        assert abs(port["losses"][s] - ref["losses"][s]) <= 1e-4


def test_example_argv_is_the_reference_s(monkeypatch):
    """``repro_torch.examples.train_lm`` passes the reference example's
    argv (``examples/train_lm.py``), plus ``--device``, and registers the
    same LM_100M."""
    import importlib.util

    from repro_torch.examples import train_lm as tex
    spec = importlib.util.spec_from_file_location(
        "reference_train_lm", ROOT / "examples" / "train_lm.py")
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    seen = {}
    monkeypatch.setattr(jex, "train_main", lambda a: seen.update(ref=a))
    monkeypatch.setattr(tex, "train_main", lambda a: seen.update(port=a))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--ckpt-dir", "D"])
    jex.main()
    tex.main(["--ckpt-dir", "D"])
    assert seen["port"] == seen["ref"] + ["--device", "cuda"]
    assert dataclasses.asdict(tex.LM_100M) == {
        k: v for k, v in dataclasses.asdict(jex.LM_100M).items()
        if k in dataclasses.asdict(tex.LM_100M)}
    from repro_torch import configs
    assert configs.get("lm_100m") is tex.LM_100M
    with pytest.raises(ValueError, match="item 21"):
        configs.get("granite_moe_1b")


@pytest.mark.parametrize("flag,item", [(["--grad-compress-bits", "8"], 22),
                                       (["--numerics-log", "x.jsonl"], 19)])
def test_unported_options_raise(flag, item):
    from repro_torch.launch import train as ttrain
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ttrain.main(SMOKE + ["--steps", "1"] + flag)


if __name__ == "__main__":
    print(json.dumps(lm_rows(port="--port" in sys.argv)))

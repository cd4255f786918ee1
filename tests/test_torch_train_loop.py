"""The port's train loop (``repro_torch.train.loop``) and train launcher
(``repro_torch.launch.train``), on the CPU.

* The port's copies of the 5 cases of ``tests/test_train_loop.py``, with the
  reference's plain ``step_fn(state, batch) -> (new state, metrics)``.
* The NaN guard over ``make_train_step``'s in-place step: a non-finite loss
  leaves every tensor of the state untouched (the loop runs ``step.grads``,
  tests the loss, and only then ``step.update``), so a run with two poisoned
  batches ends byte-equal to a run that never saw them.
* Auto-resume over a real train state: a run cut at a checkpoint and resumed
  (into a fresh draw's tensors, in place; ``final_save=False``) ends
  byte-equal to one run straight through.
* ``python -m repro_torch.launch.train --device cpu`` in a subprocess,
  SIGKILLed after its first checkpoint and run again: the resumed losses in
  ``--metrics`` bit-equal to an uninterrupted run's at the same steps; the
  same for the LM preset (``--preset lm100m``, shrunk as
  ``examples/train_lm_torch.py`` shrinks it), and an LM ``--arch``.
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.checkpoint import flatten, latest_step
from repro_torch.train.loop import TrainLoop, TrainLoopConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counting_step(state, batch):
    return state + 1, {"loss": torch.tensor(1.0 / (float(state) + 1.0))}


def test_runs_to_total_and_checkpoints(tmp_path):
    loop = TrainLoop(_counting_step, lambda s: None,
                     TrainLoopConfig(total_steps=17, checkpoint_dir=str(tmp_path),
                                     checkpoint_every=5, log_every=5))
    st, end = loop.run(0)
    assert end == 17 and int(st) == 17
    assert latest_step(str(tmp_path)) == 17


def test_auto_resume_continues(tmp_path):
    cfg = TrainLoopConfig(total_steps=10, checkpoint_dir=str(tmp_path), checkpoint_every=5)
    TrainLoop(_counting_step, lambda s: None, cfg).run(0)
    # "crash" happened; a new process resumes from step 10 and trains to 20
    cfg2 = TrainLoopConfig(total_steps=20, checkpoint_dir=str(tmp_path), checkpoint_every=5)
    loop2 = TrainLoop(_counting_step, lambda s: None, cfg2)
    st, end = loop2.run(0)
    assert end == 20 and int(st) == 20
    # it did NOT replay steps 0-9
    assert len(loop2.history) <= 4


def test_nan_guard_skips_then_aborts(tmp_path):
    calls = {"n": 0}

    def sometimes_nan(state, batch):
        calls["n"] += 1
        bad = calls["n"] in (3, 4)  # two isolated bad steps -> recovered
        return state + 1, {"loss": torch.tensor(float("nan") if bad else 1.0)}

    loop = TrainLoop(sometimes_nan, lambda s: None,
                     TrainLoopConfig(total_steps=10, max_bad_steps=3))
    st, end = loop.run(0)
    assert end == 10
    assert int(st) == 8  # two updates skipped

    def always_nan(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    loop2 = TrainLoop(always_nan, lambda s: None,
                      TrainLoopConfig(total_steps=100, max_bad_steps=4,
                                      checkpoint_dir=str(tmp_path)))
    with pytest.raises(FloatingPointError):
        loop2.run(0)
    # a rescue checkpoint was written before aborting
    assert latest_step(str(tmp_path)) is not None


def test_straggler_detection():
    def slow_every_7(state, batch):
        time.sleep(0.08 if int(state) % 7 == 6 else 0.002)
        return state + 1, {"loss": torch.tensor(1.0)}

    loop = TrainLoop(slow_every_7, lambda s: None,
                     TrainLoopConfig(total_steps=21, straggler_factor=5.0, straggler_warmup=3))
    loop.run(0)
    assert len(loop.quarantine) >= 1
    assert all(q["dt"] > 5.0 * q["ewma"] for q in loop.quarantine)


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    loop = TrainLoop(_counting_step, lambda s: None,
                     TrainLoopConfig(total_steps=10, log_every=2, metrics_path=path))
    loop.run(0)
    recs = [json.loads(line) for line in open(path)]
    assert len(recs) >= 5
    assert all("loss" in r and "step" in r for r in recs)


# -- the in-place step ---------------------------------------------------------


def _dlrm_step(poison=()):
    """DLRM's smoke step, its loss made NaN on the batches of ``poison``."""
    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")]))
    base, baxes = ST.recsys_loss("dlrm-rm2", cfg)

    def loss(values, batch):
        l, m = base(values, batch)
        if int(batch["step"][0]) in poison:
            l = l * float("nan")
        return l, dict(m, loss=l)

    step, _, _, opt = ST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                         ST.StepConfig(peak_lr=5e-3, warmup_steps=2))
    state = ST.init_state(opt, arch.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))

    def batch_fn(i):
        return dict(recsys_batch("dlrm-rm2", 32, cfg, step=i), step=torch.tensor([i]))

    return step, state, batch_fn


def _bytes(state):
    return [t.clone() if isinstance(t, torch.Tensor) else t for t in flatten(state)]


def test_nan_guard_leaves_the_in_place_state_untouched():
    step, state, batch_fn = _dlrm_step(poison=(3, 4))
    loop = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=7, max_bad_steps=3, log_every=1))
    got, end = loop.run(state)
    assert end == 7 and [h.get("skipped", 0) for h in loop.history].count(1) == 2
    assert got.opt.step == 5  # two of seven updates skipped

    # The same run with the poisoned batches left out, step by step.
    step2, want, batch_fn2 = _dlrm_step()
    for i in (0, 1, 2, 5, 6):
        want, _ = step2(want, batch_fn2(i))
    for a, b in zip(_bytes(got), _bytes(want)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


def test_resumed_run_is_byte_equal_to_a_straight_run(tmp_path):
    step, state, batch_fn = _dlrm_step()
    straight, _ = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=8)).run(state)
    want = _bytes(straight)

    step, state, batch_fn = _dlrm_step()
    cfg = dict(checkpoint_dir=str(tmp_path), checkpoint_every=5, keep_checkpoints=2)
    TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=5, **cfg)).run(state)
    assert latest_step(str(tmp_path)) == 5
    step, like, batch_fn = _dlrm_step()  # a fresh draw, overwritten by the restore
    ptrs = [t.data_ptr() for t in flatten(like) if isinstance(t, torch.Tensor)]
    loop = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=8, final_save=False, log_every=1,
                                                     **cfg))
    got, end = loop.run(like)
    assert end == 8 and len(loop.history) == 3
    assert [t.data_ptr() for t in flatten(got) if isinstance(t, torch.Tensor)] == ptrs
    assert latest_step(str(tmp_path)) == 5  # final_save=False wrote nothing more
    for a, b in zip(_bytes(got), want):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)


# -- the launcher ------------------------------------------------------------------


def _train(args, wait=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", *args]
    if not wait:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)


def _losses(path):
    return {r["step"]: r["loss"] for r in map(json.loads, open(path)) if "loss" in r}


def test_launcher_resumes_after_a_kill(tmp_path):
    common = ["--arch", "bst", "--steps", "200", "--checkpoint-every", "10", "--lr", "5e-3"]
    full = _train(common + ["--metrics", str(tmp_path / "full.jsonl")])
    assert full.returncode == 0, full.stderr[-2000:]
    want = _losses(tmp_path / "full.jsonl")

    ck = tmp_path / "ck"
    proc = _train(common + ["--checkpoint-dir", str(ck), "--metrics", str(tmp_path / "a.jsonl")],
                  wait=False)
    deadline = time.time() + 120
    while latest_step(str(ck)) is None and proc.poll() is None and time.time() < deadline:
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    assert proc.wait() == -signal.SIGKILL, "the run ended before its first checkpoint was seen"
    first = latest_step(str(ck))
    assert first is not None and first < 200

    again = _train(common + ["--checkpoint-dir", str(ck), "--metrics", str(tmp_path / "b.jsonl")])
    assert again.returncode == 0, again.stderr[-2000:]
    resumed = _losses(tmp_path / "b.jsonl")
    assert resumed and min(resumed) > first
    assert all(resumed[s] == want[s] for s in resumed), (first, resumed, want)
    assert latest_step(str(ck)) == 200


_TINY_LM = (
    "import sys, torch\n"
    "from repro_torch.launch import train as LT\n"
    "from repro_torch.models.transformer import TransformerConfig\n"
    "LT.lm100m_config = lambda: TransformerConfig(n_layers=2, d_model=64, n_heads=4, "
    "n_kv_heads=2, head_dim=16, d_ff=128, vocab=512, dtype=torch.float32, remat_policy='none')\n"
    "sys.exit(LT.main(sys.argv[1:]))\n")


def _train_lm(args, wait=True):
    """The launcher's ``--preset lm100m`` with the preset shrunk, as
    ``examples/train_lm_torch.py`` shrinks it, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-c", _TINY_LM, "--preset", "lm100m", "--device", "cpu",
           "--batch", "4", "--seq-len", "32", *args]
    if not wait:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_refuses_the_language_models(tmp_path):
    """(Named when the launcher refused the LMs.)  Now it trains them:
    ``--preset lm100m`` (shrunk) is SIGKILLed after its first checkpoint and
    resumes, its losses bit-equal to an uninterrupted run's; ``--arch
    yi-6b`` trains at ``smoke_config()``; an unknown id still raises."""
    common = ["--steps", "200", "--checkpoint-every", "10", "--lr", "3e-3"]
    full = _train_lm(common + ["--metrics", str(tmp_path / "full.jsonl")])
    assert full.returncode == 0, full.stderr[-2000:]
    assert "LM params" in full.stdout
    want = _losses(tmp_path / "full.jsonl")
    assert want[max(want)] < want[min(want)]

    ck = tmp_path / "ck"
    proc = _train_lm(common + ["--checkpoint-dir", str(ck), "--metrics",
                               str(tmp_path / "a.jsonl")], wait=False)
    deadline = time.time() + 120
    while latest_step(str(ck)) is None and proc.poll() is None and time.time() < deadline:
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    assert proc.wait() == -signal.SIGKILL, "the run ended before its first checkpoint was seen"
    first = latest_step(str(ck))
    assert first is not None and first < 200
    again = _train_lm(common + ["--checkpoint-dir", str(ck), "--metrics",
                                str(tmp_path / "b.jsonl")])
    assert again.returncode == 0, again.stderr[-2000:]
    resumed = _losses(tmp_path / "b.jsonl")
    assert resumed and min(resumed) > first
    assert all(resumed[s] == want[s] for s in resumed), (first, resumed, want)

    from repro_torch.launch import train as LT

    assert REG.get("gemma-2b").family == "lm"
    assert LT.main(["--arch", "yi-6b", "--device", "cpu", "--steps", "3"]) == 0
    with pytest.raises(KeyError, match="no-such-arch"):
        LT.main(["--arch", "no-such-arch", "--device", "cpu"])

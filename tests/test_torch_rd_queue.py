"""The rate-distortion queue of the port (`contextgs_tpu_torch/scripts/`
`rd_queue`, `rd_finalize`, `chip_session`) against the JAX package's shell
scripts `scripts/r4_branch_l2.sh`, `r5_rd_queue.sh`, `r5_finalize.sh` and
`r5_chip_session.sh`, on the CPU.

The claim the queue rests on (`r4_branch_l2.sh:3-11`): a point branched at
a new λ from a checkpoint at the context transition repeats a continuous
run at that λ bit for bit. The shell scripts' command lines are parsed from
their files; the launchers' are compared with them."""

import json
import os
import re
import shlex
import sys
import time

import numpy as np
import pytest
import torch

from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.scripts import (chip_session, r3_suite, rd_finalize,
                                         rd_queue, rd_table)
from contextgs_tpu_torch.train import loop as tloop
from test_torch_raster_tools import _jax_script, _run_jax
from test_torch_train import _tiny_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = ("--noise_from 10 --context_from 20 --start_stat 2 "
            "--update_from 4 --update_interval 10 --update_until 15 "
            "--n_offsets 4")
JAX_MODULE = {"train.py": "contextgs_tpu_torch.drivers.train",
              "test.py": "contextgs_tpu_torch.drivers.test",
              "bench.py": "contextgs_tpu_torch.drivers.bench",
              "scripts/codec_diag.py":
                  "contextgs_tpu_torch.scripts.codec_diag",
              "scripts/rd_table.py": "contextgs_tpu_torch.scripts.rd_table",
              "scripts/corner_diag.py":
                  "contextgs_tpu_torch.scripts.corner_diag",
              "scripts/fps_bench.py": "contextgs_tpu_torch.scripts.fps_bench",
              "scripts/thr_sweep.py": "contextgs_tpu_torch.scripts.thr_sweep"}


def _shell(name):
    """The shell script's lines, continuations joined."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        return f.read().replace("\\\n", " ").splitlines()


def _words(line, env):
    """A command line's words with `$VAR` substituted from env and the
    redirections and pipes cut off."""
    line = re.split(r"\s(?:2>&1|>>|\|)\s", line + " ")[0]
    return shlex.split(re.sub(r"\$\{?(\w+)\}?", lambda m: env[m.group(1)],
                              line))


def _timed_python(lines, env):
    """[(seconds, script, args)] of the script's `timeout N python X ...`
    lines, in order."""
    out = []
    for line in lines:
        words = _words(line.strip(), env) if "timeout" in line else []
        if words[:1] == ["timeout"] and words[2] == "python":
            out.append((int(words[1]), words[3], words[4:]))
    return out


# ------------------------------------------------ branched = continuous

def _cfg(lmbda, model_path="", start=None):
    return tcfg.TrainConfig(
        model=tcfg.ModelConfig(feat_dim=8, n_offsets=4, voxel_size=0.05,
                               capacity_headroom=3.0),
        opt=tcfg.OptimizationConfig(
            iterations=30, noise_from=10, context_from=20, start_stat=2,
            update_from=4, update_interval=5, update_until=28, lmbda=lmbda),
        log_every=1000, save_iterations=(), checkpoint_iterations=(20,),
        model_path=model_path, start_checkpoint=start)


def _run(cfg, scene):
    losses = {}

    def cb(it, ts, metrics):
        losses[it] = float(metrics.loss)

    return losses, tloop.train(cfg, scene, device="cpu", callback=cb)


def test_branched_point_repeats_the_continuous_run(tmp_path):
    """Train λ = 0.004 to 30 steps (context from 21, densify every 5 up to
    25, a checkpoint at the transition), a continuous run at λ = 0.05, and
    a branch at λ = 0.05 from the first run's chkpnt20.pt: the first 20
    steps of the two continuous runs are bit-equal (λ enters the loss only
    in the context phase), the checkpoint holds no level scales (they are
    searched after the resume), and the branch repeats the continuous run
    at its λ bit for bit: every step's loss, then the level scales, every
    parameter, buffer and Adam moment, both generators and the camera
    order."""
    scene = _tiny_scene(n_train=4, n_test=1)
    first, _ = _run(_cfg(0.004, str(tmp_path / "l0.004")), scene)
    base = tmp_path / "l0.004" / "chkpnt20.pt"
    continuous, want = _run(_cfg(0.05), scene)
    branched, got = _run(_cfg(0.05, start=str(base)), scene)

    assert [first[i] for i in range(1, 21)] == [continuous[i]
                                                for i in range(1, 21)]
    assert first[21] != continuous[21]
    assert torch.load(base, weights_only=True)["meta"]["level_scales"] is None
    assert sorted(branched) == list(range(21, 31))
    assert all(branched[i] == continuous[i] for i in range(21, 31))
    assert got.level_scales == want.level_scales and got.level_scales
    assert got.iteration == want.iteration == 30
    for a, b in ((tst.param_leaves(got.model.params),
                  tst.param_leaves(want.model.params)),
                 (got.model.buffers._asdict(), want.model.buffers._asdict()),
                 (got.adam.mu, want.adam.mu), (got.adam.nu, want.adam.nu)):
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a), [
            k for k in a if not torch.equal(a[k], b[k])]
    assert got.adam.count == want.adam.count
    assert torch.equal(got.generator.get_state(), want.generator.get_state())
    assert got.rng.bit_generator.state == want.rng.bit_generator.state


# ------------------------------------------------------------- rd_queue

@pytest.mark.parametrize("script,argv,lm", [
    ("r4_branch_l2.sh", ["--lmbdas", "0.0005", "--checkpoint_iterations",
                         "20000", "25000"], "0.0005"),
    ("r5_rd_queue.sh", ["--lmbdas", "0.001,0.002"], "0.001"),
    ("r5_rd_queue.sh", ["--lmbdas", "0.001,0.002"], "0.002")])
def test_queue_passes_the_shell_scripts_train_flags(script, argv, lm,
                                                   tmp_path):
    """The train driver's flags of each point equal those of the shell
    script's `python train.py` line, without `--train_vis_cap 524288`
    (the port's driver refuses it) and with the port's checkpoint suffix
    `.pt` for `.pkl`."""
    out = str(tmp_path / "r4_bench")
    env = dict(OUT=out, LM=lm, DIR=f"{out}/l{lm}", TMO="1")
    line = next(ln for ln in _shell(script) if "python train.py" in ln)
    words = _words(line.split("python train.py", 1)[1], env)
    i = words.index("--train_vis_cap")
    want = [w.replace(".pkl", ".pt") for w in words[:i] + words[i + 2:]]
    args = rd_queue.parse(["--out", out, *argv])
    assert rd_queue.train_argv(args, float(lm)) == want


def test_summary_entry_has_the_heredocs_keys(tmp_path):
    """The summary entry's keys are those of r5_rd_queue.sh's heredoc but
    `round` (the label of the TPU round); `branched_from` is written as the
    shell script writes it."""
    text = "\n".join(_shell("r5_rd_queue.sh"))
    heredoc = text.split("<<'EOF'", 1)[1].split("\nEOF", 1)[0]
    keys = set(re.findall(r"(\w+)=", re.search(
        r"entry = dict\((.*?)\)", heredoc, re.S).group(1)))
    keys |= set(re.findall(r'"(last_progress|results)"', heredoc))
    assert keys == {"lmbda", "iters", "rc", "branched_from", "round",
                    "last_progress", "results"}
    out = tmp_path / "r4_bench"
    (out / "l0.002").mkdir(parents=True)
    for name in ("progress.json", "results.json"):
        (out / "l0.002" / name).write_text("{}")
    args = rd_queue.parse(["--out", str(out)])
    entry = rd_queue.summary_entry(args, 0.002, 0)
    assert set(entry) == keys - {"round"}
    assert entry["branched_from"] == "l0.004/chkpnt10000"


def test_deadline_skips_a_point_under_900_s(tmp_path, monkeypatch):
    """A point with fewer than 900 s left is skipped and writes no entry;
    otherwise its run gets the time left, at most 10800 s."""
    calls = []
    monkeypatch.setattr(rd_queue, "run_logged",
                        lambda cmd, log, timeout: calls.append(timeout) or 0)
    out = tmp_path / "q"
    out.mkdir()
    args = rd_queue.parse(["--out", str(out)])
    log = str(out / "rd_queue.log")
    for left, want in ((899, None), (5000, 5000), (20000, 10800)):
        args.deadline_ts = time.time() + left
        assert rd_queue.run_point(args, 0.001, log) == (None if want is None
                                                        else 0)
        if want is not None:
            assert abs(calls[-1] - want) < 5
    assert len(calls) == 2
    assert "deadline reached; skipping l0.001" in (out / "rd_queue.log"
                                                   ).read_text()
    assert len((out / "summary.jsonl").read_text().splitlines()) == 2


def test_queue_waits_while_a_card_run_holds_the_card(monkeypatch):
    """Only the port's training runs with --lmbda and without --force_cpu
    hold the card; the wait polls every 60 s until none is left."""
    listing = ("11 python -m contextgs_tpu_torch.drivers.train -s a "
               "--lmbda 0.001\n"
               "12 python -m contextgs_tpu_torch.drivers.train -s a "
               "--lmbda 0.001 --force_cpu\n"
               "13 python -m contextgs_tpu_torch.drivers.train -s a\n")
    monkeypatch.setattr(rd_queue.subprocess, "run", lambda *a, **k: type(
        "R", (), {"stdout": listing})())
    assert [ln.split()[0] for ln in rd_queue.card_holders()] == ["11"]
    polls, sleeps = iter([["x"], ["x"], []]), []
    monkeypatch.setattr(rd_queue, "card_holders", lambda: next(polls))
    monkeypatch.setattr(rd_queue.time, "sleep", sleeps.append)
    rd_queue.wait_for_card()
    assert sleeps == [60, 60]


def test_queue_branches_a_point_on_disk(tmp_path, monkeypatch, capsys):
    """r3_suite trains λ = 0.004 with a checkpoint at the context
    transition; rd_queue trains λ = 0.002 from it (a drivers.train process
    with --start_checkpoint) into the same layout; the summary holds both
    entries, the queue's branched from l0.004/chkpnt20, and both packages'
    rd_table print the same table with a row for each point."""
    out = tmp_path / "rd"
    assert r3_suite.main([
        "--out", str(out), "--res", "64", "--cams", "8", "--gauss", "2000",
        "--points", "300", "--iters", "30", "--lmbdas", "0.004",
        "--extra_flags", SCHEDULE + " --checkpoint_iterations 20",
        "--force_cpu"]) == 0
    base = out / "l0.004" / "chkpnt20.pt"
    assert base.exists()
    assert rd_queue.main([
        "--out", str(out), "--base", str(base), "--lmbdas", "0.002",
        "--iters", "30", "--checkpoint_iterations", "25", "--no_wait",
        "--extra_flags", SCHEDULE, "--force_cpu"]) == 0
    entries = [json.loads(x) for x in
               (out / "summary.jsonl").read_text().splitlines()]
    assert [e["lmbda"] for e in entries] == [0.004, 0.002]
    e = entries[1]
    assert e["rc"] == 0 and e["iters"] == 30
    assert e["branched_from"] == "l0.004/chkpnt20"
    assert np.isfinite(e["results"]["ours"]["PSNR"])
    assert (out / "l0.002" / "chkpnt25.pt").exists()
    log = (out / "rd_queue.log").read_text()
    assert "resumed from" in log and "at iteration 20" in log

    capsys.readouterr()
    assert rd_table.main(["--out", str(out)]) == 0
    got = capsys.readouterr().out
    want = _run_jax(_jax_script("rd_table"), ["--out", str(out)],
                    monkeypatch, capsys)
    assert got == want
    assert "| 0.004 | 30 | " in got and "| 0.002 | 30 | " in got


# --------------------------------------------------- rd_finalize, session

def test_finalize_issues_the_shell_scripts_steps(tmp_path, capsys):
    """`rd_finalize --dry_run` issues r5_finalize.sh's sequence with its
    time limits: for each point directory with a checkpoint the test driver
    and codec_diag, then rd_table and the bench; a directory without a
    checkpoint is noted and skipped, a missing one skipped. The shell's
    first line, the JAX package's TPU tests, has no step (chip_smoke.py
    holds the kernels on the card). `--no_bench` drops the bench only."""
    out = tmp_path / "r4_bench"
    (out / "l0.004").mkdir(parents=True)
    (out / "l0.004" / "chkpnt30000.pt").write_bytes(b"")
    (out / "l0.002").mkdir()
    (out / "l0.002" / "chkpnt30000.pkl").write_bytes(b"")
    (out / "l0.001").mkdir()
    lines = _shell("r5_finalize.sh")
    text = "\n".join(lines)
    assert "timeout 900 python -m pytest tests -m tpu -q" in text
    top = next(i for i, ln in enumerate(lines) if "for LM in" in ln)
    end = next(i for i, ln in enumerate(lines) if ln.strip() == "done")
    want = []
    for lm in re.search(r"for LM in ([0-9. ]+); do", text).group(1).split():
        if lm in ("0.004", "0.002"):
            env = dict(OUT=str(out), LM=lm, DIR=str(out / f"l{lm}"),
                       LOG="log")
            want += _timed_python(lines[top:end], env)
    want += _timed_python(lines[end:], dict(OUT=str(out), LOG="log"))
    want = [(t, JAX_MODULE[s], a) for t, s, a in want]

    assert rd_finalize.main(["--out", str(out), "--dry_run"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"# no ckpt in {out / 'l0.001'}"
    got = [(int(w[1]), w[4], w[5:]) for w in map(str.split, printed[1:])]
    assert all(ln.split()[2] == sys.executable for ln in printed[1:])
    assert got == want
    assert [t for t, _, _ in got] == [1800, 1200, 1800, 1200, 300, 900]
    assert rd_finalize.main(["--out", str(out), "--dry_run",
                             "--no_bench"]) == 0
    assert capsys.readouterr().out.splitlines() == printed[:-1]


def test_chip_session_issues_the_shell_scripts_steps(tmp_path, capsys):
    """`chip_session --dry_run` issues r5_chip_session.sh's measurements
    with their time limits, then the queue on the same output directory
    with the deadline."""
    lines = _shell("r5_chip_session.sh")
    steps = _timed_python(lines, dict(LOG="log"))
    want = [(t, JAX_MODULE[s], a) for t, s, a in steps]
    assert any("bash scripts/r5_rd_queue.sh" in ln for ln in lines)
    out = tmp_path / "r4_bench"
    assert chip_session.main(["--out", str(out), "--deadline_ts", "12345",
                              "--dry_run"]) == 0
    printed = capsys.readouterr().out.splitlines()
    timed = [w for w in map(str.split, printed) if w[0] == "timeout"]
    assert [(int(w[1]), w[4], w[5:]) for w in timed] == want
    assert printed[-1].split()[1:] == [
        "-m", "contextgs_tpu_torch.scripts.rd_queue", "--out", str(out),
        "--deadline_ts", "12345"]
    assert len(printed) == len(want) + 1


def test_launcher_stops_its_child_on_sigterm(tmp_path):
    """A SIGTERM to a launcher waiting in `run_logged` (as `timeout`, or
    a chip session stopping its queue, sends it) stops the child's
    process group before the launcher exits: no child outlives it."""
    import signal
    import subprocess

    pid_file = tmp_path / "child.pid"
    child = ("import os, time; open(%r, 'w').write(str(os.getpid())); "
             "time.sleep(120)" % str(pid_file))
    launcher = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from contextgs_tpu_torch.scripts import run_logged; "
         f"run_logged([sys.executable, '-c', {child!r}], "
         f"{str(tmp_path / 'log')!r})"], cwd=REPO)
    deadline = time.time() + 60
    while not (pid_file.exists() and pid_file.read_text()):
        assert time.time() < deadline and launcher.poll() is None
        time.sleep(0.1)
    pid = int(pid_file.read_text())
    launcher.send_signal(signal.SIGTERM)
    assert launcher.wait(timeout=30) != 0
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)

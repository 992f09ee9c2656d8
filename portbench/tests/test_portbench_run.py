"""Whole runs of the harness on the CPU at a tiny size (the program's
ladder shrunk): a sound run comes out correct, and a run with the timed
path broken underneath comes out not correct, once for each fault the
cells can have; the control fails the limit; without a card no result.

The faults (portbench/faults.py, which also reads them on the card at
the cells' own sizes) are planted after the pipeline is built and warmed
up, so the window's timed path runs them: the stream's state left
unchanged, half of each micro-batch left out (its outputs the mean of
the rest), and the answers altered where the service produces them.
(One chip: no exchange between chips to leave out.)
"""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.control import control_reading
from portbench.faults import FAULTS
from portbench.registry import ROOT
from portbench.run import main, run_cell
from portbench.tests.tiny import shrink, tiny_cell

SEED = 2**32 + 12345


def _cell(name, keep=3):
    cell = tiny_cell(name)
    cell.traffic.update(source_fps=8, capture_fps=8, check_frames=keep)
    return cell


def _run(name, fault=None, seconds=1.5, keep=3):
    return run_cell(_cell(name, keep), SEED, seconds, False, device="cpu", after_build=fault, log=lambda m: None)


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    shrink(monkeypatch)


@pytest.mark.parametrize("name", ["egvsr.vod", "realesrgan.vod"])
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checked"]
    assert res["failed"] == 0 and res["attempted"] == 12
    assert list(res)[-1] == "checked" and res["checked"]["frames_compared"]["value"] >= 2


@pytest.mark.parametrize("name, fault, seconds", [
    ("egvsr.vod", "state_unchanged", 1.5), ("realesrgan.vod", "state_unchanged", 1.5),
    ("egvsr.vod", "half_left_out", 1.5), ("egvsr.vod", "answer_altered", 1.5),
    # past BSVD's 16-frame lookahead, so that live outputs (the fetched ones) carry frames, not the drain alone
    ("realesrgan.vod", "half_left_out", 4.0), ("realesrgan.vod", "answer_altered", 4.0),
])
def test_a_broken_timed_path_is_not_correct(name, fault, seconds):
    res = _run(name, FAULTS[fault], seconds, keep=3 if seconds < 2 else 8)
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("name", ["realesrgan.vod", "egvsr.vod"])
def test_the_control_fails_the_limit(name):
    cell = _cell(name)
    row = control_reading(cell, SEED, 40, torch.device("cpu"))
    assert row["psnr_min_db"] < cell.config["limits"]["psnr_min_db"], row


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "egvsr.vod", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        main(["--workload", "nope.vod", "--seed", "1", "--seconds", "1"])


def test_only_the_benchmarks_files_give_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "egvsr.vod", "--seed", "3",
                        "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    with pytest.raises(json.JSONDecodeError):
        json.loads(p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "")

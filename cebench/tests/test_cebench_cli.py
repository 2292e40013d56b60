"""The command: it fails with no result line without a card, for a cell that
is not there, and in a directory that holds only the benchmark's files."""
import os
import shutil
import subprocess
import sys

from cebench.tests.conftest import ROOT

ARGS = ["--workload", "pusch100_closed8", "--seed", "3000000001", "--seconds", "1",
        "--trace", "0"]


def cebench(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "cebench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_a_card():
    out = cebench(ROOT, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_fails_for_an_unknown_cell():
    out = cebench(ROOT, "--workload", "no_such_cell", "--seed", "1", "--seconds", "1")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cebench"), tmp_path / "cebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = cebench(tmp_path, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_card_but_no_program_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cebench"), tmp_path / "cebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from cebench import run\n"
            f"sys.exit(run.main({ARGS!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "srsran_ce_tpu_torch is not here" in out.stderr

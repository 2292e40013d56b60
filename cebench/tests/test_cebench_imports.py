"""No module of JAX or the JAX package is loaded by the benchmark: names are
compared whole, because the program's name begins with the JAX package's."""
import os
import subprocess
import sys

from cebench import run
from cebench.tests.conftest import ROOT


def test_whole_names(monkeypatch):
    fake = dict(sys.modules)
    for name in ("srsran_ce_tpu_torch", "srsran_ce_tpu_torch.serving", "jaxtyping", "flaxen"):
        fake.setdefault(name, sys)
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["srsran_ce_tpu.ops"] = sys
    fake["jax.numpy"] = sys
    assert run.forbidden_modules() == ["jax", "srsran_ce_tpu"]


def test_nothing_the_benchmark_imports_loads_jax():
    code = (
        "import sys, glob, os\n"
        "from cebench import run, spec, calibrate, sweep, trace, roofline\n"
        "from cebench.reference import ce, pusch, oracle\n"
        "for kind in ('chains', 'traffic', 'metrics'):\n"
        "    for f in glob.glob(os.path.join('cebench', kind, '*.py')):\n"
        "        spec.load_module(kind, os.path.basename(f)[:-3])\n"
        "import srsran_ce_tpu_torch.serving, srsran_ce_tpu_torch.graphs\n"
        "print(run.forbidden_modules())\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\nfrom cebench.reference import ce, pusch, numbers, oracle\n"
            "from cebench.gen import slots\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'jax', 'srsran_ce_tpu', 'srsran_ce_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"

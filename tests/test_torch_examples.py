"""The port's four examples, run end to end on the CPU.

Each of ``examples/{quickstart,anomaly_study,serve_lm,train_lm}_torch.py``
runs in a subprocess at its smallest setting with ``--device cpu`` (the
kernels' plain versions) and isolated profile and atlas caches: it must
exit 0, print its closing line, and leave neither ``jax`` nor anything
of the reference package ``repro`` in ``sys.modules``. A source scan
holds the same for their imports.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: (example, its smallest setting, a line it must print).
EXAMPLES = [
    ("quickstart_torch.py", [], "over a batch of 32"),
    ("anomaly_study_torch.py", ["--max-samples", "20", "--box-hi", "100"],
     "abundance"),
    ("serve_lm_torch.py", ["--new-tokens", "8"], "decode throughput"),
    ("train_lm_torch.py", ["--smoke", "--steps", "2", "--seq", "32",
                           "--batch", "2"], "finished at step 2"),
]

RUNNER = """
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
"""


@pytest.mark.parametrize("name,args,expect", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(tmp_path, name, args, expect):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PROFILE_DIR=str(tmp_path / "profiles"),
               REPRO_ATLAS_DIR=str(tmp_path / "atlas"))
    extra = ["--ckpt", str(tmp_path / "ckpt")] if name.startswith(
        "train") else []
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / name),
         "--device", "cpu", *args, *extra],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert expect in proc.stdout, proc.stdout[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-500:]


@pytest.mark.parametrize("name", [e[0] for e in EXAMPLES])
def test_example_source_imports_neither_jax_nor_the_reference(name):
    text = (ROOT / "examples" / name).read_text()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", text, re.M)
    assert imports
    assert not [m for m in imports
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], imports
    assert "--device" in text and 'default="cuda"' in text

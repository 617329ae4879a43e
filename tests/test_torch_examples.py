"""Each ``examples/torch_*.py`` runs as a script on the CPU (``--device
cpu``) at a small size, exits 0 and prints its recall gate line."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (script, arguments besides --device cpu, the line its gate prints)
EXAMPLES = [
    ("torch_plaintext_ann.py", ["3000", "16", "16"], "recall@10: "),
    ("torch_encrypted_e2e.py", ["3000", "16", "16"], "recall@10: "),
    ("torch_cpu_only_serving.py", ["3000", "16", "16"], "recall@10: "),
    ("torch_sharded_serving.py", ["4000", "16", "16"], "recall@10: "),
    ("torch_mesh_serving.py", [], "mesh lifecycle OK"),
]


@pytest.mark.parametrize("script,args,gate", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(tmp_path, script, args, gate):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), *args,
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(ln.startswith(gate) for ln in lines), proc.stdout
    if gate.startswith("recall"):
        got = [float(ln.split()[-1]) for ln in lines if ln.startswith(gate)]
        assert got[-1] > 0.8

"""The PyTorch port imports no jax.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh interpreter."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "show_tell_tpu_torch")


def test_port_imports_without_jax():
    code = (
        "import show_tell_tpu_torch, show_tell_tpu_torch.serve, show_tell_tpu_torch.models.captioner, "
        "show_tell_tpu_torch.ops.fused_step, show_tell_tpu_torch.ops.build, show_tell_tpu_torch.models.attention, "
        "show_tell_tpu_torch.ops.attention, show_tell_tpu_torch.ops.fused_attn, show_tell_tpu_torch.ops.vocab; "
        "import sys; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if m.startswith('jax'))"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                            timeout=120)
    assert result.returncode == 0, result.stderr


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.join(root, f))
    assert not offenders
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    assert not pattern.search(smoke)
    assert "show_tell_tpu." not in smoke  # nothing of the JAX package either

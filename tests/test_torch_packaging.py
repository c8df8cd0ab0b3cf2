"""The port's packaging (pyproject.toml): an installed copy carries every
source its kernels and host libraries build from (the CUDA sources and
headers, the C++ of native/), and the console scripts of its four training
CLIs point at their entry points."""

import fnmatch
import importlib
import os
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "show_tell_tpu_torch")


def _pyproject():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


@pytest.mark.parametrize("subdir", ["csrc", "native"])
def test_package_data_carries_every_build_source(subdir):
    globs = _pyproject()["tool"]["setuptools"]["package-data"]["show_tell_tpu_torch"]
    sources = [os.path.join(subdir, f) for f in os.listdir(os.path.join(PORT, subdir))
               if f.endswith((".cu", ".cuh", ".h", ".cpp"))]
    assert sources
    missing = [s for s in sources if not any(fnmatch.fnmatch(s, g) for g in globs)]
    assert not missing, missing


def test_console_scripts_of_the_port_clis():
    scripts = {k: v for k, v in _pyproject()["project"]["scripts"].items() if v.startswith("show_tell_tpu_torch.")}
    assert sorted(v.split(":")[0].rsplit(".", 1)[1] for v in scripts.values()) == [
        "main", "main_attn", "main_attn_lstm", "main_lstm"]
    for target in scripts.values():
        module, fn = target.split(":")
        assert callable(getattr(importlib.import_module(module), fn))

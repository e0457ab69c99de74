"""Platform plumbing: chip_smoke's device check, the compilation-cache
path rule, and parsing nvidia-smi's card line."""

import os
import shutil
import subprocess
import sys

import pytest

from rolo_tpu.runtime import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu_backend():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_exits_nonzero_without_gpu(tmp_path, alone):
    """On a CPU backend, from the repo or from a directory that holds only
    the script, chip_smoke exits non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert platform.compilation_cache_dir() == str(tmp_path / "cc")


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = platform.compilation_cache_dir()
    assert d == platform.compilation_cache_dir()  # fixed across calls
    assert os.path.dirname(os.path.dirname(d)) == REPO
    assert os.path.basename(os.path.dirname(d)) == ".jax_cache"
    assert os.path.basename(d) == platform._host_fingerprint()


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3", 500.0),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", None),
])
def test_parse_gpu_card(line, name, watts):
    assert platform.parse_gpu_card(line) == {"name": name, "power_limit_w": watts}

"""chip_smoke.py refuses to run anywhere but on a GPU."""

import os
import subprocess
import sys
import types

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_platform(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices("cpu"))
    assert exc.value.code not in (0, None)
    assert "no GPU found" in capsys.readouterr().err


def test_require_gpu_accepts_gpu_first():
    fake = types.SimpleNamespace(platform="gpu", device_kind="H100")
    chip_smoke.require_gpu([fake])          # returns without exiting
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_script_exits_nonzero_without_gpu():
    """Run as a program on the CPU: non-zero exit, no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout

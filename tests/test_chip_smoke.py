"""`chip_smoke.py` refuses to report anything without a GPU, and its check
helpers fail on what they should."""
import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke
from jax_bvh.types import HitInfo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_without_gpu():
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_refuses_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_hit_rule_fails_on_a_mask_difference(capsys):
    sm = chip_smoke.Smoke("test card")
    t = np.full(8, 2.0, np.float32)
    ref = HitInfo(prim_idx=np.arange(8), t=t, u=t, v=t)
    same = HitInfo(prim_idx=np.arange(8), t=t * (1 + 1e-6), u=t, v=t)
    chip_smoke.hit_rule(sm, "same", same, ref)
    assert sm.failed == []
    lost = HitInfo(prim_idx=np.where(np.arange(8) == 3, -1, np.arange(8)),
                   t=t, u=t, v=t)
    chip_smoke.hit_rule(sm, "lost", lost, ref)
    far = HitInfo(prim_idx=np.arange(8), t=t * 1.01, u=t, v=t)
    chip_smoke.hit_rule(sm, "far", far, ref)
    assert sm.failed == ["lost", "far"]
    assert "1 pixels hit in one engine only" in capsys.readouterr().out


def test_one_card_phases_pass_at_a_tiny_size():
    """Every one-card phase and check runs on the CPU at a tiny size (the
    raster runs its plain reference engine here)."""
    class Once(chip_smoke.Smoke):
        def time(self, name, fn, reps=1):
            return super().time(name, fn, reps=1)

    sm = Once("cpu")
    chip_smoke.one_card(sm, {"sponza": 4000, "bunny": 2000, "meshes": 16,
                             "oracle": 1000, "frames": ((64, 64), (96, 80)),
                             "slice": 1024})
    assert sm.failed == []

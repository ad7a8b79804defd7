"""The check against JAX and the JAX package compares whole top-level names."""

import subprocess
import sys
from pathlib import Path

from portbench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_whole_top_level_names():
    assert guard.forbidden(["relp_tpu_torch", "relp_tpu_torch.x", "jaxtyping", "numpy"]) == []
    assert guard.forbidden(["relp_tpu.x"]) == ["relp_tpu.x"]
    assert guard.forbidden(["relp_tpu", "jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "relp_tpu"]


def test_the_harness_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness, control, guard; "
            "from portbench.kinds import resolve; "
            "import relp_tpu_torch.api, relp_tpu_torch.simplex.driver; "
            "print(guard.loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

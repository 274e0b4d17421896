"""No module of the JAX reference package loads in a benchmark run."""
import json
import subprocess
import sys

from perfbench.lib import guard
from perfbench.lib.spec import ROOT


def test_whole_top_level_names_are_compared():
    names = ["repro_torch", "repro_torch.core", "reproduce", "jaxtyping",
             "numpy", "repro", "repro.core.exoshuffle", "jax.numpy",
             "jaxlib", "flax.linen"]
    assert guard.forbidden(names) == ["flax.linen", "jax.numpy", "jaxlib",
                                      "repro", "repro.core.exoshuffle"]


SCRIPT = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[1] + "/perfbench/tests"]
import conftest
from perfbench import run
from perfbench.lib import guard
for wl in ("indy.resident",):
    rc, line = run.main(["--workload", wl, "--seed", "41", "--seconds", "0.1",
                         "--trace", "1"], device="cpu", adjust=conftest.shrink)
    assert rc == 0 and line["correct"], line
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_reference_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in tops and "perfbench" in tops
    assert not set(tops) & guard.FORBIDDEN


def test_nothing_reads_the_old_benchmarks_folder():
    for p in (ROOT / "perfbench").rglob("*.py"):
        if p.name == "test_perfbench_guard.py":
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text

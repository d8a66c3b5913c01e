"""The import check: nothing the benchmark loads is JAX or the JAX
package, by top-level module names compared whole (`sstts_torch` is the
program, `sstts` the JAX package), and the reference loads nothing of
the program."""

import subprocess
import sys

from portbench import harness
from portbench.tests.conftest import ROOT


def test_names_compared_whole():
    assert harness.forbidden_modules(["sstts_torch", "sstts_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(["sstts.ops.x", "jaxlib.xla", "flax", "jaxtyping"]) == [
        "flax", "jaxlib", "sstts"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program():
    names = _loaded("import portbench.reference.synthesis, portbench.reference.train, "
                    "portbench.check")
    assert not names & {"sstts_torch", "sstts", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax():
    code = ("from portbench.tests import tiny\n"
            "tiny.run('synth_stream', tiny.synth_tree(), tiny.synth_traffic(), seconds=0.5)\n"
            "tiny.run('train_cached', tiny.train_tree(), tiny.train_traffic(), seconds=0.5)\n"
            "from portbench import harness\nassert harness.forbidden_modules() == []")
    names = _loaded(code)
    assert "sstts_torch" in names
    assert not names & {"sstts", "jax", "jaxlib", "flax"}

"""Nothing a run loads is JAX, flax or the JAX package, compared by the
whole top-level module name (the port's own name begins with the JAX
package's), and the references import nothing of the port."""

import json
import subprocess
import sys

import pytest

from perfbench import core
from perfbench.test_perfbench_run import CELLS, SIZES

PORT = "aura_snn_rag_tpu_torch"

WALK = """
import json, sys, time
sys.path.insert(0, {root!r})
from perfbench import run
run.main(["--workload", {cell!r}, "--seed", "5", "--seconds", "0.3",
          "--trace", "0"], device="cpu", sizes={sizes!r},
         t_start=time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(core.ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_forbidden_names_are_whole_top_level_names():
    sys.modules.setdefault("aura_snn_rag_tpu_torch_like", sys)
    try:
        assert "aura_snn_rag_tpu_torch_like" not in core.forbidden_loaded()
    finally:
        del sys.modules["aura_snn_rag_tpu_torch_like"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_run_loads_no_jax(cell):
    names = top_level(WALK.format(root=str(core.ROOT), cell=cell,
                                  sizes=SIZES[cell]))
    assert not names & set(core.FORBIDDEN_MODULES), names
    assert PORT in names


def test_references_import_nothing_of_the_port():
    names = top_level(
        f"import json, sys; sys.path.insert(0, {str(core.ROOT)!r})\n"
        "import perfbench.reference.engine_exact, "
        "perfbench.reference.lm_plain, perfbench.reference.lm_train, "
        "perfbench.counts.ivf, "
        "perfbench.counts.lm, perfbench.counts.peaks\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (set(core.FORBIDDEN_MODULES) | {PORT}), names

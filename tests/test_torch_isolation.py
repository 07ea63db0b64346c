"""The port imports neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "click", "orbax", "aiohttp"):
    sys.modules[blocked] = None      # any `import jax` etc. now raises
import aura_snn_rag_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "aura_snn_rag_tpu" or m.startswith("aura_snn_rag_tpu.")
                or (m.split(".")[0] in ("jax", "jaxlib", "click", "orbax",
                                        "aiohttp", "flax", "optax")
                    and sys.modules[m] is not None))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert leaked == "[]"
    # every module file but the package's own __init__
    files = list((ROOT / "aura_snn_rag_tpu_torch").rglob("*.py"))
    assert int(n) == len(files) - 1 >= 10


# the training path's modules, each imported by the probe above with
# `jax` blocked
TRAINING_MODULES = (
    "training.losses", "training.schedule", "training.optim",
    "training.trainer", "training.tokenizer", "training.data",
    "models.brain.amygdala", "models.brain.endocrine",
    "models.brain.liquid_moe", "models.brain.thalamus", "zones.events",
    "zones.stats")


def test_training_modules_are_in_the_probe():
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in TRAINING_MODULES:
        assert f"aura_snn_rag_tpu_torch.{mod}" in names, mod
        path = ROOT / "aura_snn_rag_tpu_torch" / (mod.replace(".", "/")
                                                  + ".py")
        src = path.read_text()
        assert "import jax" not in src and "from jax" not in src, mod
        assert "aura_snn_rag_tpu." not in src.replace(
            "aura_snn_rag_tpu_torch.", ""), mod


# the operator's path: checkpoints, the CLI, ingestion and online
# learning, and the host-spilled bank; none imports click or orbax, and
# aiohttp only inside the RSS loop that needs it
OPERATOR_MODULES = (
    "training.checkpoint", "models.convert", "_native",
    "encoders.hash_embedder", "encoders.embedding_cache", "services.ingest",
    "ops.neurons", "training.online", "training.stdp_dict",
    "services.continuous_learning", "cli", "memory.host_spill")


def test_operator_modules_are_in_the_probe():
    import ast
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in OPERATOR_MODULES:
        assert f"aura_snn_rag_tpu_torch.{mod}" in names, mod
        path = ROOT / "aura_snn_rag_tpu_torch" / (mod.replace(".", "/")
                                                  + ".py")
        tree = ast.parse(path.read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                top.add(node.module.split(".")[0])
        every = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                every |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                every.add(node.module.split(".")[0])
        assert not every & {"jax", "flax", "optax", "orbax", "click",
                            "aura_snn_rag_tpu"}, (mod, every)
        assert "aiohttp" not in top, mod


# the neuromorphic brain system's modules: none imports JAX, flax or the
# JAX package (scipy only inside the Hilbert interpolation)
BRAIN_MODULES = (
    "ops.surrogate", "ops.neurons", "ops.maths", "ops.izhikevich_presets",
    "ops.snn_ops", "ops.spike_bridge", "zones.brain_zone", "zones.layers",
    "zones.neuron_factory", "zones.processor", "zones.multimodal",
    "models.brain.brain", "models.brain.specialist",
    "services.brain_system", "models.convert", "cli")


def test_brain_modules_are_in_the_probe():
    import ast
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in BRAIN_MODULES:
        assert f"aura_snn_rag_tpu_torch.{mod}" in names, mod
        path = ROOT / "aura_snn_rag_tpu_torch" / (mod.replace(".", "/")
                                                  + ".py")
        tree = ast.parse(path.read_text())
        top, every = set(), set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = {node.module.split(".")[0]}
            else:
                continue
            every |= mods
            if node in tree.body:
                top |= mods
        assert not every & {"jax", "jaxlib", "flax", "optax",
                            "aura_snn_rag_tpu"}, (mod, every)
        assert "scipy" not in top, mod


# the NaturalBrain path, the language zones and the encoders: none
# imports JAX, flax, optax or the JAX package
NATURAL_BRAIN_MODULES = (
    "models.prosody", "models.emotion_head", "models.language_zone",
    "models.brain.limbic", "models.brain.basal_ganglia",
    "models.brain.natural_brain", "models.brain.liquid_moe",
    "models.convert", "encoders.event_encoder",
    "encoders.frequency_encoder", "encoders.dual_layer_srffn",
    "encoders.pretrain_pipeline")


def test_natural_brain_modules_are_in_the_probe():
    import ast
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in NATURAL_BRAIN_MODULES:
        assert f"aura_snn_rag_tpu_torch.{mod}" in names, mod
        path = ROOT / "aura_snn_rag_tpu_torch" / (mod.replace(".", "/")
                                                  + ".py")
        every = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                every |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                every.add(node.module.split(".")[0])
        assert not every & {"jax", "jaxlib", "flax", "optax",
                            "aura_snn_rag_tpu"}, (mod, every)


# the model-parallel slice: none imports JAX, flax, optax or the JAX
# package
MODEL_PARALLEL_MODULES = (
    "parallel.collectives", "parallel.mesh", "parallel.pipeline",
    "parallel.ring_attention", "models.pipelined", "models.layers",
    "models.transformer", "models.language_zone", "training.trainer",
    "training.optim", "training.losses", "training.checkpoint",
    "generation.serving")


def test_model_parallel_modules_are_in_the_probe():
    import ast
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    for mod in MODEL_PARALLEL_MODULES:
        assert f"aura_snn_rag_tpu_torch.{mod}" in names, mod
        path = ROOT / "aura_snn_rag_tpu_torch" / (mod.replace(".", "/")
                                                  + ".py")
        every = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                every |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                every.add(node.module.split(".")[0])
        assert not every & {"jax", "jaxlib", "flax", "optax",
                            "aura_snn_rag_tpu"}, (mod, every)


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py, which the card runs, imports none of JAX, flax,
    optax or the JAX package."""
    import ast
    every = set()
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Import):
            every |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            every.add(node.module.split(".")[0])
    assert not every & {"jax", "jaxlib", "flax", "optax",
                        "aura_snn_rag_tpu"}, every


# the JAX package's names the port has no use for: the Pallas helpers and
# flax's `setup` (the port's modules build their parts in `__init__`);
# files: XLA's compilation cache (the port's counterpart is
# `ops/cuda/_build.py`) and the Pallas kernels (ported as CUDA in
# `ops/cuda/`)
NAMES_WITHOUT_A_COUNTERPART = {"TILE_M", "pallas_available",
                               "default_interpret", "PlaceCellEncoder.setup"}
FILES_WITHOUT_A_COUNTERPART = ("_cache.py", "ops/pallas/")


def public_names(path, package):
    """A module's public top-level functions, classes and assigned names,
    its public classes' public methods as "Class.method", and, in an
    `__init__.py`, the names it re-exports from its own package."""
    import ast
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                    and not sub.name.startswith("_")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level
                   or (node.module or "").split(".")[0] == package)):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.split(".")[-1].startswith("_")}


def test_every_public_name_has_a_counterpart():
    """Every JAX module has a port module of the same path, and every
    public name of it (top-level names, public methods, an `__init__`'s
    re-exports) is there too, but for the listed exceptions."""
    jax_root = ROOT / "aura_snn_rag_tpu"
    port_root = ROOT / "aura_snn_rag_tpu_torch"
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        if rel.startswith(FILES_WITHOUT_A_COUNTERPART):
            continue
        port = port_root / rel
        assert port.exists(), f"{rel} has no port"
        gap = (public_names(path, "aura_snn_rag_tpu")
               - public_names(port, "aura_snn_rag_tpu_torch")
               - NAMES_WITHOUT_A_COUNTERPART)
        if gap:
            missing[rel] = sorted(gap)
    assert missing == {}


def test_public_names_reach_the_port_s_namespaces():
    import aura_snn_rag_tpu_torch as port
    from aura_snn_rag_tpu_torch.config import MeshConfig
    from aura_snn_rag_tpu_torch.models.brain import liquid_moe
    assert port.MeshConfig is MeshConfig
    assert liquid_moe.LiquidGatingNetwork is liquid_moe.LiquidMoERouter


# the benchmark modules: one module per JAX script of `benchmarks/`, none
# of which imports JAX, flax, optax or the JAX package
BENCHMARK_MODULES = (
    "bench_host_spill", "bench_sharded_scaling", "bench_retrieval_latency",
    "bench_retrieval_breakdown", "bench_decode", "bench_generation",
    "bench_decode_breakdown", "bench_rag_overhead", "bench_flat_kernel",
    "bench_flat_batch_sweep", "bench_rescue_ab", "bench_h2d_dtypes",
    "bench_prosody", "bench_prosody_sweep", "bench_moe_routing",
    "ablation_moe_routing", "bench_energy_tracking", "bench_emotion_e2e")
# the tools: one module per JAX tool of `tools/` that drives the JAX
# package
TOOL_MODULES = ("verify_checkpoint", "inspect_checkpoint",
                "neuron_firing_diag", "continuous_learning_runner")


def _driver_probe(folder, name):
    """The port's `<folder>.<name>` is in the package beside the JAX
    script `<folder>/<name>.py`, and imports nothing of JAX; nothing of
    it runs at import."""
    import ast
    import pkgutil
    import aura_snn_rag_tpu_torch as pkg
    names = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")}
    assert f"aura_snn_rag_tpu_torch.{folder}.{name}" in names
    assert (ROOT / folder / f"{name}.py").exists()
    path = ROOT / "aura_snn_rag_tpu_torch" / folder / f"{name}.py"
    tree = ast.parse(path.read_text())
    every = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            every |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            every.add(node.module.split(".")[0])
    assert not every & {"jax", "jaxlib", "flax", "optax",
                        "aura_snn_rag_tpu"}, (name, every)
    # nothing at import: no statement at the top level reads sys.argv or
    # writes os.environ
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        src = ast.unparse(node)
        assert "sys.argv" not in src and "os.environ" not in src, src


@pytest.mark.parametrize("name", BENCHMARK_MODULES)
def test_benchmark_modules_are_in_the_probe(name):
    _driver_probe("benchmarks", name)


@pytest.mark.parametrize("name", TOOL_MODULES)
def test_tool_modules_are_in_the_probe(name):
    _driver_probe("tools", name)

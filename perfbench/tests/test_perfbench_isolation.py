"""What a run loads: nothing of JAX or of the JAX package, by whole
top-level module names; the reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from _perfbench_tiny import ROOT

PERFBENCH = ROOT / "perfbench"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_perfbench_imports_jax_or_the_jax_package():
    for path in PERFBENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "atmonr_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PERFBENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"atmonr_tpu_torch", "atmonr_tpu"}, path


def _run(code: str) -> str:
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)}
    import os

    env.update({k: v for k, v in os.environ.items() if k in ("TMPDIR", "LD_LIBRARY_PATH")})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_loads_no_module_of_the_program_or_of_jax():
    loaded = _run(
        "import sys, perfbench.reference.ngp, perfbench.reference.scene, perfbench.inputs\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'atmonr_tpu', 'atmonr_tpu_torch'}))")
    assert loaded == "[]"


def test_a_whole_run_loads_no_module_of_jax():
    """A tiny extraction run on the CPU, the comparison included: the top
    names ``jax`` and ``atmonr_tpu`` are never loaded, while
    ``atmonr_tpu_torch``, which begins with the latter, is."""
    loaded = _run(
        "import sys\n"
        "sys.path.insert(0, 'perfbench/tests')\n"
        "from _perfbench_tiny import tiny_run\n"
        "from perfbench import harness\n"
        "run, cell = tiny_run('occ13.extract.l1c')\n"
        "assert run.checks\n"
        "assert 'atmonr_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())")
    assert loaded == "[]"


def test_the_check_compares_whole_top_level_names():
    from perfbench import harness

    sys.modules.setdefault("atmonr_tpu_torch_lookalike", sys)
    assert "atmonr_tpu_torch_lookalike" not in harness.forbidden_modules()
    assert not any(m.startswith("atmonr_tpu_torch") for m in harness.forbidden_modules())

"""What the benchmark loads: after a cell's set-up no module of JAX or of
``blf_tpu`` is loaded (top-level names compared whole, so ``blf_tpu_torch``
is not ``blf_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN, HERE, ROOT

from conftest import bench

CELLS = ["push_recovery.fleet98k", "full_gait.sweep16k", "push_recovery.rt4096",
         "push_recovery.ensemble2"]


def roots(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_no_jax_after_a_cells_setup(cell):
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "torch.set_num_threads(1)\n"
        "from portbench.harness import load_cell, driver_class, forbidden_modules\n"
        f"cell = load_cell({cell!r}, {bench()!r})\n"
        "cell.traffic.update(lanes=4, warmup_units=1)\n"
        "cell.traffic['pool'] = 2\n"
        "d = driver_class(cell.config)(cell.config, cell.traffic, 5, torch.device('cpu'))\n"
        "d.warm(); d.begin_window(); d.unit()\n"
        "assert 'blf_tpu_torch' in sys.modules\n"
        "print('found', forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "found []"


def test_forbidden_names_are_compared_whole():
    from portbench.harness import forbidden_modules

    assert "blf_tpu" in FORBIDDEN and "jax" in FORBIDDEN
    assert "blf_tpu_torch" not in forbidden_modules()


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "typing", "numpy", "torch", "portbench"}
    for path in sorted((HERE / "reference").glob("*.py")):
        assert roots(path) <= allowed, (path.name, roots(path) - allowed)
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.reference.fleet_tick, portbench.reference.gait_plan\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'blf_tpu_torch', 'blf_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[]"


def test_only_the_drivers_import_the_program():
    for path in sorted(HERE.rglob("*.py")):
        rel = path.relative_to(HERE)
        if rel.parts[0] in ("paths", "tests"):
            continue
        found = roots(path) & {"blf_tpu_torch", "blf_tpu", "jax", "jaxlib", "flax"}
        assert not found, (str(rel), found)

"""Hygiene of the port: what it imports, and its device rule.

The port imports ``torch``, numpy and the standard library: never ``jax``,
nothing of ``blf_tpu``, and ``triton`` or a CUDA compiler only inside a call.
So every module of it must import on a machine with no GPU toolchain.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import blf_tpu_torch

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "blf_tpu_torch"
FORBIDDEN = ("jax", "blf_tpu", "triton")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PACKAGE)], prefix="blf_tpu_torch."))


def imported_roots(path: Path):
    """Top-level names of every import statement in a source file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_module_imports_without_jax_or_a_gpu_toolchain():
    """A fresh interpreter imports every module of the port and ends with
    none of the forbidden packages loaded and no kernel library built."""
    modules = port_modules()
    assert "blf_tpu_torch.ops.cuda.admm" in modules and len(modules) >= 20
    assert {"blf_tpu_torch.ops.cuda.admm_lane", "blf_tpu_torch.ops.cuda.linalg",
            "blf_tpu_torch.mpc.wholebody", "blf_tpu_torch.models.rigid_body"} <= set(modules)
    assert {"blf_tpu_torch.ops.cuda.rollout", "blf_tpu_torch.models.foot",
            "blf_tpu_torch.models.systems", "blf_tpu_torch.estimators.rls_parallel",
            "blf_tpu_torch.utils.params"} <= set(modules)
    assert {"blf_tpu_torch.planners.contacts", "blf_tpu_torch.planners.convex_hull",
            "blf_tpu_torch.planners.gait", "blf_tpu_torch.native"} <= set(modules)
    assert {"blf_tpu_torch.parallel.mesh", "blf_tpu_torch.parallel.pipeline",
            "blf_tpu_torch.parallel.collectives"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from blf_tpu_torch.ops.cuda import admm, admm_lane, linalg, rollout\n"
        "assert not (admm._libs or admm._l2_libs or admm_lane._libs or linalg._libs\n"
        "            or rollout._libs)\n"
        "from blf_tpu_torch import native\n"
        "assert native._LIB is None and native._REASON is None\n"
        "assert 'scipy' not in sys.modules\n"
        "print('clean', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                    ROOT / "tests/torch_spmd.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_file_imports_the_jax_package(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_a_spawned_rank_imports_no_jax():
    """The module a spawned rank of the multi-device tests imports to find
    its function loads neither JAX nor ``blf_tpu``, nor does any module of
    the port a rank's cases import."""
    code = ("import sys\n"
            "import torch_spmd\n"
            "from blf_tpu_torch.parallel import mesh, pipeline, sweep\n"
            "from blf_tpu_torch.mpc import qp, riccati\n"
            "from blf_tpu_torch.estimators import rls_parallel\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "tests"), str(ROOT)])}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_the_mesh_takes_the_gpu_by_default(monkeypatch):
    """``init_distributed`` and ``make_mesh`` keep the device rule: with no
    device named they start ``nccl`` on the GPU, and raise without one."""
    import torch.distributed as dist

    from blf_tpu_torch.parallel.mesh import _backend, init_distributed, make_mesh

    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_distributed()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert not dist.is_initialized()
    assert _backend(torch.device("cuda")) == "nccl" and _backend(torch.device("cpu")) == "gloo"


def test_port_modules_name_their_counterpart():
    """Each module's docstring says which ``blf_tpu`` file it ports (or that
    it has none), so the next slice can grep for what is left."""
    for path in PACKAGE.rglob("*.py"):
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        assert "blf_tpu" in doc or "ounterpart" in doc, path


def test_device_none_means_the_gpu_and_raises_without_one(monkeypatch):
    from blf_tpu_torch.utils.device import resolve_device, resolve_dtype

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_dtype(None) == torch.float32
    with pytest.raises(TypeError):
        resolve_dtype(torch.int32)


def test_no_fallback_when_a_kernel_cannot_be_served(monkeypatch, tmp_path):
    """The wrapper serves CPU and CUDA tensors and raises on anything else; a
    failed build raises and leaves no library behind."""
    from blf_tpu_torch.ops.cuda import _build, admm

    v = torch.zeros((4, 48), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        admm.admm_stage(v, v, v, v, v, v, v, v, v, iters=1, alpha=1.6)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")   # a compiler that fails
    with pytest.raises(RuntimeError, match="nvcc failed to build admm_stage.cu"):
        _build.load_library(admm.SOURCE, {"ADMM_M": 48, "ADMM_N": 32})
    assert not list(tmp_path.glob("*.so"))
    # the library's name follows the source, the flags and the definitions
    a = _build.library_path(admm.SOURCE, {"ADMM_M": 48, "ADMM_N": 32})
    b = _build.library_path(admm.SOURCE, {"ADMM_M": 96, "ADMM_N": 64})
    assert a != b and a.parent == tmp_path and "m48" in a.name


def test_no_fallback_in_the_per_lane_kernel_wrappers(monkeypatch, tmp_path):
    """The two wrappers of the whole-body path serve CPU and CUDA tensors and
    raise on anything else; a failed build raises and leaves nothing behind;
    neither wrapper catches an exception to give way to its plain version."""
    from blf_tpu_torch.ops.cuda import _build, admm_lane, linalg

    K = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        linalg.cholesky_inverse_lane(K)
    v = torch.zeros((2, 6), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        admm_lane.admm_lane_stage(v, v, K, K, v, v, v, iters=1)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")   # a compiler that fails
    monkeypatch.setattr(admm_lane, "_libs", {})
    monkeypatch.setattr(linalg, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build admm_lane.cu"):
        admm_lane.build_admm_lane(86, 64)
    with pytest.raises(RuntimeError, match="nvcc failed to build chol_lane.cu"):
        linalg.build_chol_lane(64)
    assert not list(tmp_path.glob("*.so")) and not admm_lane._libs and not linalg._libs
    a = _build.library_path(linalg.SOURCE, {"CHOL_N": 64})
    b = _build.library_path(linalg.SOURCE, {"CHOL_N": 29})
    assert a != b and "chol_n64" in a.name
    for module in (admm_lane, linalg):
        tree = ast.parse(Path(module.__file__).read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], module.__name__


def test_kernel_sources_name_what_they_replace():
    """Each CUDA source carries its note: the TPU kernel it replaces, what
    bounds it on the card, what the design does about it; and each wrapper's
    ``REPLACES`` points at a line of the JAX package that opens that kernel."""
    from blf_tpu_torch.ops.cuda import _build, admm, admm_lane, linalg, rollout

    for source_name, replaces, function in (
            (admm.SOURCE, admm.REPLACES, "_stage_kernel_t"),
            (admm.L2_SOURCE, admm.L2_REPLACES, "_stage_kernel_t"),
            (admm_lane.SOURCE, admm_lane.REPLACES, "_lane_kernel"),
            (linalg.SOURCE, linalg.REPLACES, "_inverse_kernel"),
            (linalg.SOLVE_SOURCE, linalg.SOLVE_REPLACES, "_solve_kernel"),
            (rollout.SOURCE, rollout.REPLACES, "_rollout_kernel")):
        source = (PACKAGE / "csrc" / source_name).read_text()
        assert "Replaces the TPU kernel" in source and function in source
        assert "What bounds it on an H100" in source and "Design" in source
        assert "use_fast_math" in source and "cublas" not in source.lower()
        path, line = replaces.split(":")
        assert f"def {function}(" in (ROOT / path).read_text().splitlines()[int(line) - 1]
    # K3 and K4 each carry their own factorization: neither includes a header
    for source_name in (linalg.SOURCE, linalg.SOLVE_SOURCE):
        assert [p.name for p in _build.source_files(source_name)] == [source_name]


def test_library_path_follows_the_headers_a_source_includes(monkeypatch, tmp_path):
    """An edited header builds anew: the library's name hashes every header
    of ``csrc/`` that a source includes, through other headers too."""
    from blf_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    paths = []
    for content in ("int x = 1;", "int x = 2;"):
        (tmp_path / "b.cuh").write_text(content)
        paths.append(_build.library_path("k.cu", {"N": 6}))
    assert paths[0] != paths[1] and paths[0].parent == tmp_path / "build"
    assert _build.library_path("k.cu", {"N": 6}) == paths[1]     # stable otherwise


def test_no_fallback_in_the_solve_kernel_wrapper(monkeypatch, tmp_path):
    """K4's wrapper serves CPU and CUDA tensors and raises on anything else; a
    failed build raises and leaves nothing behind."""
    from blf_tpu_torch.ops.cuda import _build, linalg

    K, b = torch.zeros((2, 6, 6), device="meta"), torch.zeros((2, 6), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        linalg.cholesky_solve_lane(K, b)
    with pytest.raises(ValueError, match="cpu or cuda"):
        linalg.spd_solve_lane(K, b)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")   # a compiler that fails
    monkeypatch.setattr(linalg, "_solve_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build chol_solve.cu"):
        linalg.build_chol_solve(6)
    assert not list(tmp_path.glob("*.so")) and not linalg._solve_libs
    assert "chol_solve_chol_n6" in _build.library_path(linalg.SOLVE_SOURCE, {"CHOL_N": 6}).name


def test_no_fallback_in_the_rollout_kernel_wrapper(monkeypatch, tmp_path):
    """K5's wrapper serves CPU and CUDA tensors and raises on anything else; a
    failed build raises and leaves nothing behind; it catches nothing."""
    from blf_tpu_torch.ops.cuda import _build, rollout
    from blf_tpu_torch.problems import foot_drop_fleet

    fleet = foot_drop_fleet(3, device="cpu")
    meta = type(fleet.state)(*(torch.zeros_like(x, device="meta") for x in fleet.state))
    with pytest.raises(ValueError, match="cpu or cuda"):
        rollout.foot_rollout_fused(fleet.cparams, fleet.fparams, meta, fleet.null_position,
                                   fleet.null_rotation, dt=fleet.dt, steps=2)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "false")   # a compiler that fails
    monkeypatch.setattr(rollout, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc failed to build foot_rollout.cu"):
        rollout.build_foot_rollout()
    assert not list(tmp_path.glob("*.so")) and not rollout._libs
    tree = ast.parse(Path(rollout.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_the_config2_problems_take_the_gpu_by_default(monkeypatch):
    from blf_tpu_torch.problems import contact_identification_fleet, foot_drop_fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (foot_drop_fleet, contact_identification_fleet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(2)


def test_the_stack_problem_takes_the_gpu_by_default(monkeypatch):
    from blf_tpu_torch.convert import stack_state_from_numpy
    from blf_tpu_torch.problems import push_recovery_stack

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        push_recovery_stack(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stack_state_from_numpy(push_recovery_stack(2, device="cpu").state)


def test_f32_matmuls_turns_tf32_off_for_the_call():
    from blf_tpu_torch.ops.precision import f32_matmuls

    seen = []
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f32_matmuls(lambda: seen.append(torch.backends.cuda.matmul.allow_tf32))()
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True     # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_telemetry_is_one_transfer_of_named_channels():
    import io
    import json

    from blf_tpu_torch.utils.telemetry import TelemetryStream, merge_metrics

    metrics = {"a": torch.tensor(1.5), "b": torch.arange(6.0).reshape(2, 3), "c": 2}
    merged, layout = merge_metrics(metrics)
    assert tuple(merged.shape) == (8,) and layout == [("a", ()), ("b", (2, 3)), ("c", ())]
    sink = io.StringIO()
    rec = TelemetryStream(sink=sink, name="t").publish(metrics, step=3)
    assert rec["a"] == 1.5 and rec["b"] == [[0, 1, 2], [3, 4, 5]] and rec["c"] == 2.0
    assert json.loads(sink.getvalue())["step"] == 3


def test_chip_smoke_refuses_to_run_without_a_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}       # hide any card there is
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs a CUDA device" in proc.stderr

"""The port stands alone: no module of ``pagnerf_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, the JAX package or ``__graft_entry__``,
nor a package the card's machine lacks (cv2, PIL, imageio, sklearn,
tensorboard, yaml, msgpack, flax); its kernel builds by nvcc + ctypes alone; its entry points
refuse to run on a host without a CUDA card unless asked for the CPU."""
import ast
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pagnerf_tpu", "__graft_entry__")
# not installed on the card's machine
MISSING_ON_CARD = ("cv2", "PIL", "imageio", "sklearn", "tensorboard", "tensorboardX",
                   "yaml", "msgpack", "flax")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(ROOT, "pagnerf_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]     # build products
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("pagnerf_tpu_torch", "ops", "table_gather.py") in names
    assert len(names) >= 20


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_imports_missing_on_the_card(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in MISSING_ON_CARD]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_build_uses_nvcc_and_ctypes_only():
    for path in _port_sources():
        bad = [m for m in _imported_modules(path)
               if "cpp_extension" in m or m.split(".")[0] == "pybind11"]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    csrc = os.path.join(ROOT, "pagnerf_tpu_torch", "ops", "csrc")
    names = sorted(n for n in os.listdir(csrc) if n.endswith(".cu"))
    assert {"permuto_encode.cu", "permuto_encode_bwd.cu", "permuto_gather.cu",
            "permuto_scatter.cu", "lap_assign.cu"} <= set(names)
    for name in names:
        with open(os.path.join(csrc, name)) as f:
            includes = [ln for ln in f if ln.startswith("#include")]
        assert includes and not [i for i in includes
                                 if "torch" in i or "pybind" in i or "ATen" in i]


def test_build_flags_and_library_name():
    from pagnerf_tpu_torch.ops import _build
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("permuto_gather")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libpermuto_gather_")
    assert path == _build.library_path("permuto_gather")    # content-addressed


def test_build_without_nvcc_raises_and_leaves_nothing(monkeypatch, tmp_path):
    from pagnerf_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("permuto_gather")
    assert not (tmp_path / "_build").exists()


def test_build_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = f.read().split()
    assert "pagnerf_tpu_torch/_build/" in lines


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from pagnerf_tpu_torch import cli, device, entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.flagship(tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_flagship(tiny=True, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.train_flagship_schedule(tiny=True, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.validate_flagship(tiny=True, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", os.path.join(ROOT, "configs", "synthetic", "tiny.yaml")])
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(monkeypatch):
    import runpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(os.path.join(ROOT, "chip_smoke.py"), run_name="__main__")
    assert exc.value.code not in (0, None)


def test_sixteenth_slice_sources_covered():
    """The data-parallel modules and the C++ sampler's binding are port
    sources (so the import checks above cover them); the sampler's C++
    source includes no PyTorch, pybind11 or JAX header."""
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in (("parallel", "sharding.py"), ("parallel", "launch.py"),
                ("data", "native.py")):
        assert os.path.join("pagnerf_tpu_torch", *rel) in names
    with open(os.path.join(ROOT, "pagnerf_tpu_torch", "data", "csrc", "batcher.cpp")) as f:
        includes = [ln for ln in f if ln.startswith("#include")]
    assert includes and not [i for i in includes
                             if "torch" in i or "pybind" in i or "ATen" in i or "jax" in i]


def test_data_parallel_entry_refuses_cpu_fallback(monkeypatch):
    from pagnerf_tpu_torch import entry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.data_parallel_run(None, {"device": "cuda", "actions": []})

"""Rules of the port that hold for every module of audiogan_tpu_torch:
no JAX anywhere, no silent CPU fallback, no caught kernel launch, and
build output kept out of git."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "audiogan_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "audiogan_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_without_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.device import resolve_device
    from audiogan_tpu_torch.train.sample import build_sample_fn, generate
    cfg = get_preset("tiny_sc09")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sample_fn(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(cfg, {}, num=1, seed=0)
    from audiogan_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["sample", "--init-seed", "0", "--out_dir", "unused"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["serve", "--artifact", "unused"])


def test_kernel_wrapper_catches_nothing():
    """A failed launch raises to the caller: no try/except in the kernel
    module, so no path falls back to the plain form on the card."""
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        tries = [n for n in ast.walk(tree)
                 if isinstance(n, ast.Try) and n.handlers]
        assert not tries, f"{path.name}: except at line {tries[0].lineno}"


def test_build_output_is_ignored():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "build/" in lines
    assert "chiprun_out/" in lines

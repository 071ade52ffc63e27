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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["bench", "--preset", "tiny_sc09"])


def test_gru_entry_points_raise_without_a_card(tmp_path):
    """cond_gru_sc09's entry points resolve the card and raise without
    one; its kernel wrappers run the plain form only for a CPU tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from audiogan_tpu_torch.cli import main
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.serve import load_sampler
    from audiogan_tpu_torch.train.sample import build_sample_fn
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    cfg = get_preset("cond_gru_sc09")
    for call in (lambda: build_sample_fn(cfg),
                 lambda: build_train_step(cfg),
                 lambda: create_train_state(cfg),
                 lambda: load_sampler(tmp_path),
                 lambda: main(["sample", "--preset", "cond_gru_sc09",
                               "--init-seed", "0", "--out_dir", "unused"]),
                 lambda: main(["train", "--preset", "cond_gru_sc09",
                               "--steps", "1", "--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    args = [torch.zeros(s, device="meta") for s in (
        (2, 8), (2, 4), (8, 24), (8, 24), (24,), (24,), (4, 4), (8, 4),
        (4,))]
    with pytest.raises(ValueError, match="no gru_scan kernel"):
        kgru.gru_scan_fwd(*args, 3)
    with pytest.raises(ValueError, match="no gru_scan_bwd kernel"):
        kgru.gru_scan_bwd(torch.zeros(2, 3, 4, device="meta"), *args,
                          torch.zeros(2, 3, 4, device="meta"),
                          torch.zeros(3, 2, 8, device="meta"))


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


def test_training_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from audiogan_tpu_torch.cli import main
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.train.loop import train
    from audiogan_tpu_torch.train.state import create_train_state
    from audiogan_tpu_torch.train.step import build_train_step
    cfg = get_preset("tiny_sc09")
    for call in (lambda: build_train_step(cfg),
                 lambda: create_train_state(cfg),
                 lambda: train(cfg, tmp_path, 1),
                 lambda: main(["train", "--steps", "1",
                               "--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "config.json").exists()


def _graph_names(t):
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


def test_gru_generator_output_carries_the_scan_history():
    """The GRU G's scan and upsampling go through autograd Functions, so
    its output has their grad_fns and every weight gets a gradient."""
    from audiogan_tpu_torch.config import Config, DataCfg, ModelCfg
    from audiogan_tpu_torch.models import build_generator
    from audiogan_tpu_torch.models.init import init_params
    cfg = Config(data=DataCfg(clip_len=256, store_len=256, num_classes=3),
                 model=ModelCfg(generator="gru", model_dim=4, kernel_size=9,
                                gru_frame_size=64, gru_hidden=8)).validate()
    g = init_params(build_generator(cfg, device="cpu"), 0)
    y = g(torch.randn(2, cfg.model.latent_dim), torch.tensor([0, 2]))
    names = _graph_names(y)
    assert "GruScanBackward" in names and "ConvTBABackward" in names
    y.square().sum().backward()
    for name, p in g.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_generator_and_critic_outputs_carry_autograd_history():
    """G's and D's convs go through the autograd Functions on every
    device, so their outputs have a grad_fn and their weights gradients
    (the plain form alone would differentiate on the CPU only)."""
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.models import (build_discriminator,
                                           build_generator)
    from audiogan_tpu_torch.models.init import init_params
    cfg = get_preset("tiny_sc09")
    g = init_params(build_generator(cfg, device="cpu"), 0)
    d = init_params(build_discriminator(cfg, device="cpu"), 1)
    y = g(torch.randn(2, cfg.model.latent_dim))
    assert y.grad_fn is not None
    assert "ConvTBABackward" in _graph_names(y)
    s = d(y, None, torch.zeros(len(cfg.model.strides) - 1, 2,
                               dtype=torch.long))
    assert "Conv1dBABackward" in _graph_names(s)
    assert "PShufBackward" in _graph_names(s)
    s.sum().backward()
    assert g.convt_0_kernel.grad is not None
    assert g.convt_0_kernel.grad.abs().sum() > 0
    assert d.conv_0_kernel.grad.abs().sum() > 0


def test_fused_site_and_cell_wrappers_take_no_plain_path_off_the_cpu():
    """K6, K7 and K3's wrappers run the plain form only for a CPU tensor:
    any other device launches the kernel or raises."""
    from audiogan_tpu_torch.kernels import gru as kgru
    from audiogan_tpu_torch.kernels import sconv as ksconv

    def meta(*s, dtype=torch.float32):
        return torch.zeros(s, device="meta", dtype=dtype)
    offs = meta(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no sconv1d kernel"):
        ksconv.sconv1d_ba(meta(3, 20, 4), meta(5, 4, 6), meta(6), offs, 2,
                          2, 2, 2)
    with pytest.raises(ValueError, match="no sconvt1d kernel"):
        ksconv.sconvt1d(meta(3, 8, 6), meta(5, 6, 4), offs, 2, 2, 16, 2)
    with pytest.raises(ValueError, match="no gru_cell kernel"):
        kgru.gru_cell_fwd(meta(2, 4), meta(2, 8), meta(4, 24), meta(8, 24),
                          meta(24), meta(24))


def test_fused_critic_output_carries_the_fused_history(tmp_path):
    """With every site fused the critic's graph runs through the masked
    reflect pad and the shuffled-input conv Function, never PShuf; the
    fused configuration's training entry point still needs a card."""
    from audiogan_tpu_torch.cli import apply_overrides, main
    from audiogan_tpu_torch.config import get_preset
    from audiogan_tpu_torch.models import build_discriminator
    from audiogan_tpu_torch.models.init import init_params
    cfg = apply_overrides(get_preset("tiny_sc09"),
                          ["model.fused_shuffle_sites=-1"])
    d = init_params(build_discriminator(cfg, device="cpu"), 1)
    x = torch.rand(2, cfg.data.clip_len, 1).requires_grad_(True)
    s = d(x, None, torch.ones(len(cfg.model.strides) - 1, 2,
                              dtype=torch.long))
    names = _graph_names(s)
    assert {"SConv1dBABackward", "MRPadBackward"} <= names
    assert "PShufBackward" not in names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["train", "--set", "model.fused_shuffle_sites=-1",
                  "--steps", "1", "--workdir", str(tmp_path)])

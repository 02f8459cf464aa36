"""The port stands alone: importing it (or the chip smoke script) pulls in
neither JAX nor the JAX reference package, and the smoke script refuses to
run without a CUDA device."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT = os.path.join(SRC, "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, SRC)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    return mods


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_statement(path):
    """No import statement of the port or the smoke script names jax or the
    reference package ``repro``."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys, runpy\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({SMOKE!r}, run_name='chip_smoke')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the smoke script exits non-zero and prints no result
    line — from the repository and from a directory holding only itself."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(SMOKE).read())
    for script in (SMOKE, str(lone)):
        proc = subprocess.run([sys.executable, script],
                              cwd=os.path.dirname(script),
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.data.pipeline", "repro_torch.kernels.flash_attention",
    "repro_torch.parallel.pipeline", "repro_torch.train.optimizer",
    "repro_torch.train.train_state", "repro_torch.train.loop",
    "repro_torch.launch.train"])
def test_training_slice_modules_are_covered(module):
    """The training slice's modules are among those the import checks
    above walk (no jax / repro import, importable without a card)."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "repro_torch.train.checkpoint", "repro_torch.train.fault",
    "repro_torch.train.chaos", "repro_torch.train.elastic",
    "repro_torch.core.policy"])
def test_checkpoint_slice_modules_are_covered(module):
    """The checkpoint and fault-handling slice's modules are among those
    the import checks above walk."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.ops"])
def test_ssm_slice_modules_are_covered(module):
    """The SSM slice's modules are among those the import checks above
    walk (no jax / repro import, importable without a card)."""
    assert module in _modules()


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.gemm_os", "repro_torch.models.transformer",
    "repro_torch.serve.cache_manager", "repro_torch.serve.engine",
    "repro_torch.launch.serve"])
def test_gemm_and_hybrid_slice_modules_are_covered(module):
    """The modules of the GEMM and hybrid serving slice are among those the
    import checks above walk (no jax / repro import, importable without a
    card)."""
    assert module in _modules()

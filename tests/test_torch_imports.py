"""The port stands alone: no module of simple_pbft_tpu_torch, and nothing
chip_smoke.py imports, reaches `jax` or the JAX package.

The test process itself has jax loaded (conftest), so the imports run in
a fresh interpreter with both packages blocked in sys.modules.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "simple_pbft_tpu_torch"
BLOCKED = ("jax", "simple_pbft_tpu")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_port_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules() + ["chip_smoke"]
    assert "simple_pbft_tpu_torch.crypto.gpu_verifier" in mods
    code = (
        "import importlib, sys\n"
        "for name in %r:\n"
        "    sys.modules[name] = None\n"
        "for mod in %r:\n"
        "    importlib.import_module(mod)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in %r"
        " and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n"
        "print('imported', len(%r))\n"
    ) % (BLOCKED, mods, BLOCKED, mods)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"imported {len(mods)}" in proc.stdout


def test_no_port_source_names_jax_or_the_jax_package():
    """Every import statement, also those inside functions."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, (path, name)


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """Without the package beside it (and here without a card) the smoke
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env=env,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

"""The port imports torch and never jax, and nothing of lexicmap_tpu; the
same holds for chip_smoke.py."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lexicmap_tpu_torch")


def port_sources():
    out = []
    for d, _, names in os.walk(PKG):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def port_modules():
    mods = []
    for p in port_sources()[:-1]:
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return mods


def test_imports_with_jax_and_reference_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['lexicmap_tpu'] = None\n"
        f"for m in {port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.startswith('jax') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "lexicmap_tpu"), (path, n)


@pytest.mark.parametrize("mod", ["lexicmap_tpu_torch.entry", "lexicmap_tpu_torch.parallel.sharded",
                                 "lexicmap_tpu_torch.parallel.multiproc",
                                 "lexicmap_tpu_torch.kernels.seed_match_shard",
                                 "lexicmap_tpu_torch.kernels.shard_compact"])
def test_sharded_modules_are_checked(mod):
    """The sharded slice's modules are among those the checks above import
    with jax blocked and parse for imports."""
    assert mod in port_modules()

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


@pytest.mark.parametrize("mod", ["lexicmap_tpu_torch.cli_utils",
                                 "lexicmap_tpu_torch.index.convert",
                                 "lexicmap_tpu_torch.index.refformat"])
def test_utils_modules_are_checked(mod):
    """The utils slice's modules (the `utils` subcommands and the .lmi
    conversion, the port's own copies) are among those the checks above
    import with jax blocked and parse for imports."""
    assert mod in port_modules()


def kernel_sources():
    d = os.path.join(PKG, "kernels")
    return sorted(os.path.join(d, n) for n in os.listdir(d) if n.endswith(".py"))


@pytest.mark.parametrize("path", kernel_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_kernels_import_nothing_above_them(path):
    """The kernel modules sit below parallel/: none imports it, and none
    takes a `_`-prefixed name from another kernel module (what they share
    is public, most of it in kernels/runtime.py)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [(a.name, []) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "lexicmap_tpu_torch.kernels" if node.level == 1 else (
                "lexicmap_tpu_torch" if node.level == 2 else "")
            mods = [(".".join(p for p in (base, node.module or "") if p),
                     [a.name for a in node.names])]
        else:
            continue
        for mod, names in mods:
            assert not mod.startswith("lexicmap_tpu_torch.parallel"), (path, mod)
            if mod == "lexicmap_tpu_torch" and "parallel" in names:
                raise AssertionError((path, "from .. import parallel"))
            if mod.startswith("lexicmap_tpu_torch.kernels"):
                assert not [n for n in names if n.startswith("_")], (path, mod, names)
